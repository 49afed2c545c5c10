"""Polyphonic AMT posteriors: the Basic Pitch CNN and the harmonic salience.

Counterpart of audiotabs_tpu/models/basicpitch.py (``hcqt``, ``cnn_apply``,
``salience_posteriors``, ``load_params``, the host note decoder
``notes_from_posteriors`` and ``chroma_from_note_events``, numpy, arithmetic
unchanged, and ``transcribe_polyphonic``, the whole path from audio with the
posteriors on the device). The CNN is an
nn.Module of Conv2d layers in NCHW with the JAX "SAME" padding written out.
The salience's block-max envelope (``salience_envelope``, two lax.scans in
JAX) is one launch of the CUDA kernel csrc/salience_envelope.cu for a batch
of rows on the card, and a plain loop over blocks on the CPU
(``salience_envelope_plain``). ``salience_posteriors`` is
``salience_from_hcqt`` (per song) then ``posteriors_from_salience`` (per
song or for a batch of songs of one length, one envelope launch).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import _build
from ..device import on_device
from ..ops.cqt import hybrid_cqt
from ..theory.events import NoteEvent
from ..tracing import count
from . import convert
from .params_io import load_pytree_npz, weights_path

FMIN = 27.5  # A0
BINS_PER_SEMITONE = 3
N_SEMITONES = 88
N_BINS = N_SEMITONES * BINS_PER_SEMITONE  # 264
HOP = 256
HARMONICS = (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)
MIDI_A0 = 21
# the salience normaliser: blocks of 64 frames (about 0.75 s at 86 fps), a
# decay of 0.6 per block (-20 dB in about 3.4 s), a floor at 5 % of the peak
ENVELOPE_STRIDE = 64
ENVELOPE_DECAY = 0.6
ENVELOPE_FLOOR = 0.05


def hcqt(y: torch.Tensor, sr: int) -> torch.Tensor:
    """Harmonic CQT [H, n_bins, T] at 3 bins/semitone from A0."""
    return hybrid_cqt(y, sr, hop=HOP, fmin=FMIN, n_bins=N_BINS, bins_per_octave=12 * BINS_PER_SEMITONE, harmonics=HARMONICS)


def same_pad(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int]) -> torch.Tensor:
    """Pad [N, C, H, W] as XLA's "SAME": out = ceil(in/stride), the odd pixel at the end."""
    pads = []
    for size, k, s in zip(x.shape[-2:], kernel, stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (ht, hb), (wl, wr) = pads
    return F.pad(x, (wl, wr, ht, hb))


class SameConv2d(nn.Conv2d):
    """Conv2d with XLA "SAME" padding (asymmetric when the kernel is even or strided)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, self.kernel_size, self.stride))


class BasicPitchCNN(nn.Module):
    """hCQT [H, n_bins, T] → (onset [T, 88], frame [T, 88], contour [T, 264])."""

    def __init__(self, n_harmonics: int = len(HARMONICS)):
        super().__init__()
        s = (BINS_PER_SEMITONE, 1)
        self.c1 = SameConv2d(n_harmonics, 16, (5, 5))
        self.c2 = SameConv2d(16, 8, (39, 3))
        self.c3 = SameConv2d(8, 1, (5, 5))
        self.n1 = SameConv2d(1, 32, (7, 7), stride=s)
        self.n2 = SameConv2d(32, 1, (7, 3))
        self.o1 = SameConv2d(n_harmonics, 32, (5, 5), stride=s)
        self.o2 = SameConv2d(33, 1, (3, 3))

    @classmethod
    def from_params(cls, params: dict) -> "BasicPitchCNN":
        net = cls(np.asarray(params["c1_w"]).shape[2])
        net.load_state_dict(_conv_state(params))
        return net

    def forward(self, hc: torch.Tensor):
        """hc [H, n_bins, T] → (onset [T, 88], frame [T, 88], contour [T, 264]),
        or a batch [N, H, n_bins, T] → each with a leading N (every clip
        normalised by its own statistics)."""
        single = hc.dim() == 3
        x = torch.log1p(10.0 * (hc[None] if single else hc))  # [N, H, freq, time]
        # parity trap: jnp.std is the population std, so correction=0
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (x.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-5)
        c = F.relu(self.c1(x))
        c = F.relu(self.c2(c))
        contour = torch.sigmoid(self.c3(c))  # [N, 1, 264, T]
        note = torch.sigmoid(self.n2(F.relu(self.n1(contour))))  # [N, 1, 88, T]
        o = torch.cat([F.relu(self.o1(x)), note], dim=1)
        onset = torch.sigmoid(self.o2(o))
        outs = tuple(t[:, 0].transpose(1, 2) for t in (onset, note, contour))
        return tuple(t[0] for t in outs) if single else outs


def cnn_apply(net: BasicPitchCNN, hc: torch.Tensor):
    """hc [H, n_bins, T] → (onset [T, 88], frame [T, 88], contour [T, 264])."""
    return net(hc)


CONV_NAMES = ("c1", "c2", "c3", "n1", "n2", "o1", "o2")


def init_params(generator: torch.Generator) -> dict:
    """Random init of the JAX pytree (numpy, HWIO convs), as the JAX
    ``init_params``: N(0, 1/fan_in) with fan-in kh * kw * c_in, zero biases."""
    shapes = {"c1": (5, 5, len(HARMONICS), 16), "c2": (39, 3, 16, 8), "c3": (5, 5, 8, 1), "n1": (7, 7, 1, 32),
              "n2": (7, 3, 32, 1), "o1": (5, 5, len(HARMONICS), 32), "o2": (3, 3, 33, 1)}
    params = {}
    for name, shape in shapes.items():
        params[f"{name}_w"] = (torch.randn(shape, generator=generator) / np.sqrt(np.prod(shape[:3]))).numpy()
        params[f"{name}_b"] = np.zeros((shape[-1],), np.float32)
    return params


def _conv_state(params: dict) -> dict:
    return convert.conv_state(params, CONV_NAMES)


def params_of(net: BasicPitchCNN, template: dict) -> dict:
    return convert.to_pytree(_conv_state, template, net.state_dict())


def load_params(path: str | None = None) -> dict | None:
    path = weights_path("BASICPITCH_WEIGHTS", "basicpitch.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    return load_pytree_npz(path)


def salience_envelope_plain(sal: torch.Tensor, stride: int = ENVELOPE_STRIDE, decay: float = ENVELOPE_DECAY):
    """The plain version: salience [88, T] or [R, 88, T] → norm [nblk] or
    [R, nblk], nblk = ceil(T / stride): the block maxima (the last block
    padded with zeros), the larger of a forward and a reverse decaying max
    over them, floored at 5 % of the salience's peak."""
    T = sal.shape[-1]
    nblk = max(1, -(-T // stride))
    m = F.pad(sal, (0, nblk * stride - T)).reshape(*sal.shape[:-1], nblk, stride).amax(dim=(-3, -1))  # [..., nblk]
    fwd, bwd = [], []
    e = torch.zeros(m.shape[:-1], device=sal.device)
    for i in range(nblk):
        e = torch.maximum(m[..., i], decay * e)
        fwd.append(e)
    e = torch.zeros(m.shape[:-1], device=sal.device)
    for i in reversed(range(nblk)):
        e = torch.maximum(m[..., i], decay * e)
        bwd.append(e)
    env = torch.maximum(torch.stack(fwd, dim=-1), torch.stack(bwd[::-1], dim=-1))
    return torch.maximum(env, ENVELOPE_FLOOR * sal.amax(dim=(-2, -1))[..., None])


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]

# The kernel's per-row block counters, one zeroed int32 row for each (device,
# stream): each launch leaves its counters at 0 again, so launches in order on
# one stream share a row, and launches on two streams never do.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _launch_args(sal: torch.Tensor, stride: int, decay: float) -> tuple:
    """The kernel's arguments for float32 salience [R, 88, T] on the card: the
    contiguous input, the scratch of its 32-frame segment maxima [R, ceil(T /
    32)], the output [R, nblk]."""
    if sal.dtype != torch.float32:
        raise TypeError(f"the salience envelope kernel takes float32 salience, got {sal.dtype}")
    R, T = sal.shape[0], sal.shape[-1]
    return (sal.contiguous(), torch.empty((R, -(-T // 32)), dtype=torch.float32, device=sal.device),
            torch.empty((R, max(1, -(-T // stride))), dtype=torch.float32, device=sal.device), stride, decay)


def _tickets(device: torch.device, stream: int, R: int) -> torch.Tensor:
    """The block counters for ``R`` rows on ``stream``, zeros (made once for each stream)."""
    key = (device.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None or ticket.numel() < R:
        ticket = _TICKETS[key] = torch.zeros(max(R, 64), dtype=torch.int32, device=device)
    return ticket


def _salience_envelope_cuda(sal: torch.Tensor, stride: int, decay: float) -> torch.Tensor:
    """[R, 88, T] on the card: one launch, a warp per 32-frame segment of every row."""
    sal, seg, norm, stride, decay = _launch_args(sal, stride, decay)
    R, rows, T = sal.shape
    ticket = _tickets(sal.device, torch.cuda.current_stream(sal.device).cuda_stream, R)
    _build.launch("salience_envelope", "salience_envelope_f32", _ARGTYPES, sal.device, sal, seg, ticket, norm, R, rows, T, stride,
                  decay, ENVELOPE_FLOOR, refused={-1: f"{R} rows of {rows} x {T} (at most 65,535 rows)",
                                                  -2: f"a stride of {stride} frames (the kernel takes {ENVELOPE_STRIDE})"})
    return norm


def salience_envelope(sal: torch.Tensor, stride: int = ENVELOPE_STRIDE, decay: float = ENVELOPE_DECAY) -> torch.Tensor:
    """The salience normaliser of [88, T] or [R, 88, T] → [nblk] or [R, nblk]
    (see ``salience_envelope_plain``). A CUDA tensor launches
    csrc/salience_envelope.cu, a CPU tensor takes the plain loop; any other
    device raises."""
    if sal.ndim not in (2, 3):
        raise ValueError(f"salience_envelope takes [88, T] or [R, 88, T], got shape {tuple(sal.shape)}")
    rows = sal[None] if sal.ndim == 2 else sal
    norm = _build.plain_or_kernel("salience_envelope", salience_envelope_plain, _salience_envelope_cuda, rows, stride, decay)
    return norm[0] if sal.ndim == 2 else norm


def salience_from_hcqt(hc: torch.Tensor) -> torch.Tensor:
    """The fundamental-gated harmonic salience [88, T] of an hCQT [H, 264, T]
    (rows follow HARMONICS: 0.5, 1, 2, ..7), before its envelope."""
    peak = hc[1].max()
    A = hc / (peak + 1e-8)
    fundamental = A[1]
    boost = 1.0 + sum(0.9 ** (i - 1) * A[i] for i in range(2, len(HARMONICS)))
    sub_penalty = 1.0 - 0.5 * torch.clamp(A[0] - fundamental, 0.0, 1.0)
    sal = fundamental * boost * sub_penalty  # [264, T]
    sal = torch.where(peak > 1e-4, sal, torch.zeros_like(sal))
    return sal.reshape(N_SEMITONES, BINS_PER_SEMITONE, -1).max(dim=1).values  # [88, T]


def posteriors_from_salience(sal: torch.Tensor):
    """Salience [88, T], or a batch [R, 88, T] of rows of one length →
    (onset, frame) posteriors [T, 88] or [R, T, 88]: the salience over its
    ``salience_envelope`` (one launch for the whole batch on the card), every
    operation within its row."""
    T = sal.shape[-1]
    norm = salience_envelope(sal)
    norm_t = norm.repeat_interleave(ENVELOPE_STRIDE, dim=-1)[..., :T]
    frame_post = torch.clamp(sal / (norm_t[..., None, :] + 1e-2), 0.0, 1.0)

    diff = frame_post[..., 1:] - frame_post[..., :-1]
    onset_post = torch.clamp(torch.cat([frame_post[..., :1], torch.clamp(diff, min=0.0)], dim=-1) * 2.0, 0.0, 1.0)
    return onset_post.transpose(-1, -2), frame_post.transpose(-1, -2)


def salience_posteriors(y: torch.Tensor, sr: int):
    """Fundamental-gated harmonic salience → (onset [T, 88], frame [T, 88]).

    The frame posteriors are normalised by ``salience_envelope``, a
    bidirectional block-max envelope over ~0.75 s blocks."""
    return posteriors_from_salience(salience_from_hcqt(hcqt(y, sr)))


def notes_from_posteriors(
    onset: np.ndarray,
    frame: np.ndarray,
    *,
    fps: float,
    onset_threshold: float = 0.5,
    frame_threshold: float = 0.3,
    min_note_ms: float = 127.70,
    melodia_trick: bool = True,
    gap_tolerance_frames: int = 3,
) -> list[NoteEvent]:
    """Posteriors [T, 88] → note events (Basic Pitch decoding semantics).

    A note runs from its first frame while the frame posterior stays at or
    above ``frame_threshold``, through gaps of up to ``gap_tolerance_frames``
    off frames; it ends one past its last on frame. Notes start at the
    onset peaks (row-major order), then, with ``melodia_trick``, at the
    loudest frame left (``np.argmax``'s order: NaN first, then by value, the
    first of equals), walking back to its start under the same rule; each
    frame of an accepted note is cleared. An event then loses to one a
    semitone away that covers most of it and is clearly louder.

    The walks are searches in a byte row per pitch that mirrors
    ``remaining >= frame_threshold`` (numpy 2's promotion: the array
    comparison is the scalar one); the seeds are one ordering of the frames
    at or above the threshold, visited once, skipping the cleared; the
    leakage rule compares each pitch with its two neighbours only. Counts
    ``note_events`` (events before the leakage rule) and ``note_seeds``.
    """
    onset = np.asarray(onset)
    frame = np.asarray(frame)
    T, P = frame.shape
    min_frames = max(1, int(round(min_note_ms / 1000.0 * fps)))
    remaining = frame.copy()

    # local onset peaks per pitch
    peaks = (
        (onset >= onset_threshold)
        & (onset >= np.roll(onset, 1, axis=0))
        & (onset >= np.roll(onset, -1, axis=0))
    )
    peaks[0] = onset[0] >= onset_threshold
    peaks[-1] &= False

    # byte p * T + t is 1 where remaining[t, p] is on
    on = bytearray(P * T)
    on_rows = np.frombuffer(on, np.uint8).reshape(P, T)
    on_rows[...] = (remaining >= frame_threshold).T
    cleared = int(remaining.dtype.type(0) >= frame_threshold)
    off_run = b"\x00" * (max(gap_tolerance_frames, 0) + 1)  # the gap that ends a note

    def end_of(t0: int, p: int) -> int:
        """The exclusive end of the note from frame t0: where the first off run
        starts, or, where the song ends first, one past the last on frame (t0 if none)."""
        row = p * T
        t = on.find(off_run, row + t0, row + T)
        if t < 0:
            t = on.rfind(b"\x01", row + t0, row + T)
            return t0 if t < 0 else t + 1 - row
        return t - row

    def start_of(t0: int, p: int) -> int:
        """The first frame of the note whose frame t0 is on: one past the last
        off run before t0, or the first on frame of the song (t0 if none)."""
        row = p * T
        t = on.rfind(off_run, row, row + t0)
        if t < 0:
            t = on.find(b"\x01", row, row + t0)
            return t0 if t < 0 else t - row
        return t + len(off_run) - row

    notes: list[tuple[int, int, int]] = []  # (first frame, end frame, pitch)
    ts, ps = np.nonzero(peaks)
    for t0, p in zip(ts.tolist(), ps.tolist()):
        if remaining[t0, p] < frame_threshold and onset[t0, p] < onset_threshold:
            continue
        t1 = end_of(t0, p)
        if t1 - t0 >= min_frames:
            notes.append((t0, t1, p))
            remaining[t0:t1, p] = 0.0
            on_rows[p, t0:t1] = cleared

    if melodia_trick:
        # recover onset-less notes from leftover frame energy, loudest first.
        # From here ``remaining`` is read only through ``on``, so it is the
        # seeds' mask: a frame is taken as a seed or cleared with a seed's note.
        if not frame_threshold > 0:
            raise ValueError("the melodia pass needs frame_threshold > 0: a cleared frame would seed again")
        flat = remaining.reshape(-1)
        seeds = np.flatnonzero(flat >= frame_threshold)
        # by value, loudest first, then by index: one sort of (value's rank, index)
        louder = np.unique(-flat[seeds], return_inverse=True)[1]
        seeds = np.sort(louder * flat.size + seeds) % flat.size
        seeds = np.concatenate([np.flatnonzero(np.isnan(flat)), seeds])
        k, taken = 0, 0
        while True:
            step = 32  # skip the cleared seeds a block at a time
            while k < len(seeds):
                left = np.flatnonzero(flat[seeds[k : k + step]])
                if left.size:
                    k += int(left[0])
                    break
                k += step
                step *= 2
            if k >= len(seeds):
                break
            t0, p = divmod(int(seeds[k]), P)
            taken += 1
            s = start_of(t0, p)
            t1 = end_of(t0, p)
            remaining[s : max(t1, t0 + 1), p] = 0.0  # always clear the seed frame
            if t1 - s >= min_frames:
                notes.append((s, t1, p))
                on_rows[p, s:t1] = cleared
        count("note_seeds", taken)
    count("note_events", len(notes))

    if not notes:
        return []
    first, last, pitch = np.array(notes, dtype=np.int64).T
    start, end = first / fps, last / fps  # np.float64, as frame / fps
    # each mean over the note's frames of ``frame`` as it came, then clipped
    amp = np.clip(np.array([np.mean(frame[t0:t1, p]) for t0, t1, p in notes]), 0.0, 1.0).astype(np.float64)
    velocity = np.clip(40 + 87 * amp, 1, 127)
    events = [
        NoteEvent(start_time_s=t0, end_time_s=t1, pitch_midi=MIDI_A0 + p, velocity=int(v), amplitude=a)
        for t0, t1, p, v, a in zip(start, end, pitch.tolist(), velocity.tolist(), amp.tolist())
    ]

    # suppress spectral-leakage neighbors: an event loses to a co-occurring
    # event one semitone away with clearly higher amplitude. Python's min(x, y)
    # is y only where y < x, and max(x, y) y only where y > x.
    lost = np.zeros(len(events), dtype=bool)
    for q in np.unique(pitch):
        a = np.flatnonzero(pitch == q)
        b = np.flatnonzero(np.abs(pitch - q) == 1)
        if not b.size:
            continue
        ea, sa, eb, sb = end[a, None], start[a, None], end[b], start[b]
        ov = np.where(eb < ea, eb, ea) - np.where(sb > sa, sb, sa)
        lost[a] = ((ov > 0.8 * (ea - sa)) & (amp[b] > 1.4 * amp[a, None])).any(axis=1)
    events = [e for e, out in zip(events, lost) if not out]

    return sorted(events, key=lambda e: e.start_time_s)


def transcribe_polyphonic(
    y,
    sr: int,
    *,
    onset_threshold: float = 0.5,
    frame_threshold: float = 0.3,
    min_note_ms: float = 127.70,
    melodia_trick: bool = True,
    params: dict | None = None,
    device=None,
) -> list[NoteEvent]:
    """Full polyphonic transcription (the CNN if weights load, else the
    salience) of the whole signal in float32: posteriors on the device,
    notes on the host."""
    p = params if params is not None else load_params()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yd = on_device(y, device)
        if p is not None:
            net = BasicPitchCNN.from_params(p).to(yd.device).eval()
            onset, frame_post, _ = cnn_apply(net, hcqt(yd, sr))
        else:
            onset, frame_post = salience_posteriors(yd, sr)
            # the salience frame posterior runs hotter than a calibrated CNN's;
            # rescale the caller's CNN-calibrated thresholds into its range
            onset_threshold = min(onset_threshold, 0.45)
            frame_threshold = min(frame_threshold, 0.35)
        onset, frame_post = onset.cpu().numpy(), frame_post.cpu().numpy()
    return notes_from_posteriors(
        onset,
        frame_post,
        fps=sr / HOP,
        onset_threshold=onset_threshold,
        frame_threshold=frame_threshold,
        min_note_ms=min_note_ms,
        melodia_trick=melodia_trick,
    )


def chroma_from_note_events(events: list[NoteEvent], n_frames: int, fps: float) -> np.ndarray:
    """[12, n_frames] chroma matrix from note events
    (reference: amt/basic_pitch.py:116-156)."""
    out = np.zeros((12, n_frames), dtype=np.float32)
    for ev in events:
        a = int(np.clip(ev.start_time_s * fps, 0, n_frames - 1))
        b = int(np.clip(ev.end_time_s * fps, a + 1, n_frames))
        out[ev.pitch_midi % 12, a:b] += ev.amplitude
    m = out.max()
    return out / m if m > 0 else out
