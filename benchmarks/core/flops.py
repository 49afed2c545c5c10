"""Model FLOPs of a song, from the configuration's widths and the windows
and frames that a song of its length makes: 2 per multiply-add of every
convolution, transposed convolution, linear layer, LSTM gate product and
attention product of the separation net, and of the fused analysis' nets:
the hCQT's matrix product, the Basic Pitch CNN, the beat BLSTM ensemble
(its overlapped windows), DeepChroma and the key CNN. The separation net is
the one ``nets`` entry besides the analysis' four, counted by the
``song(widths, n)`` of its own file ``benchmarks/nets/<net>.py``
(``nets/htdemucs.py`` calls ``htdemucs_song``), so a second net adds a file
and edits none here.
Norms, activations, FFTs, resampling and the decoders are not counted. The
count depends on the shapes alone, never on what the program launches, so
it reads the same work whatever implements it. A song counts at its true
length: the program pads it to its bucket (30 s), and that padding is work
the song does not need, so a program that pads less does not read as
doing less."""

from __future__ import annotations

import math
from collections.abc import Callable
from pathlib import Path

from .cells import ROOT, net_count

ANALYSIS_SR = 22050
MODEL_SR = 44100
ANALYSIS_NETS = ("basicpitch", "beat_rnn", "deepchroma", "key_cnn")  # the fused analysis' nets; any other separates


def samples(seconds: float, sr: int = ANALYSIS_SR) -> int:
    """Samples of a song of ``seconds``, uploaded at 44.1 kHz, at the analysis rate."""
    return int(seconds * MODEL_SR) * sr // MODEL_SR


def htdemucs_window(h: dict, length: int) -> int:
    """One window of ``length`` samples (a multiple of 1024) at 44.1 kHz through htdemucs.
    ``cross_layers``: the indices of the transformer's cross-attention
    layers, the others self-attending; without it the even layers cross-attend."""
    chans, hidden, ch = h["channels"], h["dconv_hidden"], h["audio_channels"]
    S, D, ff, layers = h["sources"], h["bottom_channels"], h["transformer_ff"], h["transformer_layers"]
    T, F = -(-length // 1024), 2048
    total, c_in, t_in = 0, 2 * ch, ch
    fq, lt = F, length
    for c, (hf, ht) in zip(chans, hidden):
        fq, lt = fq // 4, lt // 4
        total += 2 * c_in * c * 8 * fq * T + 2 * 2 * (3 * c * hf + hf * 2 * c) * fq * T + 2 * c * 2 * c * fq * T
        total += 2 * t_in * c * 8 * lt + 2 * 2 * (3 * c * ht + ht * 2 * c) * lt + 2 * c * 2 * c * lt
        c_in = t_in = c
    ns, nt, c = fq * T, lt, chans[-1]
    total += 2 * 2 * (ns + nt) * c * D  # up and down projections of both branches
    cross = set(h.get("cross_layers", range(0, layers, 2)))
    for i in range(layers):
        for nq, nk in ((ns, nt), (nt, ns)):
            nk = nk if i in cross else nq
            total += 2 * 2 * nq * D * D + 2 * 2 * nk * D * D + 2 * 2 * nq * nk * D + 2 * 2 * nq * D * ff
    outs = chans[:-1][::-1] + [S * 2 * ch]
    touts = chans[:-1][::-1] + [S * ch]
    for c, co, cto in zip(chans[::-1], outs, touts):
        total += 2 * c * 9 * 2 * c * fq * T + 2 * c * co * 8 * fq * T
        total += 2 * c * 3 * 2 * c * lt + 2 * c * cto * 8 * lt
        fq, lt = fq * 4, lt * 4
    return total


def htdemucs_song(h: dict, n: int) -> int:
    """A song of ``n`` samples at the analysis rate: its windows of
    ``segment`` at 44.1 kHz, ``stride`` apart, over the upsampled song."""
    l44 = 2 * n
    windows = len(range(0, max(1, l44 - h["segment"] + h["stride"]), h["stride"]))
    return windows * h["shifts"] * htdemucs_window(h, h["segment"])


def hcqt(n: int, hop: int = 256, fmin: float = 27.5, n_bins: int = 264, bpo: int = 36,
         harmonics=(0.5, 1, 2, 3, 4, 5, 6, 7), max_kernel_len: int = 16384, sr: int = ANALYSIS_SR) -> tuple[int, int]:
    """(FLOPs, frames) of the hCQT: one base CQT as frames [nf, K] @ bank [K, 2 * bins]."""
    shifts = [int(round(bpo * math.log2(x))) for x in harmonics]
    base_fmin = fmin * 2.0 ** (min(shifts) / bpo)
    nyq_bins = int(math.floor(bpo * math.log2((sr / 2.0) / base_fmin)))
    bins = min(n_bins + max(shifts) - min(shifts), nyq_bins)
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    k = min(-(-math.ceil(q * sr / base_fmin) // 128) * 128, -(-max_kernel_len // 128) * 128)
    nf = n // hop + 1
    return 2 * nf * k * 2 * bins, nf


def basicpitch_cnn(frames: int, harmonics: int = 8) -> int:
    """The CNN on an hCQT [harmonics, 264, frames], "SAME" convolutions."""
    convs = [(harmonics, 16, 5 * 5, 264), (16, 8, 39 * 3, 264), (8, 1, 5 * 5, 264), (1, 32, 7 * 7, 88), (32, 1, 7 * 3, 88),
             (harmonics, 32, 5 * 5, 88), (33, 1, 3 * 3, 88)]
    return sum(2 * ci * co * k * rows * frames for ci, co, k, rows in convs)


def blstm(b: dict, frames: int, window: int = 256, margin: int = 32) -> int:
    """The beat ensemble at 100 fps; every member runs overlapped windows of
    ``window`` frames (one pass when the song is shorter)."""
    hop = window - 2 * margin
    steps = frames if frames <= window else -(-(frames - 2 * margin) // hop) * window
    H, dims = b["hidden"], [b["input_dim"]] + [2 * b["hidden"]] * (b["layers"] - 1)
    per_step = sum(2 * 2 * 4 * H * (d + H) for d in dims) + 2 * 2 * H
    return b["members"] * steps * per_step


def deepchroma(d: dict, frames: int) -> int:
    dims = [d["input_dim"]] + [d["hidden"]] * d["layers"] + [12]
    return 2 * frames * sum(a * c for a, c in zip(dims[:-1], dims[1:]))


def key_cnn(k: dict, frames: int) -> int:
    bands = k["bands"]
    return 2 * frames * (8 * 25 * bands + 16 * 8 * 9 * (bands // 2) + 32 * 16 * 9 * (bands // 4)) + 2 * (bands // 4) * 32 * 24


def separation_net(config: dict, root: Path = ROOT) -> tuple[str, Callable] | None:
    """(name, ``song``) of the net that ``config`` separates with, None where
    it does not separate. Raises ValueError, naming the nets, where it
    separates and its ``nets`` name no separation net, or more than one, or
    one without a count file ``benchmarks/nets/<net>.py``."""
    if not config.get("settings", {}).get("ENABLE_DEMUCS", True):
        return None
    found = sorted(set(config.get("nets", {})) - set(ANALYSIS_NETS))
    if len(found) != 1:
        raise ValueError(f"configuration {config.get('name')!r} separates: its nets name one separation net besides "
                         f"{', '.join(ANALYSIS_NETS)}, and these name {', '.join(found) or 'none'}")
    (net,) = found
    if not (root / "benchmarks" / "nets" / f"{net}.py").is_file():
        raise ValueError(f"configuration {config.get('name')!r} separates with {net!r}, which has no count file "
                         f"benchmarks/nets/{net}.py")
    return net, net_count(net, root)


def song_flops(config: dict, seconds: float, separation: tuple[str, Callable] | None) -> float:
    """Model FLOPs of one song of ``seconds`` (its true length) under ``config``;
    ``separation`` is ``separation_net(config)``, resolved once a run."""
    nets = config["nets"]
    n = samples(seconds)
    total = 0
    if separation is not None:
        net, song = separation
        total += song(nets[net], n)
    bp = nets["basicpitch"]
    cqt_flops, nf = hcqt(n, hop=bp["hop"], n_bins=bp["bins"])
    total += cqt_flops + basicpitch_cnn(nf, bp["harmonics"])
    total += blstm(nets["beat_rnn"], n // (ANALYSIS_SR // 100) + 1)
    total += deepchroma(nets["deepchroma"], n // round(ANALYSIS_SR / 10) + 1)
    total += key_cnn(nets["key_cnn"], n // (ANALYSIS_SR // 5) + 1)
    return float(total)
