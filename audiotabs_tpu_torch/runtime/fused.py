"""The device analysis: every device stage of the pipeline in one call.

Counterpart of audiotabs_tpu/runtime/fused.py::fused_analysis, with the same
arguments, output keys and dtypes, and of the JAX batch runner's vmap of it
(``fused_analysis_batch``: a batch of songs in one call): HPSS (median
kernel), BLSTM beat activation and DBN decode (csrc/dbn_viterbi.cu, every
song of the batch in one launch), Basic Pitch posteriors, salience (its
envelope in csrc/salience_envelope.cu, every song of the batch in one
launch) and DeepChroma chroma, template emissions, the template backend's
decode (csrc/constant_switch_viterbi.cu) and the CRF decode
(csrc/dense_viterbi.cu), each of every song of the batch in one launch, the
key CNN, the strum envelope,
content-window metrics (pYIN's Viterbi in csrc/banded_viterbi.cu, the onset
wait rule in csrc/onset_wait.cu) and calibration statistics (the onset wait
rule again). On the card these decoders are the kernels; on the CPU they are
plain loops over frames. All outputs stay on the input's device; the caller
makes one transfer to the host.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from ..accompaniment.strum import _onset_strength_median
from ..analysis.content_classifier import _window_metrics
from ..chords.extract import CHROMA_FPS, salience_chroma
from ..chords.templates import build_chord_library, emission_probs
from ..decode.dbn_beats import _dbn_forward
from ..decode.viterbi import viterbi_constant_switch
from ..models import basicpitch, beat_rnn, crf_chords, deepchroma, key_cnn
from ..ops.features import rms, spectral_centroid, spectral_rolloff
from ..ops.hpss import hpss, hpss_masks
from ..ops.onset import onset_detect_frames, onset_strength
from ..ops.spectral import stft
from ..tracing import span, uploaded

F16_OUTPUTS = ("y_harm", "amt_onset", "amt_frame", "beat_activation")


@dataclasses.dataclass
class AnalysisModels:
    """The trained nets of the analysis, on one device. A net whose
    checkpoint is absent (or switched off by its <MODEL>_WEIGHTS variable)
    is None and its stage takes the JAX package's weight-free path."""

    beat: list[beat_rnn.BeatBLSTM]  # empty: the weight-free onset activation
    basicpitch: basicpitch.BasicPitchCNN | None
    deepchroma: deepchroma.DeepChromaDNN | None
    key: key_cnn.KeyCNN | None
    crf: dict  # numpy pytree: the CRF is a decode, not a module


@lru_cache(maxsize=4)
def load_models(device: torch.device) -> AnalysisModels:
    """Load every checkpoint through models/convert.py onto ``device`` (once
    per device). The weights are normal tensors even when the first call
    comes from inside inference mode, so the cached nets stay usable with
    autograd on (a trainer, a test) later in the process."""
    br = beat_rnn.load_params()

    def net(module_cls, params):
        return None if params is None else module_cls.from_params(params).to(device).eval()

    with torch.inference_mode(False):
        return AnalysisModels(
            beat=[] if br is None else [m.to(device) for m in beat_rnn.ensemble_from_params(br)],
            basicpitch=net(basicpitch.BasicPitchCNN, basicpitch.load_params()),
            deepchroma=net(deepchroma.DeepChromaDNN, deepchroma.load_params()),
            key=net(key_cnn.KeyCNN, key_cnn.load_params()),
            crf=crf_chords.load_params() or crf_chords.template_emission_params(),
        )


def fused_analysis(
    y: torch.Tensor,
    sr: int,
    switch_penalty: float = 2.5,
    separate: bool = False,
    chord_backend: str = "both",
    true_len: int | None = None,
    y_beat: torch.Tensor | None = None,
    y_mix: torch.Tensor | None = None,
    models: AnalysisModels | None = None,
) -> dict[str, torch.Tensor]:
    """y [T] float32 on the device → dict of every device-computed feature:
    the B = 1 case of ``fused_analysis_batch``.

    ``separate`` makes the HPSS percussive component the beat source;
    ``y_beat`` (a drums stem) is the beat source when its RMS exceeds 15 %
    of the reference, else the percussive component of ``y_mix``.
    ``chord_backend`` ("template" | "deep" | "both") selects the chord
    decode(s). ``true_len`` (samples) masks chord emissions, CRF features and
    the key average past the true song end."""
    def row(x):
        return None if x is None else x[None]

    out = fused_analysis_batch(
        y[None], sr, switch_penalty, separate, chord_backend,
        None if true_len is None else [true_len], row(y_beat), row(y_mix), models,
    )
    return {k: v[0] for k, v in out.items()}


def fused_analysis_batch(
    y: torch.Tensor,
    sr: int,
    switch_penalty: float = 2.5,
    separate: bool = False,
    chord_backend: str = "both",
    true_lens=None,
    y_beat: torch.Tensor | None = None,
    y_mix: torch.Tensor | None = None,
    models: AnalysisModels | None = None,
) -> dict[str, torch.Tensor]:
    """A batch of songs y [B, T] → the outputs of ``fused_analysis``, each
    with a leading B axis; ``true_lens`` [B], ``y_beat`` and ``y_mix`` [B, T]
    are per song.

    The HPSS splits, the salience's envelope and posteriors, the template
    and CRF chord decodes, the DBN decode, the content-window metrics (all
    songs' windows in one call), the strum envelope and the calibration
    statistics run once on the whole batch: 8 median launches per batch with
    ``y_beat``, and one launch each of the salience envelope, of the
    constant-switch Viterbi (the template backend, with ``chord_backend``
    "template" or "both"), of the dense Viterbi (the CRF), of the DBN
    kernel, of the banded Viterbi (pYIN) and of the onset kernel twice
    (content windows and calibration), whatever B is. The nets (one hCQT a
    song, shared by the salience and the CNN), the chroma and emissions,
    the CRF's emission layer and the key CNN run song by song. Every
    reduction (energy and envelope maxima, quantiles, masks) stays within
    its row."""
    models = models or load_models(y.device)
    n_songs, n = y.shape
    lens = [None] * n_songs if true_lens is None else [int(t) for t in true_lens]
    out: dict[str, torch.Tensor] = {}

    # 1. harmonic/percussive split
    with span("fused/hpss"):
        y_harm, y_perc = hpss(y)
        out["y_harm"] = y_harm

        # 2. the beat source
        if y_beat is not None:
            fallback = hpss(y_mix)[1] if y_mix is not None else y_perc
            r_beat = torch.sqrt(torch.mean(y_beat**2, dim=-1))
            r_ref = torch.sqrt(torch.mean((y_mix if y_mix is not None else y) ** 2, dim=-1))
            use_drums = r_beat > 0.15 * r_ref
            out["beat_from_drums"] = use_drums
            beat_src = torch.where(use_drums[:, None], y_beat, fallback)
        else:
            beat_src = y_perc if separate else y

    # 3. the nets up to the salience, song by song (one hCQT each, shared by
    # the salience and the Basic Pitch CNN)
    with span("fused/nets"):
        rows = [_song_nets(y_harm[b], beat_src[b], sr, models) for b in range(n_songs)]
        sal = torch.stack([r.pop("salience") for r in rows])  # [B, 88, T]: the songs share the bucket's length
        # 3b. the posteriors of every song's salience: one envelope launch
        sal_onset, sal_frame = basicpitch.posteriors_from_salience(sal)
        if models.basicpitch is None:
            out["amt_onset"], out["amt_frame"] = sal_onset.contiguous(), sal_frame.contiguous()

    # 4. chroma, chord emissions, DeepChroma and the key, song by song
    with span("fused/chords"):
        for b, r in enumerate(rows):
            r.update(_song_chords(y[b], y_harm[b], sal_frame[b], sr, chord_backend, lens[b], models))
        out.update({k: torch.stack([r[k] for r in rows]) for k in rows[0]})

        # 4a. the template backend's decode of every song's emissions in one call
        # (one constant-switch launch)
        if chord_backend in ("template", "both"):
            out["chord_path"], out["chord_conf"] = viterbi_constant_switch(out["chord_emissions"], switch_penalty)

        # 4b. CRF chord decode of every song's gated features in one call (one
        # dense Viterbi launch)
        if "crf_features" in out:
            out["crf_path"], out["crf_conf"] = crf_chords.decode(models.crf, out.pop("crf_features"))

    # 4c. DBN beat decode of every song in one launch (on the f32
    # activations, before the f16 cast)
    with span("fused/dbn"):
        out["dbn_phases"], out["dbn_intervals"] = _dbn_forward(out["beat_activation"])

    # 4d. full-track strum envelope, from the input (not the harmonic) signal
    with span("fused/strum"):
        strum_env = _onset_strength_median(y, sr, 512)
        out["strum_envelope"] = strum_env / (strum_env.amax(dim=-1, keepdim=True) + 1e-9)

    # 5. content-classifier window metrics on the 3 s / 1.5 s window grid;
    # every song's windows are one [B·W, win] batch
    with span("fused/content"):
        win = 3 * sr
        hop_w = sr + sr // 2
        starts = [p for p in range(0, max(1, n - sr // 2), hop_w) if p + sr // 2 <= n]
        if starts:
            st = uploaded(torch.tensor(starts, dtype=torch.int32, device=y.device))
            idx = st[:, None].long() + torch.arange(win, device=y.device)[None, :]
            windows = torch.where(idx < n, y[:, torch.clamp(idx, 0, n - 1)], torch.zeros((), device=y.device))
            metrics = torch.stack(_window_metrics(windows.reshape(-1, win), sr), dim=1)
            out["content_starts"] = st.expand(n_songs, -1)
            out["content_metrics"] = metrics.reshape(n_songs, len(starts), -1)

    # 6. calibration characteristics
    with span("fused/calibration"):
        r = rms(y, 2048, 512)
        S = torch.abs(stft(y, n_fft=1024, hop=512))
        mh, mp = hpss_masks(S, 17, 17)
        eh = torch.sum((S * mh) ** 2, dim=(-2, -1))
        ep = torch.sum((S * mp) ** 2, dim=(-2, -1))
        onsets = onset_detect_frames(onset_strength(y, sr, hop=512, n_fft=1024), delta=0.5, wait=4)
        # parity trap: jnp.percentile interpolates linearly, as torch.quantile does
        out["char_rms_median"] = torch.quantile(r, 0.5, dim=-1)
        out["char_noise_rms"] = torch.quantile(r, 0.1, dim=-1)
        out["char_centroid"] = spectral_centroid(y, sr, 2048, 512).mean(dim=-1)
        out["char_rolloff"] = spectral_rolloff(y, sr, 2048, 512).mean(dim=-1)
        out["char_harm_ratio"] = torch.where(eh + ep > 1e-9, eh / (eh + ep), torch.full_like(eh, 0.5))
        out["char_onset_density"] = onsets.sum(dim=-1).to(torch.float32) / (n / sr)

    # halve the big device→host transfers (unit-scale posteriors and waveforms)
    for k in F16_OUTPUTS:
        out[k] = out[k].to(torch.float16)
    return out


def _song_nets(y_harm: torch.Tensor, beat_src: torch.Tensor, sr: int, models: AnalysisModels) -> dict[str, torch.Tensor]:
    """One song's nets up to the salience: the beat activation, the hCQT of
    the harmonic component, its salience [88, T] (``salience``, normalised
    for the whole batch by the caller) and the Basic Pitch CNN's posteriors
    on the same hCQT."""
    out: dict[str, torch.Tensor] = {}

    # 2. beat activation at 100 fps
    out["beat_activation"] = beat_rnn.beat_activation(beat_src, sr, models.beat, 100)

    # 3. AMT posteriors on the harmonic component
    hc = basicpitch.hcqt(y_harm, sr)
    out["salience"] = basicpitch.salience_from_hcqt(hc)
    if models.basicpitch is not None:
        out["amt_onset"], out["amt_frame"], _contour = basicpitch.cnn_apply(models.basicpitch, hc)
    return out


def _song_chords(
    y: torch.Tensor,
    y_harm: torch.Tensor,
    sal_frame: torch.Tensor,
    sr: int,
    chord_backend: str,
    true_len: int | None,
    models: AnalysisModels,
) -> dict[str, torch.Tensor]:
    """One song's chord features from its salience frame posteriors
    [T, 88]: chroma, the template emissions (decoded for the whole batch by
    the caller), the CRF's gated features (``crf_features``, decoded for the
    whole batch by the caller), DeepChroma, the key CNN."""
    out: dict[str, torch.Tensor] = {}

    # 4. chord chroma + template emissions at 10 fps
    hop = int(round(sr / CHROMA_FPS))
    t_ch = y.shape[-1] // hop + 1
    chroma = salience_chroma(sal_frame, t_ch)  # [12, t_ch]
    chroma_n = chroma / (torch.linalg.vector_norm(chroma, dim=0, keepdim=True) + 1e-9)
    energy = rms(y_harm, 2048, hop)[:t_ch]
    energy = energy / (energy.max() + 1e-9)
    out["chroma"] = chroma_n
    out["chord_energy"] = energy
    labels, templates = build_chord_library("majmin7")
    emissions = emission_probs(chroma_n, energy, labels, templates)
    if true_len is not None:
        valid = torch.arange(t_ch, device=y.device) * hop < true_len
        emissions = torch.where(valid[None, :], emissions, torch.full_like(emissions, 1.0 / emissions.shape[0]))
    out["chord_emissions"] = emissions

    if chord_backend in ("deep", "both"):
        if models.deepchroma is not None:
            dc_chroma = deepchroma.apply(models.deepchroma, deepchroma.features(y_harm, sr)[:t_ch])  # [t_ch, 12]
            out["dc_chroma"] = dc_chroma.T
            feats_t = dc_chroma / torch.clamp(torch.linalg.vector_norm(dc_chroma, dim=1, keepdim=True), min=1e-9)
        else:
            feats_t = chroma_n.T
        # silence gate: near-silent frames get zeroed features (decoded as N)
        zeros = torch.zeros_like(feats_t)
        feats_t = torch.where(energy[: feats_t.shape[0], None] > crf_chords.SILENCE_GATE_FRAC, feats_t, zeros)
        if true_len is not None:
            valid = torch.arange(feats_t.shape[0], device=y.device) * hop < true_len
            feats_t = torch.where(valid[:, None], feats_t, zeros)
        out["crf_features"] = feats_t

    # 5b. key CNN: 24-class key probabilities
    if models.key is not None:
        key_feats = key_cnn.features(y_harm, sr)
        key_mask = None
        if true_len is not None:
            key_mask = torch.arange(key_feats.shape[0], device=y.device) * (sr // 5) < true_len
        out["key_probs"] = key_cnn.apply(models.key, key_feats, key_mask)
    return out
