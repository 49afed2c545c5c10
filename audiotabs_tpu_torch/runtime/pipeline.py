"""Song analysis: decode → pad → separation → fused device analysis → one transfer → beats.

Steps 1–3 of audiotabs_tpu/runtime/pipeline.py::run_pipeline (and the beat
decode of its tail): the host decodes and peak-normalises the WAV and
wrap-pads it to the 30 s bucket; the padded mix is uploaded once; with
``ENABLE_DEMUCS`` (the shipped setting) htdemucs separates it on the card,
the first stem of ``TRANSCRIPTION_STEM_PRIORITY`` (guitar) is analysed and
the drums stem is the beat source behind the fused analysis' RMS gate, with
the mix as its fallback; ``fused_analysis`` runs on the card, every output
comes to the host in one transfer and the beat times are picked there.
Without htdemucs weights (``HTDEMUCS_WEIGHTS=off``) the HPSS split stands in
for separation. A failed separation is recorded and the mix analysed, as in
the JAX pipeline. The artifact-writing tail waits for a later slice, so
nothing is written.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import Settings
from ..decode.dbn_beats import beats_from_decoded
from ..device import resolve_device
from ..io.wav import decode_for_analysis, peak_normalize
from ..models.htdemucs import separate_stems_device
from .fused import fused_analysis

ANALYSIS_SR = 22050


def _pad_to_bucket(y: np.ndarray, sr: int, bucket_s: float) -> np.ndarray:
    if bucket_s <= 0:
        return y
    bucket = int(bucket_s * sr)
    padded = ((len(y) + bucket - 1) // bucket) * bucket
    if padded == len(y):
        return y
    # wrap-pad: the tail repeats the song so beat/AMT statistics in the
    # padded region stay representative (outputs are cropped to true length)
    return np.pad(y, (0, padded - len(y)), mode="wrap")


def features_to_host(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Every output to host numpy in one transfer: the outputs are packed
    into one byte buffer on the device, copied once, and unpacked."""
    keys = list(out)
    flat = [out[k].reshape(-1).contiguous().view(torch.uint8) if out[k].dtype != torch.bool else out[k].reshape(-1).to(torch.uint8) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    result, pos = {}, 0
    for k, f in zip(keys, flat):
        t = out[k]
        chunk = host[pos : pos + f.numel()]
        pos += f.numel()
        if t.dtype == torch.bool:
            result[k] = chunk.astype(bool).reshape(tuple(t.shape))
        else:
            result[k] = chunk.view(np.dtype(str(t.dtype).removeprefix("torch."))).reshape(tuple(t.shape))
    return result


def run_analysis(input_path: str | os.PathLike, device: str | torch.device | None = None, settings: Settings | None = None):
    """WAV path → (host feature dict, beat times [s] float32, {"stem_source", "errors"}).

    ``stem_source`` is the analysed signal: a stem name, "hpss_harmonic"
    (no htdemucs weights) or "mix"; ``errors`` lists the stages that failed
    and were passed over ("separation: ..."). Runs on the card unless
    ``device="cpu"``; raises when no GPU is present and the CPU was not
    asked for."""
    dev = resolve_device(device)
    s = settings or Settings.from_env()
    y, sr, _native = decode_for_analysis(Path(input_path), ANALYSIS_SR)
    if y.size < sr // 10:
        raise ValueError(f"input too short: {y.size} samples")
    y = peak_normalize(y)
    true_len = len(y)
    y_pad = _pad_to_bucket(y, sr, s.PAD_SECONDS_BUCKET)

    backend = s.CHORD_DETECTION_BACKEND
    errors: list[str] = []
    stem_source = "mix"
    hpss_fallback = False
    y_beat = None
    # parity trap: cuDNN convolutions and the LSTM default to TF32 on the
    # card; the reference is f32 (matmul TF32 stays off, PyTorch's default)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_mix = torch.from_numpy(np.ascontiguousarray(y_pad, dtype=np.float32)).to(dev)  # uploaded once
        stem = y_mix
        if s.ENABLE_DEMUCS:
            try:
                stems = separate_stems_device(y_mix, sr, model_name=s.DEMUCS_MODEL, shifts=s.DEMUCS_SHIFTS, bf16=s.DEMUCS_BF16)
                if stems is None:
                    # no weights: fused_analysis' HPSS split stands in (harmonic analysed, percussive tracked)
                    hpss_fallback = True
                    stem_source = "hpss_harmonic"
                else:
                    name = next((n for n in s.stem_priority() if n in stems), None)
                    if name is not None:
                        stem, stem_source = stems[name], name
                    y_beat = stems.get("drums")
            except Exception as exc:  # the JAX pipeline records the stage and goes on with the mix
                errors.append(f"separation: {exc}")
        out = fused_analysis(
            stem,
            sr,
            switch_penalty=s.SWITCH_PENALTY,
            separate=hpss_fallback,
            chord_backend=backend if backend in ("deep", "template") else "both",
            true_len=true_len,
            y_beat=y_beat,
            y_mix=y_mix if y_beat is not None else None,
        )
        feats = features_to_host(out)

    t100 = int(true_len / sr * 100)
    act = np.asarray(feats["beat_activation"], dtype=np.float32)[:t100]
    beat_times = beats_from_decoded(feats["dbn_phases"][:t100], feats["dbn_intervals"][:t100], act, fps=100)
    return feats, beat_times, {"stem_source": stem_source, "errors": errors}
