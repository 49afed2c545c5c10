"""Song analysis: decode → pad → fused device analysis → one transfer → beats.

Steps 1–3 of audiotabs_tpu/runtime/pipeline.py::run_pipeline (and the beat
decode of its tail) under ``ENABLE_DEMUCS=False``: the host decodes and
peak-normalises the WAV, wrap-pads it to the 30 s bucket, runs
``fused_analysis`` on the card, copies every output to the host in one
transfer and picks the beat times there. The artifact-writing tail waits for
the next slice, so nothing is written.
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
    """WAV path → (host feature dict, beat times [s] float32).

    Runs on the card unless ``device="cpu"``; raises when no GPU is present
    and the CPU was not asked for."""
    dev = resolve_device(device)
    s = settings or Settings.from_env()
    y, sr, _native = decode_for_analysis(Path(input_path), ANALYSIS_SR)
    if y.size < sr // 10:
        raise ValueError(f"input too short: {y.size} samples")
    y = peak_normalize(y)
    true_len = len(y)
    y_pad = _pad_to_bucket(y, sr, s.PAD_SECONDS_BUCKET)

    backend = s.CHORD_DETECTION_BACKEND
    # parity trap: cuDNN convolutions and the LSTM default to TF32 on the
    # card; the reference is f32 (matmul TF32 stays off, PyTorch's default)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = fused_analysis(
            torch.from_numpy(np.ascontiguousarray(y_pad, dtype=np.float32)).to(dev),
            sr,
            switch_penalty=s.SWITCH_PENALTY,
            chord_backend=backend if backend in ("deep", "template") else "both",
            true_len=true_len,
        )
        feats = features_to_host(out)

    t100 = int(true_len / sr * 100)
    act = np.asarray(feats["beat_activation"], dtype=np.float32)[:t100]
    beat_times = beats_from_decoded(feats["dbn_phases"][:t100], feats["dbn_intervals"][:t100], act, fps=100)
    return feats, beat_times
