"""Batch transcription: many songs through one batched analysis per device.

The port of audiotabs_tpu/runtime/batch_runner.py. Songs are decoded, padded
to one common bucket multiple and stacked into a [B, T] batch, and the batch
is split over the ``"data"`` axis of a device mesh (``parallel/mesh.py``),
as the JAX package shards it: zero rows pad B to a multiple of the axis
size, and a chunk is ``n_dev × BATCH_SONGS_PER_DEVICE`` songs. Each device
runs its rows of a chunk through htdemucs separation (``separate_program``
on [b, L]) and ``fused_analysis_batch`` as one batched call, on its own
stream (each card's own). Every chunk is dispatched first; then each device
shard comes to the host in one transfer, the shards are put back in row
order, the pad rows are cropped, and the songs' host tails
(``run_pipeline_from_features``) run in a thread pool. Dispatch holds the
host (the row-looped stages), so the tails start after the last chunk is
dispatched and overlap no device work (PERF.md §7).

    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch
    results = transcribe_batch(["a.wav", "b.wav"], "out_root")  # every card

With neither ``mesh`` nor ``device`` the mesh is ``default_mesh()`` (every
card on one ``"data"`` axis, or ``MESH_SHAPE``/``MESH_AXES``), which raises
when no GPU is present; ``device="cpu"`` (or any one device) runs the batch
there in chunks of ``BATCH_SONGS_PER_DEVICE``.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..config import Settings
from ..device import resolve_device
from ..parallel.mesh import Mesh, data_shards, default_mesh, make_mesh
from ..schemas import JobResult
from ..tracing import span, uploaded
from .fused import fused_analysis_batch
from .pipeline import features_to_host

_LOG = logging.getLogger(__name__)

ANALYSIS_SR = 22050


def _load_and_bucket(paths: list[Path], bucket_s: float) -> tuple[np.ndarray, list[int], int]:
    """Load all songs, resample to the analysis rate, pad to ONE common
    bucket multiple → ([B, T] batch, true lengths, sr).

    The JAX batch path's decode order: mono mean, peak-normalise at the
    native rate, then resample (the single-song path resamples first)."""
    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize

    signals = []
    for p in paths:
        y, sr = load_wav(p)
        y = peak_normalize(y)
        if sr != ANALYSIS_SR:
            y = resample_poly_host(y, sr, ANALYSIS_SR)
        signals.append(y)
    true_lens = [len(y) for y in signals]
    bucket = int(bucket_s * ANALYSIS_SR)
    T = ((max(true_lens) + bucket - 1) // bucket) * bucket
    batch = np.zeros((len(signals), T), dtype=np.float32)
    for i, y in enumerate(signals):
        batch[i, : len(y)] = y
        # wrap-pad the tail with the song itself
        rem = T - len(y)
        if rem > 0 and len(y) > 0:
            reps = int(np.ceil(rem / len(y)))
            batch[i, len(y) :] = np.tile(y, reps)[:rem]
    return batch, true_lens, ANALYSIS_SR


def _resolve_separation(s: Settings, sr: int, device: torch.device):
    """→ (sep_cfg, the htdemucs module on ``device``, chosen stem name), or
    (None, None, None) when separation is off or has no weights.

    ``sep_cfg`` = (seg, stride, shifts, n_sources, stem_idx, drums_idx), from
    ``htdemucs.program_config``, the single-song path's source of truth."""
    if not (s.ENABLE_DEMUCS and sr in (44100, 22050)):
        return None, None, None
    from ..models import htdemucs as hd

    params = hd.load_params()
    if params is None:
        return None, None, None
    cfg = hd.program_config(params, s.DEMUCS_MODEL, s.stem_priority())
    sep_cfg = (
        cfg["seg"], cfg["stride"], int(s.DEMUCS_SHIFTS),
        cfg["n_sources"], cfg["stem_idx"], cfg["drums_idx"],
    )
    return sep_cfg, hd.load_model(device), cfg["names"][cfg["stem_idx"]]


def _analyse_chunk(y: torch.Tensor, true_lens: np.ndarray, sr: int, s: Settings, sep_cfg, model) -> dict:
    """One chunk [b, T] on the device: separation (when configured) and the
    batched fused analysis. As in the JAX batch program, the net runs in
    float32 whatever ``DEMUCS_BF16`` says."""
    backend = s.CHORD_DETECTION_BACKEND
    kwargs = dict(
        switch_penalty=s.SWITCH_PENALTY,
        separate=s.ENABLE_DEMUCS,
        chord_backend=backend if backend in ("deep", "template") else "both",
        true_lens=true_lens,
    )
    if sep_cfg is None:
        return fused_analysis_batch(y, sr, **kwargs)
    from ..models.htdemucs import separate_program

    seg, stride, shifts, _n_sources, stem_idx, drums_idx = sep_cfg
    stems = separate_program(model, y, sr, seg, stride, shifts)  # [b, S, T]
    kwargs["separate"] = False
    return fused_analysis_batch(
        stems[:, stem_idx].contiguous(), sr, y_beat=stems[:, drums_idx].contiguous(), y_mix=y, **kwargs
    )


def _resolve_mesh(mesh: Mesh | None, device, s: Settings) -> Mesh:
    """The mesh a batch runs on: ``mesh``, else a one-device mesh of
    ``device``, else ``default_mesh``."""
    if mesh is not None and device is not None:
        raise ValueError("batch runner: pass a mesh or a device, not both")
    if mesh is not None:
        return mesh
    if device is not None:
        return make_mesh((1,), ("data",), devices=[resolve_device(device)])
    return default_mesh(s)


def batched_fused_analysis_stream(
    batch: np.ndarray,
    sr: int,
    true_lens=None,
    *,
    mesh: Mesh | None = None,
    device: str | torch.device | None = None,
    settings: Settings | None = None,
):
    """Yield (start_row, host feature dict) per chunk of
    ``n_dev × BATCH_SONGS_PER_DEVICE`` songs, ``n_dev`` the mesh's
    ``"data"`` size.

    Zero rows pad B to a multiple of ``n_dev`` and are cropped from every
    yielded chunk; a tail chunk runs at its own smaller B. Every chunk is
    dispatched before the first transfer, as in the JAX package; each
    device's shard of a chunk then comes to the host in one device→host
    copy. Dispatch is host-bound here, so the caller's work on chunk i
    starts only after the last chunk's dispatch and overlaps no device work
    (PERF.md §7)."""
    s = settings or Settings.from_env()
    mesh = _resolve_mesh(mesh, device, s)
    n_dev = mesh.shape["data"]
    B = batch.shape[0]
    if true_lens is None:
        true_lens = np.full((B,), batch.shape[1], dtype=np.int32)
    true_lens = np.asarray(true_lens, dtype=np.int32)
    chunk = n_dev * max(1, int(s.BATCH_SONGS_PER_DEVICE))
    pad_rows = (-B) % n_dev
    if pad_rows:
        _LOG.info("batch: padding %d zero rows to align B=%d to %d devices", pad_rows, B, n_dev)
        batch = np.concatenate([batch, np.zeros((pad_rows,) + batch.shape[1:], batch.dtype)])
        true_lens = np.concatenate([true_lens, np.full((pad_rows,), batch.shape[1], np.int32)])

    # real htdemucs separation when the checkpoint exists (same priority
    # logic as the single-song pipeline); else the weight-free HPSS fallback
    separation = {dev: _resolve_separation(s, sr, dev) for dev in dict.fromkeys(mesh.axis_devices("data"))}
    outs = []
    # parity trap: cuDNN convolutions and the LSTM default to TF32 on the card
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for a in range(0, batch.shape[0], chunk):
            rows = min(chunk, batch.shape[0] - a)
            shards = []
            for dev, part in data_shards(mesh, rows):
                lo, hi = a + part.start, a + part.stop
                # each card runs its shard on its own (default) stream
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext(), span("batch/dispatch"):
                    y = uploaded(torch.from_numpy(np.ascontiguousarray(batch[lo:hi], dtype=np.float32)).to(dev), "song")
                    sep_cfg, model, _stem_name = separation[dev]
                    shards.append(_analyse_chunk(y, true_lens[lo:hi], sr, s, sep_cfg, model))
            outs.append((a, rows, shards))
    for a, rows, shards in outs:
        with span("batch/chunk"):
            hosts = [features_to_host(o) for o in shards]
        host = hosts[0] if len(hosts) == 1 else {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}
        n = min(rows, B - a)
        yield a, {k: v[:n] for k, v in host.items()}


def batched_fused_analysis(
    batch: np.ndarray,
    sr: int,
    true_lens=None,
    *,
    mesh: Mesh | None = None,
    device: str | torch.device | None = None,
    settings: Settings | None = None,
) -> dict[str, np.ndarray]:
    """[B, T] → host fused feature dict with a leading B axis, sharded over
    the mesh's ``"data"`` axis.

    ``true_lens`` [B] (samples) masks each song's chord decode past its true
    end (defaults to the full row). See batched_fused_analysis_stream for
    the chunking contract; this wrapper concatenates the chunks."""
    parts = [h for _a, h in batched_fused_analysis_stream(batch, sr, true_lens, mesh=mesh, device=device, settings=settings)]
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def transcribe_batch(
    paths: list[Path | str],
    out_root: Path | str,
    *,
    mesh: Mesh | None = None,
    device: str | torch.device | None = None,
    settings: Settings | None = None,
    host_workers: int = 4,
) -> list[JobResult]:
    """Transcribe a batch of songs; writes the usual artifact layout under
    out_root/jobs/<stem>/ and returns the JobResults. The host tails' device
    work (their fallbacks) runs on the first device of the mesh's
    ``"data"`` axis."""
    from .pipeline import run_pipeline_from_features

    s = settings or Settings.from_env()
    mesh = _resolve_mesh(mesh, device, s)
    dev = mesh.axis_devices("data")[0]
    paths = [Path(p) for p in paths]
    out_root = Path(out_root)
    with span("batch") as whole:
        with span("batch/load") as load:
            batch, true_lens, sr = _load_and_bucket(paths, s.PAD_SECONDS_BUCKET)

        _cfg, _model, batch_stem_source = _resolve_separation(s, sr, dev)

        # unique job ids even when different directories share a filename
        stems = [p.stem for p in paths]
        job_ids = [
            stem if stems.count(stem) == 1 else f"{stem}-{i}" for i, stem in enumerate(stems)
        ]

        def one(i: int, feats_i: dict) -> JobResult:
            job_id = job_ids[i]
            job_dir = out_root / "jobs" / job_id
            for sub in ("input", "work", "out"):
                (job_dir / sub).mkdir(parents=True, exist_ok=True)
            return run_pipeline_from_features(
                feats_i, true_lens[i], sr, job_dir, job_id, stem_source=batch_stem_source, settings=s, device=dev
            )

        # every chunk is dispatched before the stream yields its first transfer;
        # each chunk's songs then go to the host pool as its transfer lands, and
        # their tails overlap each other and the later transfers, not device work
        futures = []
        with ThreadPoolExecutor(max_workers=host_workers) as pool:
            for a, feats_chunk in batched_fused_analysis_stream(batch, sr, true_lens, mesh=mesh, settings=s):
                n = next(iter(feats_chunk.values())).shape[0]
                for j in range(min(n, len(paths) - a)):
                    feats_i = {k: np.asarray(v[j]) for k, v in feats_chunk.items()}
                    futures.append(pool.submit(one, a + j, feats_i))
            with span("batch/drain") as drain:
                results = [f.result() for f in futures]

    total_audio = sum(true_lens) / sr
    _LOG.info(
        "batch: %d songs, %.0fs audio in %.2fs (load %.2f, the tails' drain after the last transfer %.2f) = %.1f audio-s/s",
        len(paths), total_audio, whole.seconds, load.seconds, drain.seconds, total_audio / whole.seconds,
    )
    return results
