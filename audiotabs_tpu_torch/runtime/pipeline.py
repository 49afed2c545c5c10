"""Pipeline orchestrator: decode → separate → fused device analysis → one
transfer → beats → calibration → transcription → chords → key → mode
processing → quantize → export.

The port of audiotabs_tpu/runtime/pipeline.py. ``run_pipeline`` runs every
step on the card and writes the JAX package's artifact set into
``<job_dir>/out`` (``result.json`` is written by the caller, as there):
``beat_times.json``, ``chords.json``, ``threshold_calibration.json``,
``content_segments.json``, ``strum_onsets.json``, ``chosen_shapes.json``,
``tab_positions.json``, ``note_events.csv``, ``result.musicxml``,
``transcription.mid``, ``score.ly``, ``score.pdf`` and ``profile.json``,
and ``audio_mono_44k.wav`` and ``audio_harmonic.wav`` into
``<job_dir>/work``.

``profile.json`` holds each stage's host wall seconds, the duration of its
span (the package's ``tracing.py``; the stages are the request span's stages, its
other spans add nothing there). The card runs asynchronously, so a stage
holds the device time the host waited for in it: ``separation`` is only the
enqueue of separation's work, and ``analysis``, whose one transfer waits for
the card, holds separation's device time as well as the fused analysis'.

Steps 1–3 (``_analyse``, shared with ``run_analysis``): the host decodes and
peak-normalises the WAV and wrap-pads it to the 30 s bucket; the padded mix
is uploaded once; with ``ENABLE_DEMUCS`` (the shipped setting) htdemucs
separates it on the card, the first stem of ``TRANSCRIPTION_STEM_PRIORITY``
(guitar) is analysed and the drums stem is the beat source behind the fused
analysis' RMS gate, with the mix as its fallback; ``fused_analysis`` runs on
the card and every output comes to the host in one transfer. Without
htdemucs weights (``HTDEMUCS_WEIGHTS=off``) the HPSS split stands in for
separation. A failed stage is recorded in ``errors`` and passed over, as in
the JAX pipeline.

Steps 4–13 (``_pipeline_tail``) are host numpy on the fused outputs, in
guitar, accompaniment or notes mode (``theory/postprocess.py``), with the
deep or the template chord backend. Where the fused analysis failed, or lacks
what a setting asks for (a chord vocabulary other than majmin7 for the
template backend, content windows other than 3 s / 1.5 s), the stage
recomputes it on the card, as the JAX package recomputes it on its device:
the harmonic part (HPSS), the beat activation and DBN decode, the
calibration statistics, Basic Pitch, the chroma and chord decodes and the
content-window metrics, the medians of each on the median kernel.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from ..config import Settings
from ..decode.dbn_beats import beats_from_decoded
from ..device import on_device, resolve_device
from ..io.wav import decode_for_analysis, peak_normalize, write_artifact_async, write_wav
from ..models.htdemucs import separate_stems_device
from ..schemas import ChordSegment, JobResult
from ..theory.events import NoteEvent
from ..tracing import request, span, uploaded
from .fused import fused_analysis

_LOG = logging.getLogger(__name__)

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


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


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


@dataclasses.dataclass
class _Analysis:
    native: tuple[np.ndarray, int]  # the mix at its own rate, peak-normalised
    y: np.ndarray  # the mix at the analysis rate, peak-normalised, unpadded
    true_len: int
    stem: torch.Tensor  # the analysed signal on the device, padded
    beat_source: torch.Tensor  # the drums stem when separated, else the padded mix, on the device
    stem_source: str
    feats: dict[str, np.ndarray] | None  # None when the fused analysis failed
    beat_act_from_feats: bool
    artifact_writer: object | None


def _analyse(
    input_path: Path, dev: torch.device, s: Settings, stages: dict[str, float] | None, errors: list[str], *,
    strict: bool, artifact_path: Path | None = None,
) -> _Analysis:
    """Steps 1–3: decode, separation, the fused analysis and its one
    transfer, each stage's seconds added to ``stages``. A failed separation
    is recorded in ``errors`` and the mix analysed; a failed analysis raises
    when ``strict``, else it is recorded and ``feats`` is None."""
    # ---- 1. decode ----
    # one resample from the native rate straight to the analysis rate; the
    # mono-44.1k work artifact writes on a thread, overlapped with device work
    with span("decode", stages):
        y, sr, (x_native, sr_native) = decode_for_analysis(input_path, ANALYSIS_SR)
        writer = write_artifact_async(x_native, sr_native, artifact_path) if artifact_path is not None else None
        if y.size < sr // 10:
            raise ValueError(f"input too short: {y.size} samples")
        y = peak_normalize(y)
        # full-band copy for the strum detector: pick transients above the
        # 11 kHz analysis band decide which attacks its median-mel envelope
        # sees (reference runs strum detection at the decode rate)
        y_native = peak_normalize(x_native)
    true_len = len(y)

    backend = s.CHORD_DETECTION_BACKEND
    stem_source = "mix"
    hpss_fallback = False
    y_beat = None
    feats = None
    # parity trap: cuDNN convolutions and the LSTM default to TF32 on the
    # card; the reference is f32 (matmul TF32 stays off, PyTorch's default)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with span("upload"):
            y_pad = _pad_to_bucket(y, sr, s.PAD_SECONDS_BUCKET)
            y_mix = uploaded(torch.from_numpy(np.ascontiguousarray(y_pad, dtype=np.float32)).to(dev), "song")  # uploaded once
        stem = y_mix
        # ---- 2. separation ----
        if s.ENABLE_DEMUCS:
            try:
                with span("separation", stages):
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
                _LOG.warning("separation failed: %s", exc)

        # ---- 3. fused device analysis: one call + one transfer ----
        with span("analysis", stages):
            try:
                with span("analysis/fused"):
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
                with span("analysis/transfer"):
                    feats = features_to_host(out)
            except Exception as exc:
                if strict:
                    raise
                errors.append(f"analysis: {exc}")
                _LOG.warning("fused analysis failed: %s", exc)
    return _Analysis(
        native=(y_native, sr_native), y=y, true_len=true_len, stem=stem, stem_source=stem_source, feats=feats,
        beat_source=y_beat if y_beat is not None else y_mix,
        beat_act_from_feats=feats is not None and (stem is y_mix or y_beat is not None), artifact_writer=writer,
    )


def run_analysis(input_path: str | os.PathLike, device: str | torch.device | None = None, settings: Settings | None = None):
    """WAV path → (host feature dict, beat times [s] float32, {"stem_source", "errors"}).

    Steps 1–3 of ``run_pipeline`` and its beat decode, writing nothing.
    ``stem_source`` is the analysed signal: a stem name, "hpss_harmonic"
    (no htdemucs weights) or "mix"; ``errors`` lists the stages that failed
    and were passed over ("separation: ..."). Runs on the card unless
    ``device="cpu"``; raises when no GPU is present and the CPU was not
    asked for."""
    dev = resolve_device(device)
    s = settings or Settings.from_env()
    errors: list[str] = []
    a = _analyse(Path(input_path), dev, s, None, errors, strict=True)
    feats = a.feats
    t100 = int(a.true_len / ANALYSIS_SR * 100)
    act = np.asarray(feats["beat_activation"], dtype=np.float32)[:t100]
    beat_times = beats_from_decoded(feats["dbn_phases"][:t100], feats["dbn_intervals"][:t100], act, fps=100)
    return feats, beat_times, {"stem_source": a.stem_source, "errors": errors}


def run_pipeline(
    job_dir: Path | str,
    input_path: Path | str,
    device: str | torch.device | None = None,
    settings: Settings | None = None,
) -> JobResult:
    """Audio file → artifacts in ``<job_dir>/out`` and ``<job_dir>/work``, and
    the ``JobResult``. Runs on the card unless ``device="cpu"``; raises when
    no GPU is present and the CPU was not asked for."""
    dev = resolve_device(device)
    s = settings or Settings.from_env()
    job_dir = Path(job_dir)
    with request(job_dir.name):
        return _run_pipeline(job_dir, Path(input_path), dev, s)


def _run_pipeline(job_dir: Path, input_path: Path, dev: torch.device, s: Settings) -> JobResult:
    work = job_dir / "work"
    out = job_dir / "out"
    with span("job_dirs"):
        work.mkdir(parents=True, exist_ok=True)
        out.mkdir(parents=True, exist_ok=True)
    stages: dict[str, float] = {}
    errors: list[str] = []
    sr = ANALYSIS_SR

    a = _analyse(input_path, dev, s, stages, errors, strict=False, artifact_path=work / "audio_mono_44k.wav")
    feats, true_len = a.feats, a.true_len
    # the tail's device stages as _analyse's: inference mode, cuDNN without
    # TF32 (the reference is float32; matmul TF32 is off by default)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if feats is not None:
            with span("work_wavs"):
                y_harm = np.asarray(feats["y_harm"], dtype=np.float32)[:true_len]
                try:
                    write_wav(work / "audio_harmonic.wav", y_harm, sr)
                except Exception:
                    pass
        else:
            with span("harmonic", stages):
                # the fused analysis failed: the harmonic part of the padded
                # stem again, on the card (two median launches)
                try:
                    from ..ops.hpss import harmonic

                    y_harm = harmonic(a.stem).cpu().numpy()[:true_len]
                    write_wav(work / "audio_harmonic.wav", y_harm, sr)
                except Exception as exc:
                    errors.append(f"harmonic: {exc}")
                    y_harm = a.stem[:true_len].cpu().numpy()

        if a.artifact_writer is not None:
            with span("work_wavs"):
                a.artifact_writer.join(timeout=30)  # artifact durable before the tail
            if a.artifact_writer.is_alive():
                errors.append("decode: audio_mono_44k.wav writer did not finish")
            elif getattr(a.artifact_writer, "error", None) is not None:
                errors.append(f"decode: audio_mono_44k.wav write failed: {a.artifact_writer.error}")

        return _pipeline_tail(
            feats=feats,
            y_harm=y_harm,
            y=a.y,
            true_len=true_len,
            sr=sr,
            work=work,
            out=out,
            job_id=job_dir.name,
            stages=stages,
            errors=errors,
            stem_source=a.stem_source,
            beat_act_from_feats=a.beat_act_from_feats,
            beat_source=a.beat_source,
            y_native=a.native,
            settings=s,
            device=dev,
        )


def run_pipeline_from_features(
    feats: dict,
    true_len: int,
    sr: int,
    job_dir: Path | str,
    job_id: str | None = None,
    stem_source: str | None = None,
    settings: Settings | None = None,
    device: str | torch.device | None = None,
) -> JobResult:
    """Post-analysis pipeline for a song whose fused features (host numpy)
    were computed elsewhere: writes the artifacts and ``out/result.json``.
    A stage that must recompute device work (a setting the fused features do
    not cover) runs it on ``device``, the card unless the caller names the CPU."""
    s = settings or Settings.from_env()
    job_dir = Path(job_dir)
    job_id = job_id or job_dir.name
    with request(job_id):
        work = job_dir / "work"
        out = job_dir / "out"
        with span("job_dirs"):
            work.mkdir(parents=True, exist_ok=True)
            out.mkdir(parents=True, exist_ok=True)
        with span("work_wavs"):
            y_harm = np.asarray(feats["y_harm"], dtype=np.float32)[:true_len]
            try:
                write_wav(work / "audio_harmonic.wav", y_harm, sr)
            except Exception:
                pass
        # the batch runner calls this from a thread pool: inference mode is per
        # thread, cuDNN's flags are global, and no stage that reaches cuDNN (the
        # failed-analysis fallbacks) runs from here
        with torch.inference_mode():
            result = _pipeline_tail(
                feats=feats,
                y_harm=y_harm,
                true_len=true_len,
                sr=sr,
                work=work,
                out=out,
                job_id=job_id,
                stages={},
                errors=[],
                stem_source=stem_source or ("hpss_harmonic" if s.ENABLE_DEMUCS else "mix"),
                beat_act_from_feats=True,
                settings=s,
                device=device,
            )
        from .storage import LocalStorage

        LocalStorage(job_dir.parent.parent).write_json(out / "result.json", result.to_dict())
    return result


def _pipeline_tail(
    *,
    feats: dict | None,
    y_harm: np.ndarray,
    true_len: int,
    sr: int,
    out: Path,
    job_id: str,
    stages: dict[str, float],
    errors: list[str],
    stem_source: str,
    beat_act_from_feats: bool,
    y: np.ndarray | None = None,
    beat_source: torch.Tensor | None = None,
    work: Path | None = None,
    y_native: tuple[np.ndarray, int] | None = None,
    settings: Settings,
    device: str | torch.device | None = None,
) -> JobResult:
    """Steps 4–13 on the host fused outputs ``feats`` (None when the fused
    analysis failed): every stage in its own try block, its failure appended
    to ``errors``. A stage that recomputes device work runs it on ``device``
    (the beat activation on ``beat_source``'s device); ``y`` is the mix at
    the analysis rate and ``work`` the job's work directory (default: beside
    ``out``), both read by the calibration fallback."""
    s = settings
    work = out.parent / "work" if work is None else work

    # ---- 4. beat tracking + meter (pipeline.py:1682-1686; beats.py:46-58) ----
    beat_times = np.asarray([], dtype=np.float32)
    time_sig = "4/4"
    downbeats = np.asarray([], dtype=np.float32)
    with span("beats", stages):
        try:
            t100 = int(true_len / sr * 100)
            if beat_act_from_feats and feats is not None and "dbn_phases" in feats:
                act = np.asarray(feats["beat_activation"], dtype=np.float32)[:t100]
                beat_times = beats_from_decoded(
                    np.asarray(feats["dbn_phases"])[:t100],
                    np.asarray(feats["dbn_intervals"])[:t100],
                    act,
                    fps=100,
                )
            else:
                from ..decode.dbn_beats import dbn_beat_track

                if beat_act_from_feats and feats is not None:
                    act = np.asarray(feats["beat_activation"], dtype=np.float32)[:t100]
                else:
                    from ..models.beat_rnn import beat_activation
                    from .fused import load_models

                    src = on_device(beat_source, device)
                    act = beat_activation(src, sr, load_models(src.device).beat, 100).cpu().numpy()[:t100]
                beat_times = dbn_beat_track(act, fps=100, device=device)
            from ..decode.downbeats import infer_meter_and_downbeats

            time_sig, downbeats = infer_meter_and_downbeats(beat_times, act, fps=100)
        except Exception as exc:
            errors.append(f"beats: {exc}")
            _LOG.warning("beat tracking failed: %s", exc)

    # ---- 5. threshold calibration (pipeline.py:1692-1725) ----
    onset_thr, frame_thr = s.BASIC_PITCH_ONSET_THRESHOLD, s.BASIC_PITCH_FRAME_THRESHOLD
    if s.ENABLE_AUTO_THRESHOLD_CALIBRATION:
        try:
            with span("calibration", stages):
                from ..analysis.audio_quality import _to_db, analyze_audio_characteristics, calibrate_thresholds

                if feats is not None:
                    chars = {
                        "rms_db": _to_db(float(feats["char_rms_median"])),
                        "spectral_centroid": float(feats["char_centroid"]),
                        "spectral_rolloff": float(feats["char_rolloff"]),
                        "harmonic_ratio": float(feats["char_harm_ratio"]),
                        "onset_density": float(feats["char_onset_density"]),
                        "noise_floor_db": _to_db(float(feats["char_noise_rms"])),
                    }
                else:
                    chars = analyze_audio_characteristics(
                        work / "audio_mono_44k.wav", cache_dir=work,
                        audio=y if y is not None else y_harm, audio_sr=sr, device=device,
                    )
                onset_thr, frame_thr = calibrate_thresholds(chars)
                _write_json(
                    out / "threshold_calibration.json",
                    {"characteristics": chars, "onset_threshold": onset_thr, "frame_threshold": frame_thr},
                )
        except Exception as exc:
            errors.append(f"calibration: {exc}")

    # ---- 6. base transcription on harmonic stem (pipeline.py:1730-1739) ----
    base_events: list[NoteEvent] = []
    base_backend = "none"
    with span("transcription", stages):
        try:
            from ..models.basicpitch import HOP as BP_HOP
            from ..models.basicpitch import load_params as load_bp
            from ..models.basicpitch import notes_from_posteriors

            bp_params = load_bp()
            if feats is not None:
                fps_amt = sr / BP_HOP
                t_amt = int(true_len / BP_HOP) + 1
                # the salience posteriors run hotter than a trained CNN's
                # calibrated sigmoids; cap the thresholds only on that path
                if bp_params is None:
                    onset_thr_eff = min(onset_thr, 0.45)
                    frame_thr_eff = min(frame_thr, 0.35)
                else:
                    onset_thr_eff, frame_thr_eff = onset_thr, frame_thr
                onset_post = np.asarray(feats["amt_onset"], dtype=np.float32)[:t_amt]
                frame_post = np.asarray(feats["amt_frame"], dtype=np.float32)[:t_amt]
                with span("transcription/notes"):
                    base_events = notes_from_posteriors(
                        onset_post,
                        frame_post,
                        fps=fps_amt,
                        onset_threshold=onset_thr_eff,
                        frame_threshold=frame_thr_eff,
                        min_note_ms=s.BASIC_PITCH_MIN_NOTE_MS,
                    )
                # the JAX package's backend names: the artifact contract's values
                base_backend = "basicpitch_jax_cnn" if bp_params is not None else "basicpitch_jax"
            else:
                from ..models.basicpitch import transcribe_polyphonic

                base_events = transcribe_polyphonic(
                    y_harm, sr, onset_threshold=onset_thr, frame_threshold=frame_thr,
                    min_note_ms=s.BASIC_PITCH_MIN_NOTE_MS, params=bp_params, device=device,
                )
                base_backend = "basicpitch_jax"
        except Exception as exc:
            errors.append(f"transcription: {exc}")
            _LOG.warning("transcription failed: %s", exc)

    # ---- 7. beat grid selection + tempo (pipeline.py:1750-1756) ----
    from ..decode.dbn_beats import normalize_beat_times
    from ..theory.chord_simplify import pick_best_beat_times, tempo_from_beat_times

    raw_beats = beat_times.copy()
    tempo_raw_bpm = tempo_from_beat_times(raw_beats)
    with span("beat_select", stages):
        try:
            beat_times = pick_best_beat_times(base_events, beat_times, time_signature=time_sig)
        except Exception as exc:
            errors.append(f"beat_select: {exc}")
    tempo_bpm = tempo_from_beat_times(beat_times)
    norm_beats, offset = normalize_beat_times(beat_times if beat_times is not None and len(beat_times) else None)
    if tempo_bpm <= 0:
        tempo_bpm = 120.0
    # NOTE: base_events/chords stay in RAW time through mode processing
    # (strum onsets and content segments are raw-time); the -offset shift is
    # applied to the mode OUTPUTS below, matching the reference's ordering
    # (pipeline.py:1824-1895 processes raw, then shifts).

    # ---- 8. chords (pipeline.py:1767-1774) ----
    chords: list[ChordSegment] = []
    chroma, chroma_times = None, None
    with span("chords", stages):
        try:
            from ..chords.extract import CHROMA_FPS

            backend = s.CHORD_DETECTION_BACKEND
            if feats is not None and backend == "template" and s.CHORD_VOCAB == "majmin7":
                # the fused emissions and path are built with the majmin7 library
                from ..chords.segments import beat_sync_majority, frames_to_segments
                from ..chords.templates import build_chord_library

                t_ch = int(true_len / sr * CHROMA_FPS) + 1
                emissions = np.asarray(feats["chord_emissions"])[:, :t_ch]
                chroma = np.asarray(feats["chroma"])[:, :t_ch]
                labels, _T = build_chord_library(s.CHORD_VOCAB)
                if "chord_path" in feats:
                    path = np.asarray(feats["chord_path"])[:t_ch]
                else:
                    from ..decode.viterbi import viterbi_constant_switch

                    path = viterbi_constant_switch(on_device(emissions, device), s.SWITCH_PENALTY)[0].cpu().numpy()
                path_np, conf_np = beat_sync_majority(path, emissions, raw_beats if raw_beats.size else None, CHROMA_FPS)
                chroma_times = np.arange(path_np.shape[0], dtype=np.float32) / CHROMA_FPS
                chords = frames_to_segments(path_np, conf_np, chroma_times, labels, min_len=s.MIN_SEGMENT_SEC)
            elif backend == "deep":
                from ..chords.extract import extract_chords_deep

                pre = None
                pre_path = None
                if feats is not None:
                    t_ch = int(true_len / sr * CHROMA_FPS) + 1
                    # dc_chroma is present when the trained DeepChroma DNN ran
                    # inside the fused program — it is what the CRF decoded
                    pre = np.asarray(feats.get("dc_chroma", feats["chroma"]))[:, :t_ch]
                    if "crf_path" in feats:
                        pre_path = (np.asarray(feats["crf_path"])[:t_ch], np.asarray(feats["crf_conf"])[:t_ch])
                chroma, chroma_times, chords = extract_chords_deep(
                    y_harm,
                    sr,
                    min_segment_sec=s.MIN_SEGMENT_SEC,
                    beat_times=raw_beats if raw_beats.size else None,
                    precomputed_chroma=pre,
                    precomputed_path=pre_path,
                    device=device,
                )
            else:
                from ..chords.extract import extract_chords

                chroma, chroma_times, chords = extract_chords(
                    y_harm,
                    sr,
                    vocab=s.CHORD_VOCAB,
                    switch_penalty=s.SWITCH_PENALTY,
                    min_segment_sec=s.MIN_SEGMENT_SEC,
                    beat_times=raw_beats if raw_beats.size else None,
                    backend=backend,
                    device=device,
                )
        except Exception as exc:
            errors.append(f"chords: {exc}")
            _LOG.warning("chord extraction failed: %s", exc)

    # ---- 9. key + respelling + 7th simplification (pipeline.py:1776-1816) ----
    key_sig = None
    use_flats = False
    with span("key", stages):
        try:
            from ..theory.chord_simplify import simplify_chord_segments
            from ..theory.key import estimate_key_from_chroma, estimate_key_from_events, spell_chord_label

            key_est = None
            if feats is not None and "key_probs" in feats:
                # trained key CNN ran inside the fused program; its 24-way
                # posterior is reranked by decoded-chord diatonic
                # compatibility (theory/key.py rescore_key_with_chords —
                # the chords are independently gated at >=0.9 overlap, and
                # relative keys tie on compatibility so the CNN still
                # resolves tonic-vs-relative)
                from ..models.key_cnn import key_prediction_to_label
                from ..theory.key import _make_estimate, rescore_key_with_chords
                from ..theory.vocabulary import NOTE_TO_PC

                probs = np.asarray(feats["key_probs"], dtype=np.float32)
                probs = rescore_key_with_chords(probs, chords)
                tonic, mode = key_prediction_to_label(probs).split()
                key_est = _make_estimate(NOTE_TO_PC[tonic], mode, float(probs.max()))
            if key_est is None and chroma is not None:
                key_est = estimate_key_from_chroma(np.asarray(chroma))
            if key_est is None and base_events:
                key_est = estimate_key_from_events(base_events)
            if key_est is not None:
                key_sig = key_est.to_schema()
                use_flats = key_est.use_flats
            chords = simplify_chord_segments(
                chords,
                chroma=chroma,
                times=np.asarray(chroma_times) if chroma_times is not None else None,
                min_confidence=0.02,
                min_duration=1.0,
                seventh_ratio=0.5,
            )
            if key_est is not None:
                chords = [
                    ChordSegment(
                        start=c.start, end=c.end,
                        label=spell_chord_label(c.label, use_flats), confidence=c.confidence,
                    )
                    for c in chords
                ]
        except Exception as exc:
            errors.append(f"key: {exc}")

    # ---- 10. mode switch (pipeline.py:1824-1909) ----
    from .modes import ModeResult, run_accompaniment_mode, run_guitar_mode

    mode = s.TRANSCRIPTION_MODE
    mode_result = ModeResult(note_events=base_events, backend=base_backend)
    with span("mode", stages):
        try:
            if mode == "guitar":
                pre_content = None
                if (
                    feats is not None
                    and "content_metrics" in feats
                    and abs(s.CONTENT_ANALYSIS_WINDOW_SEC - 3.0) < 1e-6
                    and abs(s.CONTENT_ANALYSIS_HOP_SEC - 1.5) < 1e-6
                ):
                    starts = np.asarray(feats["content_starts"])
                    metrics = np.asarray(feats["content_metrics"])
                    keep = starts + sr // 2 <= true_len  # windows inside the true song
                    pre_content = (starts[keep], metrics[keep])
                strum_env = None
                if y_native is None and feats is not None and "strum_envelope" in feats:
                    strum_env = np.asarray(feats["strum_envelope"], dtype=np.float32)
                mode_result = run_guitar_mode(
                    y_harm, sr, chords, beat_times, tempo_bpm,
                    base_note_events=base_events, use_flats=use_flats,
                    window_sec=s.CONTENT_ANALYSIS_WINDOW_SEC, hop_sec=s.CONTENT_ANALYSIS_HOP_SEC,
                    precomputed_content=pre_content,
                    strum_envelope=strum_env,
                    # chordal segments detect strums on the native-rate
                    # audio (same full-band reasoning as accompaniment)
                    y_strum=y_native,
                    device=device,
                )
            elif mode == "accompaniment":
                from ..theory.chord_simplify import simplify_chords_for_accompaniment

                acc_chords = simplify_chords_for_accompaniment(chords)
                if y_native is not None:
                    # full-band strum detection at the native rate (the
                    # reference detects on the decode-rate stem,
                    # pipeline.py:1884-1893); its envelope is computed on
                    # ``device`` where that is the card, else on the host
                    y_strum, sr_strum, strum_env = y_native[0], y_native[1], None
                else:
                    # batch path: no native-rate copy is kept; reuse the
                    # fused program's 22.05 kHz envelope
                    y_strum, sr_strum = y_harm, sr
                    strum_env = None
                    if feats is not None and "strum_envelope" in feats:
                        strum_env = np.asarray(feats["strum_envelope"], dtype=np.float32)[
                            : true_len // 512 + 1
                        ]
                mode_result = run_accompaniment_mode(
                    y_strum, sr_strum, acc_chords, beat_times, tempo_bpm, use_flats=use_flats,
                    strum_envelope=strum_env, time_signature=time_sig, device=device,
                )
            else:  # notes
                from ..theory.postprocess import postprocess_note_events

                mode_result = ModeResult(
                    note_events=postprocess_note_events(base_events, chords, key_sig, settings=s),
                    backend=base_backend,
                )
        except Exception as exc:
            errors.append(f"mode({mode}): {exc}")
            _LOG.warning("mode %s failed: %s; using raw events", mode, exc)

    note_events = mode_result.note_events
    if offset:
        note_events = [
            NoteEvent(e.start_time_s - offset, e.end_time_s - offset, e.pitch_midi, e.velocity, e.amplitude)
            for e in note_events
        ]
        chords = [
            ChordSegment(start=c.start - offset, end=c.end - offset, label=c.label, confidence=c.confidence)
            for c in chords
        ]
        mode_result.strum_onsets = [t - offset for t in mode_result.strum_onsets]

    # ---- 11. quantize (pipeline.py:1916-1927) ----
    score = mode_result.score_override
    pickup_quarters = mode_result.pickup_quarters
    tab_positions = mode_result.tab_positions
    with span("quantize", stages):
        if score is None:
            try:
                from ..theory.quantize import quantize_note_events_to_score

                quant = quantize_note_events_to_score(
                    note_events,
                    tempo_bpm=tempo_bpm,
                    beat_times=norm_beats,
                    time_signature=time_sig,
                    guitar_tuning=s.GUITAR_TUNING,
                )
                score = quant.score
                pickup_quarters = quant.pickup_quarters
                tab_positions = quant.tab_positions
                if key_sig is None:
                    key_sig = quant.key_signature
            except Exception as exc:
                errors.append(f"quantize: {exc}")
                _LOG.warning("quantization failed: %s", exc)

    # ---- 12. debug artifacts (pipeline.py:1929-1991) ----
    # what drove the beat tracker (reference beat_source semantics): real
    # separation wires the drums stem (behind the on-device RMS gate with
    # mix-percussive fallback), the weight-free fallback uses the HPSS
    # percussive component, otherwise the mix itself
    if stem_source == "hpss_harmonic":
        beat_source_name = "hpss_percussive"
    elif stem_source == "mix":
        beat_source_name = "mix"
    else:
        beat_source_name = "drums"
    with span("artifacts", stages):
        _write_json(
            out / "beat_times.json",
            {
                "tempo_bpm": float(tempo_bpm),
                "beat_times": [float(b) for b in (norm_beats if norm_beats is not None else [])],
                "raw_beat_times": [float(b) for b in raw_beats],
                "downbeat_times": [float(b) for b in downbeats],
                "time_signature": time_sig,
                "offset": float(offset),
                "stem_source": stem_source,
                "errors": errors,
                # reference field names (reference beat_times.json schema:
                # tempo_raw_bpm, beat_times_s, beat_times_raw_s,
                # beat_offset_s, beat_source, transcription_source,
                # transcription_mode, demucs_enabled, demucs_error) so
                # tooling written against the reference artifact reads ours
                "tempo_raw_bpm": float(tempo_raw_bpm),
                "beat_times_s": [float(b) for b in (norm_beats if norm_beats is not None else [])],
                "beat_times_raw_s": [float(b) for b in (beat_times if beat_times is not None else [])],
                "beat_offset_s": float(offset),
                "beat_source": beat_source_name,
                "transcription_source": stem_source,
                "transcription_mode": mode,
                "demucs_enabled": bool(s.ENABLE_DEMUCS),
                "demucs_error": next((e for e in errors if e.startswith("separation")), None),
            },
        )
        _write_json(
            out / "chords.json",
            [{"start": c.start, "end": c.end, "label": c.label, "confidence": c.confidence} for c in chords],
        )
        if mode_result.content_segments:
            _write_json(
                out / "content_segments.json",
                [
                    {
                        "start": cs.start_time_s,
                        "end": cs.end_time_s,
                        "type": cs.content_type,
                        "confidence": cs.confidence,
                        "metrics": cs.metrics,
                    }
                    for cs in mode_result.content_segments
                ],
            )
        if mode_result.strum_onsets:
            _write_json(out / "strum_onsets.json", mode_result.strum_onsets)
        if mode_result.chosen_shapes:
            _write_json(out / "chosen_shapes.json", mode_result.chosen_shapes)
        if tab_positions is not None and score is not None:
            # offline tablature artifact: per measure, per score item, the
            # chosen [string, fret] pairs (string 1 = highest). The same
            # data feeds the MusicXML TAB part (reference
            # musicxml/export.py:150-291); persisting it lets the bundled
            # frontend draw the 6-line tab with zero network access.
            from ..tab.fretboard import get_tuning as _get_tuning

            _write_json(
                out / "tab_positions.json",
                {
                    "tuning": [int(p) for p in _get_tuning(s.GUITAR_TUNING)],
                    "measures": [
                        [[[int(st), int(fr)] for st, fr in item] for item in meas]
                        for meas in tab_positions
                    ],
                },
            )
        try:
            from ..score.csvout import save_note_events_csv

            save_note_events_csv(note_events, out / "note_events.csv")
        except Exception as exc:
            errors.append(f"csv: {exc}")

    # ---- 13. exports (pipeline.py:1996-2030) ----
    with span("export", stages):
        if score is not None:
            with span("export/musicxml"):
                try:
                    from ..score.musicxml import export_musicxml
                    from ..tab.fretboard import get_tuning

                    export_musicxml(
                        out / "result.musicxml",
                        score,
                        tempo_bpm=tempo_bpm,
                        time_signature=time_sig,
                        key_signature_fifths=key_sig.fifths if key_sig else None,
                        title=job_id,
                        instrument="guitar",
                        chords=chords,
                        beat_times=norm_beats,
                        pickup_quarters=pickup_quarters,
                        slash_notation=(mode == "accompaniment"),
                        tab_positions=tab_positions,
                        tab_tuning=get_tuning(s.GUITAR_TUNING),
                        midi_path=out / "transcription.mid",
                    )
                except Exception as exc:
                    errors.append(f"musicxml: {exc}")
                    _LOG.warning("musicxml export failed: %s", exc)
        with span("export/lilypond"):
            try:
                from ..score.lilypond import build_lilypond_score, render_lilypond_pdf

                ly = build_lilypond_score(
                    chords, tempo_bpm=tempo_bpm, beat_times=norm_beats, title=job_id, key_signature=key_sig
                )
                (out / "score.ly").write_text(ly)
                if not render_lilypond_pdf(out / "score.ly", out / "score.pdf"):
                    # no lilypond binary: the dependency-free engraver keeps the
                    # artifact contract's score.pdf (reference golden jobs ship
                    # one; engraving/lilypond.py:318-336)
                    from ..score.pdfwriter import render_pdf_lead_sheet

                    render_pdf_lead_sheet(
                        out / "score.pdf", chords, tempo_bpm=tempo_bpm,
                        beat_times=norm_beats, title=job_id, key_signature=key_sig,
                    )
            except Exception as exc:
                errors.append(f"lilypond: {exc}")

    with span("profile_json"):
        _write_json(out / "profile.json", {k: round(v, 4) for k, v in stages.items()})

    return JobResult(
        job_id=job_id,
        tempo_bpm=float(tempo_bpm),
        time_signature=time_sig,
        key_signature=key_sig,
        chords=chords,
        transcription_backend=mode_result.backend,
        transcription_error="; ".join(errors) if errors else None,
        score=score,
    )
