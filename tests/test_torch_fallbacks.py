"""The device fallbacks of the port's host tail against the JAX package's.

Each stage that the JAX pipeline recomputes on its device when the fused
analysis failed, or lacks what a setting asks for, has its counterpart in
the port, run here on the CPU: the same seeded or held-out audio through
the JAX function (its XLA median, as its own tests run it on the CPU) and
through the port's. Discrete outputs (chord labels and bounds, beat times,
content types, keys) are equal; float32 outputs agree within rtol 1e-5 (a
waveform or spectrum also within 1e-5 of its peak, where values cross
zero); note events are compared by pitch and by onset and offset frame.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

HELDOUT_DIR = Path(__file__).parent / "data" / "heldout"
SR = 22050
F32 = dict(rtol=1e-5)


def _clip(name: str, start: float = 3.0, seconds: float = 5.0) -> np.ndarray:
    """A crop of a held-out clip at 22.05 kHz, mono, peak-normalised."""
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize

    y, _, _ = decode_for_analysis(HELDOUT_DIR / name, SR)
    return peak_normalize(np.ascontiguousarray(y[int(start * SR) : int((start + seconds) * SR)]))


@pytest.fixture(scope="module")
def strums() -> np.ndarray:
    return _clip("heldout_strum_band.wav")


@pytest.fixture(scope="module")
def melody() -> np.ndarray:
    return _clip("heldout_picked_melody.wav")


def _assert_close(got, ref, rtol: float = 1e-5):
    """Within rtol, and within rtol of the reference's peak where values
    cross zero; a failure names the worst element, both values and how far
    past its tolerance it is."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    atol = rtol * float(np.abs(ref).max())
    ratio = np.abs(got - ref) / (atol + rtol * np.abs(ref))
    worst = np.unravel_index(int(np.argmax(ratio)), ratio.shape) if ratio.size else ()
    msg = (f"worst at {tuple(int(i) for i in worst)}: port {float(got[worst])!r}, jax {float(ref[worst])!r}, "
           f"{float(ratio[worst]):.3g} × its tolerance (rtol {rtol}, atol {atol:.3g})") if ratio.size else ""
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=msg)


def _same_segments(got: list, ref: list):
    assert [(s.start, s.end, s.label) for s in got] == [(s.start, s.end, s.label) for s in ref]
    np.testing.assert_allclose([s.confidence for s in got], [s.confidence for s in ref], **F32)


def _note_frames(events, fps: float) -> list[tuple[int, int, int]]:
    return [(e.pitch_midi, round(e.start_time_s * fps), round(e.end_time_s * fps)) for e in events]


def test_harmonic_matches_jax(strums):
    from audiotabs_tpu.ops.hpss import harmonic as jax_harmonic
    from audiotabs_tpu_torch.ops.hpss import harmonic

    _assert_close(harmonic(torch.from_numpy(strums)).numpy(), jax_harmonic(jnp.asarray(strums)))


def test_chroma_features_matches_jax(strums):
    from audiotabs_tpu.chords.extract import chroma_features as jax_chroma
    from audiotabs_tpu_torch.chords.extract import chroma_features

    chroma, energy = chroma_features(strums, SR, device="cpu")
    ref_chroma, ref_energy = jax_chroma(strums, SR)
    _assert_close(chroma.numpy(), ref_chroma)
    _assert_close(energy.numpy(), ref_energy)


@pytest.mark.parametrize("vocab", ["majmin", "majmin7", "majmin7plus"])
def test_extract_chords_template_matches_jax(strums, vocab):
    from audiotabs_tpu.chords.extract import extract_chords as jax_extract
    from audiotabs_tpu_torch.chords.extract import extract_chords

    beats = np.arange(0.25, 5.0, 0.5, dtype=np.float32)
    for bt in (None, beats):
        ref = jax_extract(strums, SR, vocab=vocab, beat_times=bt, backend="template")
        got = extract_chords(strums, SR, vocab=vocab, beat_times=bt, backend="template", device="cpu")
        _assert_close(got[0], ref[0])
        assert np.array_equal(got[1], ref[1]) and len(ref[2]) >= 2
        _same_segments(got[2], ref[2])


def test_extract_chords_with_deep_params_matches_jax(strums):
    """The template backend on DeepChroma's chroma (``deep_params``)."""
    from audiotabs_tpu.chords.extract import extract_chords as jax_extract
    from audiotabs_tpu_torch.chords.extract import extract_chords
    from audiotabs_tpu_torch.models.deepchroma import load_params

    params = load_params()
    ref = jax_extract(strums, SR, vocab="majmin7", deep_params=params, backend="template")
    got = extract_chords(strums, SR, vocab="majmin7", deep_params=params, backend="template", device="cpu")
    _assert_close(got[0], ref[0])
    _same_segments(got[2], ref[2])


@pytest.mark.parametrize("weights", ["deepchroma", "salience", "precomputed chroma"])
def test_extract_chords_deep_without_fused_features_matches_jax(strums, weights, monkeypatch):
    """The deep backend when the fused CRF path is missing: DeepChroma (its
    checkpoint), the salience chroma (``DEEPCHROMA_WEIGHTS=off``) or a given
    chroma, then the silence gate and the CRF decode."""
    from audiotabs_tpu.chords.extract import chroma_features as jax_chroma
    from audiotabs_tpu.chords.extract import extract_chords_deep as jax_deep
    from audiotabs_tpu_torch.chords.extract import extract_chords, extract_chords_deep

    if weights != "deepchroma":
        monkeypatch.setenv("DEEPCHROMA_WEIGHTS", "off")
    pre = np.asarray(jax_chroma(strums, SR)[0]) if weights == "precomputed chroma" else None
    beats = np.arange(0.25, 5.0, 0.5, dtype=np.float32)
    ref = jax_deep(strums, SR, beat_times=beats, precomputed_chroma=pre)
    got = extract_chords_deep(strums, SR, beat_times=beats, precomputed_chroma=pre, device="cpu")
    _assert_close(got[0], ref[0])
    assert len(ref[2]) >= 2
    _same_segments(got[2], ref[2])
    if weights == "deepchroma":
        # extract_chords' deep backend is this function
        _same_segments(extract_chords(strums, SR, beat_times=beats, backend="deep", device="cpu")[2], ref[2])


def test_deep_chroma_apply_matches_jax(strums):
    from audiotabs_tpu.models.deepchroma import deep_chroma_apply as jax_apply
    from audiotabs_tpu_torch.models.deepchroma import deep_chroma_apply, load_params

    params = load_params()
    got, ref = deep_chroma_apply(params, strums, SR, device="cpu"), jax_apply(params, strums, SR)
    assert got.shape == ref.shape == (12, 51)
    _assert_close(got, ref)


def test_analyze_audio_characteristics_matches_jax(strums, tmp_path):
    """The calibration statistics of a failed analysis, and their on-disk
    cache (the JAX key, under ``<cache_dir>/audio_analysis``)."""
    from audiotabs_tpu.analysis.audio_quality import analyze_audio_characteristics as jax_chars
    from audiotabs_tpu_torch.analysis.audio_quality import analyze_audio_characteristics
    from audiotabs_tpu_torch.io.wav import write_wav

    wav = tmp_path / "audio_mono_44k.wav"
    write_wav(wav, strums, SR)
    ref = jax_chars(wav, cache_dir=tmp_path / "jax", audio=strums, audio_sr=SR)
    got = analyze_audio_characteristics(wav, cache_dir=tmp_path / "port", audio=strums, audio_sr=SR, device="cpu")
    assert list(got) == list(ref)
    np.testing.assert_allclose(list(got.values()), list(ref.values()), **F32)
    assert [p.name for p in (tmp_path / "port" / "audio_analysis").iterdir()] == [p.name for p in (tmp_path / "jax" / "audio_analysis").iterdir()]
    assert analyze_audio_characteristics(wav, cache_dir=tmp_path / "port", device="cpu") == got  # read back from the cache
    # from the file at 22.05 kHz, and without a cache
    np.testing.assert_allclose(list(analyze_audio_characteristics(wav, device="cpu").values()), list(jax_chars(wav).values()), **F32)


def test_dbn_beat_track_matches_jax(strums):
    """The beat fallback: the BLSTM ensemble's activation, then the DBN decode."""
    from audiotabs_tpu.decode.dbn_beats import dbn_beat_track as jax_track
    from audiotabs_tpu.models.beat_rnn import beat_activation as jax_activation
    from audiotabs_tpu_torch.decode.dbn_beats import dbn_beat_track
    from audiotabs_tpu_torch.models.beat_rnn import beat_activation
    from audiotabs_tpu_torch.runtime.fused import load_models

    act_ref = np.asarray(jax_activation(jnp.asarray(strums), SR, 100))
    act = beat_activation(torch.from_numpy(strums), SR, load_models(torch.device("cpu")).beat, 100).detach().numpy()
    _assert_close(act, act_ref)
    ref = jax_track(act_ref, fps=100)
    assert ref.size >= 4
    for a in (act_ref, torch.from_numpy(act_ref.copy())):
        got = dbn_beat_track(a, fps=100, device="cpu")
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(dbn_beat_track(act, fps=100, device="cpu"), jax_track(act, fps=100))
    assert dbn_beat_track(np.zeros(1, np.float32), device="cpu").size == 0


@pytest.mark.parametrize("weights", ["cnn", "salience"])
def test_transcribe_polyphonic_matches_jax(strums, weights, monkeypatch):
    """Basic Pitch on the whole signal in float32 (the CNN of the checkpoint,
    or the salience with ``BASICPITCH_WEIGHTS=off``): notes by pitch and
    onset and offset frame."""
    from audiotabs_tpu.models.basicpitch import transcribe_polyphonic as jax_transcribe
    from audiotabs_tpu_torch.models.basicpitch import HOP, transcribe_polyphonic

    if weights == "salience":
        monkeypatch.setenv("BASICPITCH_WEIGHTS", "off")
    ref = jax_transcribe(strums, SR, onset_threshold=0.45, frame_threshold=0.3)
    got = transcribe_polyphonic(strums, SR, onset_threshold=0.45, frame_threshold=0.3, device="cpu")
    assert len(ref) > 5 and _note_frames(got, SR / HOP) == _note_frames(ref, SR / HOP)
    np.testing.assert_allclose([e.amplitude for e in got], [e.amplitude for e in ref], **F32)


def test_chroma_from_note_events_matches_jax():
    from audiotabs_tpu.models.basicpitch import chroma_from_note_events as jax_chroma
    from audiotabs_tpu_torch.models.basicpitch import chroma_from_note_events
    from test_torch_tail import _events

    jev, pev = _events(np.random.default_rng(4), 30)
    assert np.array_equal(chroma_from_note_events(pev, 90, 10.0), jax_chroma(jev, 90, 10.0))
    assert not chroma_from_note_events([], 5, 10.0).any()


def test_transcribe_melody_matches_jax(melody):
    from audiotabs_tpu.decode.melody import notes_from_f0 as jax_notes
    from audiotabs_tpu.decode.melody import transcribe_melody as jax_melody
    from audiotabs_tpu_torch.decode.melody import notes_from_f0, transcribe_melody

    ref = jax_melody(melody, SR)
    got = transcribe_melody(melody, SR, device="cpu")
    assert len(ref) > 5 and _note_frames(got, SR / 256) == _note_frames(ref, SR / 256)
    np.testing.assert_allclose([e.amplitude for e in got], [e.amplitude for e in ref], **F32)
    rng = np.random.default_rng(5)
    f0 = 220.0 * 2.0 ** (np.repeat(rng.integers(0, 12, 20), 9) / 12.0 + rng.normal(0.0, 0.01, 180))
    voiced = rng.random(180) > 0.1
    amps = rng.random(180).astype(np.float32)
    assert [vars(e) for e in notes_from_f0(f0, voiced, 0.01, amplitudes=amps)] == [vars(e) for e in jax_notes(f0, voiced, 0.01, amplitudes=amps)]


def test_estimate_key_cnn_matches_jax(strums):
    from audiotabs_tpu.models.key_cnn import estimate_key_cnn as jax_key
    from audiotabs_tpu_torch.models.key_cnn import estimate_key_cnn

    ref, got = jax_key(strums, SR), estimate_key_cnn(strums, SR, device="cpu")
    assert (got.tonic_pc, got.mode, got.use_flats) == (ref.tonic_pc, ref.mode, ref.use_flats)
    np.testing.assert_allclose(got.score, ref.score, **F32)


def test_chroma_cqt_matches_jax(strums):
    from audiotabs_tpu.ops.chroma import chroma_cqt as jax_chroma_cqt
    from audiotabs_tpu.ops.chroma import chroma_from_cqt as jax_fold
    from audiotabs_tpu_torch.ops.chroma import chroma_cqt, chroma_from_cqt

    _assert_close(chroma_cqt(torch.from_numpy(strums[: 2 * SR]), SR).numpy(), jax_chroma_cqt(jnp.asarray(strums[: 2 * SR]), SR))
    C = np.random.default_rng(6).random((2, 88, 7)).astype(np.float32)
    for bpo, norm in ((12, True), (12, False), (36, True)):
        _assert_close(chroma_from_cqt(torch.from_numpy(C[:, : 87 if bpo == 36 else 88]), bpo, norm).numpy(),
                      jax_fold(jnp.asarray(C[:, : 87 if bpo == 36 else 88]), bpo, norm), 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_note_events_matches_jax(seed):
    """Notes mode's chain, with the default thresholds and with others."""
    import dataclasses

    from audiotabs_tpu.config import Settings as JaxSettings
    from audiotabs_tpu.theory.postprocess import postprocess_note_events as jax_post
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.theory.postprocess import postprocess_note_events
    from test_torch_tail import _chords, _events, _same

    rng = np.random.default_rng(seed)
    jev, pev = _events(rng, 80)
    # octave and fifth doubles and near-unison re-detections for every pass to act on
    extra = [(e.start_time_s + 0.01, e.end_time_s, e.pitch_midi + 12, e.velocity, 0.5 * e.amplitude) for e in jev[::4]]
    extra += [(e.start_time_s + 0.02, e.end_time_s + 0.05, e.pitch_midi + 1, e.velocity, e.amplitude) for e in jev[1::5]]
    jev = sorted(jev + [type(jev[0])(*r) for r in extra], key=lambda e: e.start_time_s)
    pev = sorted(pev + [type(pev[0])(*r) for r in extra], key=lambda e: e.start_time_s)
    jc, pc = _chords(rng, 6)
    from audiotabs_tpu.theory.key import estimate_key_from_events as jax_key
    from audiotabs_tpu_torch.theory.key import estimate_key_from_events

    jkey, pkey = jax_key(jev).to_schema(), estimate_key_from_events(pev).to_schema()
    overrides = {} if seed == 0 else dict(HARMONIC_EVEN_THRESHOLD=0.9, TEMPORAL_CLUSTER_WINDOW_MS=120.0, DISSONANCE_CORRECTION_AGGRESSIVENESS=0.9)
    ref = jax_post(jev, jc, jkey, settings=dataclasses.replace(JaxSettings(), **overrides))
    got = postprocess_note_events(pev, pc, pkey, settings=dataclasses.replace(Settings(), **overrides))
    assert 0 < len(ref) < len(jev)
    _same(ref, got)


def test_constant_uploads_do_not_alias_the_cache():
    """On the CPU a constant's tensor is a copy: an in-place op on it leaves
    the cached numpy constant, and every later caller, as they were."""
    from audiotabs_tpu_torch.ops.cqt import cqt_kernel_bank
    from audiotabs_tpu_torch.ops.spectral import as_device, device_hann, hann_window

    like = torch.zeros(1)
    window = hann_window(64).copy()
    as_device(hann_window(64), like).add_(1.0)
    device_hann(64, torch.device("cpu")).mul_(1.0)  # the cached tensor itself is separate storage
    np.testing.assert_array_equal(hann_window(64), window)
    bank = cqt_kernel_bank(SR, n_bins=12)[0]
    assert not np.shares_memory(as_device(bank, like).numpy(), bank)
    assert not np.shares_memory(device_hann(64, torch.device("cpu")).numpy(), hann_window(64))


def _same(a, b, where: str) -> None:
    """Bit-equal, through tuples, lists, dicts, dataclasses and modules' state dicts."""
    import dataclasses

    if isinstance(a, torch.nn.Module):
        a, b = a.state_dict(), b.state_dict()
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        a, b = vars(a), vars(b)
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_cached_constants_survive_the_cpu_main_path(strums, tmp_path, monkeypatch):
    """Every ``lru_cache``d value the port's CPU main path (``run_pipeline``
    under the shipped settings on a 5 s crop, then ``chroma_features``)
    reads is bit-equal, after the run, to the same value built afresh: the
    window, the CQT, mel and log banks, the tempo transitions, the chord
    templates, the median networks, the htdemucs embeddings and resampling
    matrices, and the loaded nets' weights."""
    import importlib
    import pkgutil

    import audiotabs_tpu_torch
    from audiotabs_tpu_torch.chords.extract import chroma_features
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.decode.dbn_beats import _device_grid
    from audiotabs_tpu_torch.io.wav import write_wav
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    modules = [importlib.import_module(m.name) for m in pkgutil.walk_packages(audiotabs_tpu_torch.__path__, "audiotabs_tpu_torch.")]
    cached = {id(v): v for m in modules for v in vars(m).values()
              if callable(v) and hasattr(v, "cache_info") and getattr(v, "__module__", "").startswith("audiotabs_tpu_torch")}
    assert {"hann_window", "device_hann", "cqt_kernel_bank", "mel_filterbank", "_tempo_transition", "load_models"} <= {
        f.__name__ for f in cached.values()}
    calls = []

    def recorder(fn):
        def record(*args, **kwargs):
            calls.append((fn, args, kwargs))
            return fn(*args, **kwargs)
        return record

    for m in modules:  # every name a cached function is bound to, in every module
        for name, v in list(vars(m).items()):
            if id(v) in cached and callable(v) and hasattr(v, "cache_info"):
                monkeypatch.setattr(m, name, recorder(v))

    # the DBN's per-device grid is built from _tempo_transition at its first
    # call only, and an earlier test in this process may have made that call
    _device_grid.cache_clear()
    crop = tmp_path / "crop.wav"
    write_wav(crop, strums, SR)
    result = run_pipeline(tmp_path / "job", crop, device="cpu", settings=Settings(PAD_SECONDS_BUCKET=6.0))
    assert result.transcription_error is None
    chroma_features(strums, SR, device="cpu")
    monkeypatch.undo()

    seen = set()
    for fn, args, kwargs in calls:
        key = (fn.__qualname__, repr(args), repr(sorted(kwargs.items())))
        if key in seen:
            continue
        seen.add(key)
        _same(fn(*args, **kwargs), fn.__wrapped__(*args, **kwargs), f"{fn.__module__}.{key[0]}{key[1]}")
    assert {"hann_window", "cqt_kernel_bank", "_tempo_transition", "_device_grid", "load_models", "_model"} <= {k[0] for k in seen}
