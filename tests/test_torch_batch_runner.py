"""The port's batch runner against the JAX package's, and against its own single-song path.

- ``batched_fused_analysis`` on three synthetic 2 s songs with unequal true
  lengths (``PAD_SECONDS_BUCKET=2``, ``HTDEMUCS_WEIGHTS=off``: the HPSS
  fallback) against the JAX ``batched_fused_analysis`` on a one-device mesh:
  discrete outputs equal, floats within rtol/atol 1e-4, f16 outputs within
  2 f16 ulps.
- Each row of that batch against the port's ``fused_analysis`` on the row
  (the batched stages must not change a row's answer), and chunks of one
  song against one chunk of all; a chunk of 3 with both chord backends
  makes one salience envelope and one constant-switch call, and its rows
  equal the songs' own analyses.
- ``separate_program`` on two 6 s rows with the checkpoint and two shifts
  (three windows per song at each of both shift offsets) against the 1-D call per
  row, within 1e-5 of each stem's peak.
- ``transcribe_batch`` end to end on two 5 s crops of the 22.05 kHz held-out
  clips against the JAX ``transcribe_batch`` in guitar mode (``result.json``
  equal, chord confidences and the key score within rtol 1e-5); one
  wrap-padded song against the port's ``run_pipeline`` (key and chords); and
  a batch of one 22.05 kHz song against the single-song tail run on its own
  features without the native audio (artifacts byte-equal).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.runtime.fused import F16_OUTPUTS
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

SR = 22050
HELDOUT_DIR = Path(__file__).parent / "data" / "heldout"
DISCRETE = ("crf_path", "dbn_phases", "dbn_intervals", "content_starts", "chord_path")
LENS = np.array([2 * SR, 2 * SR - SR // 2, SR + SR // 4], np.int32)
# the weight-free separation fallback, as the JAX batch tests run it
BATCH = Settings(PAD_SECONDS_BUCKET=2.0)


@pytest.fixture(scope="module", autouse=True)
def htdemucs_off():
    mp = pytest.MonkeyPatch()
    mp.setenv("HTDEMUCS_WEIGHTS", "off")
    yield
    mp.undo()


@pytest.fixture
def jax_env(monkeypatch):
    """Set the JAX package's settings through the environment; restored after the test."""
    from audiotabs_tpu.config import reload_settings

    def set_env(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        reload_settings()

    yield set_env
    monkeypatch.undo()
    reload_settings()


def _songs(seconds: float = 2.0) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * SR)) / SR
    rows = []
    for i, root in enumerate((48, 53, 55)):
        y = sum(0.25 * np.sin(2 * np.pi * 440 * 2 ** ((p - 69) / 12) * t) for p in (root, root + 4, root + 7))
        for k in range(0, len(y) - 300, SR // 2):
            y[k : k + 300] += 0.2 * rng.standard_normal(300)
        rows.append(y.astype(np.float32))
    return np.stack(rows)


@pytest.fixture(scope="module")
def port_batch():
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis

    batch = _songs()
    return batch, batched_fused_analysis(batch, SR, LENS, device="cpu", settings=BATCH)


def _compare(ref: dict, got: dict, float_tol: dict, what: str):
    assert set(got) == set(ref), what
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert b.dtype == a.dtype and b.shape == a.shape, (what, k, b.dtype, a.dtype, b.shape, a.shape)
        if k in DISCRETE or a.dtype == np.bool_:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")
        elif k in F16_OUTPUTS:
            np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32), rtol=2**-9, atol=2**-13, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(b, a, err_msg=f"{what} {k}", **float_tol)


def test_batched_fused_analysis_matches_jax(port_batch, jax_env):
    from audiotabs_tpu.parallel.mesh import make_mesh
    from audiotabs_tpu.runtime.batch_runner import batched_fused_analysis as jax_batched

    batch, got = port_batch
    jax_env(PAD_SECONDS_BUCKET="2", HTDEMUCS_WEIGHTS="off")
    ref = jax_batched(batch, SR, mesh=make_mesh((1,), ("data",)), true_lens=LENS)
    assert got["chord_emissions"].shape[0] == 3 and "beat_from_drums" not in got
    _compare(ref, got, dict(rtol=1e-4, atol=1e-4), "port vs jax")


def test_batch_rows_match_single_songs(port_batch):
    from audiotabs_tpu_torch.runtime.fused import fused_analysis
    from audiotabs_tpu_torch.runtime.pipeline import features_to_host

    batch, got = port_batch
    for b in range(len(batch)):
        with torch.inference_mode():
            single = features_to_host(fused_analysis(torch.from_numpy(batch[b]), SR, separate=True, chord_backend="deep", true_len=int(LENS[b])))
        _compare(single, {k: v[b] for k, v in got.items()}, dict(rtol=1e-4, atol=1e-6), f"row {b}")
    # the masks are per row: past each song's end its emissions are uniform
    for b, n in enumerate(LENS):
        tail = got["chord_emissions"][b][:, int(n) // (SR // 10) + 1 :]
        np.testing.assert_allclose(tail, 1.0 / tail.shape[0])


def test_chunk_of_both_backends_matches_single_songs_with_one_launch_of_each(monkeypatch):
    """A chunk of 3 songs with ``chord_backend="both"``: one salience
    envelope call on [3, 88, T] and one constant-switch decode on
    [3, 49, t_ch] for the chunk (spies on the wrappers), and every row equal
    to ``fused_analysis`` of the song alone: the template and CRF paths
    exactly, the rest at the tolerances of test_batch_rows_match_single_songs."""
    from audiotabs_tpu_torch.models import basicpitch
    from audiotabs_tpu_torch.runtime import fused
    from audiotabs_tpu_torch.runtime.pipeline import features_to_host

    calls = []
    for module, name in ((basicpitch, "salience_envelope"), (fused, "viterbi_constant_switch")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda x, *a, fn=fn, name=name: calls.append((name, tuple(x.shape))) or fn(x, *a))
    batch = torch.from_numpy(_songs())
    with torch.inference_mode():
        got = features_to_host(fused.fused_analysis_batch(batch, SR, separate=True, chord_backend="both", true_lens=LENS))
    n_frames = got["amt_frame"].shape[1]
    t_ch = got["chord_emissions"].shape[-1]
    assert calls == [("salience_envelope", (3, 88, n_frames)), ("viterbi_constant_switch", (3, 49, t_ch))]
    assert {"chord_path", "chord_conf", "crf_path", "crf_conf"} <= set(got)
    calls.clear()
    for b in range(len(batch)):
        with torch.inference_mode():
            single = features_to_host(fused.fused_analysis(batch[b], SR, separate=True, chord_backend="both", true_len=int(LENS[b])))
        _compare(single, {k: v[b] for k, v in got.items()}, dict(rtol=1e-4, atol=1e-6), f"row {b}")
    assert calls == [("salience_envelope", (1, 88, n_frames)), ("viterbi_constant_switch", (1, 49, t_ch))] * len(batch)


def test_chunked_batch_matches_one_chunk(port_batch):
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis_stream

    batch, one = port_batch
    chunks = list(batched_fused_analysis_stream(batch, SR, LENS, device="cpu", settings=dataclasses.replace(BATCH, BATCH_SONGS_PER_DEVICE=1)))
    assert [a for a, _ in chunks] == [0, 1, 2]
    assert all(next(iter(h.values())).shape[0] == 1 for _, h in chunks)
    chunked = {k: np.concatenate([h[k] for _, h in chunks]) for k in chunks[0][1]}
    _compare(one, chunked, dict(rtol=1e-4, atol=1e-6), "chunked")


def test_batched_separation_matches_rows(monkeypatch):
    from audiotabs_tpu_torch.models import htdemucs

    monkeypatch.delenv("HTDEMUCS_WEIGHTS")
    params = htdemucs.load_params()
    assert params is not None, "the checked-in htdemucs checkpoint is missing"
    cfg = htdemucs.program_config(params, "htdemucs_6s", Settings().stem_priority())
    model = htdemucs.load_model(torch.device("cpu"))
    y = torch.from_numpy(_songs(6.0)[:2])
    assert len(htdemucs._segment_windows(2 * y.shape[1], cfg["seg"], cfg["stride"])) == 3
    with torch.inference_mode():
        stems = htdemucs.separate_program(model, y, SR, cfg["seg"], cfg["stride"], 2)
        rows = [htdemucs.separate_program(model, y[b], SR, cfg["seg"], cfg["stride"], 2) for b in range(2)]
    assert stems.shape == (2, cfg["n_sources"], y.shape[1])
    for b in range(2):
        err = (stems[b] - rows[b]).abs().amax(dim=-1) / rows[b].abs().amax(dim=-1)
        assert float(err.max()) < 1e-5, err


def assert_same_result(got: dict, ref: dict, ignore: tuple[str, ...] = ()) -> None:
    """Two parsed ``result.json`` equal, but for the chord confidences and the
    key score: float32 posteriors of two analyses (XLA against torch), rtol 1e-5."""
    def split(r):
        r = json.loads(json.dumps({k: v for k, v in r.items() if k not in ignore}))
        conf = [c.pop("confidence") for c in r["chords"]]
        score = r["key_signature"].pop("score") if r["key_signature"] else None
        return r, conf, score

    (g, g_conf, g_score), (f, f_conf, f_score) = split(got), split(ref)
    assert g == f
    np.testing.assert_allclose(g_conf, f_conf, rtol=1e-5)
    assert (g_score is None) == (f_score is None)
    if g_score is not None:
        np.testing.assert_allclose(g_score, f_score, rtol=1e-5)


def _crop(name: str, dest: Path, seconds: float = 5.0) -> Path:
    from audiotabs_tpu.io.wav import read_wav, write_wav

    x, sr = read_wav(HELDOUT_DIR / name)
    assert sr == SR  # no resampling on either side
    path = dest / Path(name).name
    write_wav(path, x[3 * sr : 3 * sr + int(seconds * sr)], sr)
    return path


def test_transcribe_batch_matches_jax(tmp_path, jax_env):
    from audiotabs_tpu.parallel.mesh import make_mesh
    from audiotabs_tpu.runtime.batch_runner import transcribe_batch as jax_transcribe
    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch

    (tmp_path / "in").mkdir()
    paths = [_crop(n, tmp_path / "in") for n in ("heldout_picked_melody.wav", "heldout_fingerpick.wav")]
    got = transcribe_batch(paths, tmp_path / "port", device="cpu", settings=Settings(PAD_SECONDS_BUCKET=6.0), host_workers=2)
    jax_env(PAD_SECONDS_BUCKET="6", HTDEMUCS_WEIGHTS="off", TRANSCRIPTION_MODE="guitar")
    ref = jax_transcribe(paths, tmp_path / "jax", mesh=make_mesh((1,), ("data",)), host_workers=2)
    assert [r.job_id for r in got] == [r.job_id for r in ref] == ["heldout_picked_melody", "heldout_fingerpick"]
    for r in got:
        assert r.transcription_error is None and r.score is not None and r.chords
        ref_json = json.loads((tmp_path / "jax" / "jobs" / r.job_id / "out" / "result.json").read_text())
        got_json = json.loads((tmp_path / "port" / "jobs" / r.job_id / "out" / "result.json").read_text())
        assert_same_result(got_json, ref_json)
        bt = json.loads((tmp_path / "port" / "jobs" / r.job_id / "out" / "beat_times.json").read_text())
        assert bt["stem_source"] == "hpss_harmonic"


def test_batch_vs_single_parity_wrap_padded(tmp_path):
    """One song of 3 s wrap-padded to the 4 s bucket: the batch path forwards
    its true length, so its key and chords are the single-song path's."""
    from audiotabs_tpu.io import write_wav
    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    y = np.zeros(3 * SR, dtype=np.float32)
    rng = np.random.default_rng(7)
    for k, p in enumerate([55, 59, 62, 67, 62, 59] * 2):
        s0 = int(k * 0.25 * SR)
        seg = np.arange(int(0.25 * SR)) / SR
        f = 440.0 * 2 ** ((p - 69) / 12)
        y[s0 : s0 + len(seg)] += (0.35 * np.sin(2 * np.pi * f * seg)).astype(np.float32)
        y[s0 : s0 + 300] += 0.2 * rng.standard_normal(300).astype(np.float32)
    wav = tmp_path / "gmaj.wav"
    write_wav(wav, y, SR)

    (batch_result,) = transcribe_batch([wav], tmp_path / "batch", device="cpu", settings=BATCH)
    single_result = run_pipeline(tmp_path / "jobs" / "single", wav, device="cpu", settings=BATCH)
    assert batch_result.key_signature is not None
    assert batch_result.key_signature == single_result.key_signature
    assert [c.label for c in batch_result.chords] == [c.label for c in single_result.chords]


def test_batch_tail_is_the_single_song_tail_without_native_audio(tmp_path, monkeypatch):
    """At 22.05 kHz both decode orders give the same signal, so a batch of one
    song writes what ``run_pipeline_from_features`` writes from the
    single-song path's own features: the batch's notes differ from the single
    song's only because its tail picks strums off the fused envelope, not off
    the native-rate audio."""
    from audiotabs_tpu_torch.runtime import pipeline
    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch

    (tmp_path / "in").mkdir()
    clip = _crop("heldout_fingerpick.wav", tmp_path / "in")
    s = Settings(PAD_SECONDS_BUCKET=6.0)
    seen = []
    to_host = pipeline.features_to_host
    monkeypatch.setattr(pipeline, "features_to_host", lambda o: seen.append(to_host(o)) or seen[-1])
    pipeline.run_pipeline(tmp_path / "single", clip, device="cpu", settings=s)
    (feats,) = seen
    n = 5 * SR
    pipeline.run_pipeline_from_features(feats, n, SR, tmp_path / "tail" / "jobs" / clip.stem, settings=s)
    transcribe_batch([clip], tmp_path / "batch", device="cpu", settings=s, host_workers=1)
    tail_out, batch_out = tmp_path / "tail" / "jobs" / clip.stem / "out", tmp_path / "batch" / "jobs" / clip.stem / "out"
    names = sorted(p.name for p in batch_out.iterdir() if p.name != "profile.json")
    assert names == sorted(p.name for p in tail_out.iterdir() if p.name != "profile.json")
    for name in names:
        assert (batch_out / name).read_bytes() == (tail_out / name).read_bytes(), name


def test_transcribe_batch_without_a_device_raises_when_no_gpu(monkeypatch, tmp_path):
    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe_batch([HELDOUT_DIR / "heldout_fingerpick.wav"], tmp_path)
    assert not (tmp_path / "jobs").exists()
