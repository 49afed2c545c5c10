"""The trainers' data against the JAX package's, on the CPU.

Exact: the metrics, every synthetic generator (two seeds each), the
htdemucs clips, the rolls, targets and labels, the numpy augmentations and
the CRF's bigram transitions. The dataset functions, which pass through HPSS
and the feature front ends (the JAX package's XLA path; the port's plain
median on the CPU): targets and labels exact, features at rtol 1e-4 (atol
1e-6 of the feature peak, for entries that are float noise around zero).
Both packages' $TMPDIR dataset caches go to the test's directory, under
different names.
"""

import tempfile

import numpy as np
import pytest

import audiotabs_tpu.analysis.metrics as jm
import audiotabs_tpu.models.deepchroma as jdc
import audiotabs_tpu.train.basicpitch_train as jbpt
import audiotabs_tpu.train.beat_rnn_train as jbrt
import audiotabs_tpu.train.crf_chords_train as jcct
import audiotabs_tpu.train.deepchroma_train as jdct
import audiotabs_tpu.train.htdemucs_train as jhtt
import audiotabs_tpu.train.key_cnn_train as jkct
import audiotabs_tpu.train.synth as jsynth
from audiotabs_tpu_torch.analysis import metrics
from audiotabs_tpu_torch.models import deepchroma
from audiotabs_tpu_torch.train import basicpitch_train, beat_rnn_train, crf_chords_train, deepchroma_train, golden
from audiotabs_tpu_torch.train import htdemucs_train, key_cnn_train, synth
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _features_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))


def test_metrics_are_the_jax_ones():
    rng = np.random.default_rng(0)
    ref = np.sort(rng.uniform(0, 10, 20))
    for est in (ref + rng.normal(0, 0.04, 20), ref[::2], np.array([]), ref + 0.2):
        assert metrics.beat_f_measure(est, ref) == jm.beat_f_measure(est, ref)
    truth = [(0.1 * i, 0.1 * i + 0.3, 60 + i % 5) for i in range(12)]
    est = [(t0 + rng.normal(0, 0.03), p + (i % 7 == 0)) for i, (t0, _t1, p) in enumerate(truth)]
    assert metrics.note_f_measure(est, truth) == jm.note_f_measure(est, truth)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kwargs", [
    ("synth_beat_clip", {"duration_s": 4.0}),
    ("synth_note_clip", {"duration_s": 2.0}),
    ("synth_note_clip", {"duration_s": 2.0, "polyphony": 4}),
    ("synth_multitrack", {"duration_s": 1.0}),
    ("synth_multitrack", {"duration_s": 1.0, "n_sources": 6}),
    ("synth_chord_clip", {"duration_s": 4.0}),
    ("synth_guitar_voicing_clip", {"duration_s": 2.0}),
    ("synth_key_clip", {"duration_s": 4.0}),
])
def test_synth_generators_are_exact(name, kwargs, seed):
    assert synth.SYNTH_VERSION == jsynth.SYNTH_VERSION
    got = getattr(synth, name)(np.random.default_rng(seed), **kwargs)
    ref = getattr(jsynth, name)(np.random.default_rng(seed), **kwargs)
    _equal(got, ref)


def test_htdemucs_clips_and_si_sdr_are_exact():
    got = htdemucs_train.build_clips(2, 5, duration=0.5, n_sources=6)
    ref = jhtt.build_clips(2, 5, duration=0.5, n_sources=6)
    _equal(got, ref)
    m, s, _ = got
    assert htdemucs_train.si_sdr(s[0, 4], m[0]) == jhtt.si_sdr(s[0, 4], m[0])


def test_rolls_and_basicpitch_clips_are_exact():
    clips = basicpitch_train.build_clips(3, 7)
    _equal(clips, jbpt.build_clips(3, 7))
    n_frames = int(basicpitch_train.CLIP_S * 22050) // 256 + 1
    for _y, events in clips:
        _equal(basicpitch_train.rolls_from_events(events, n_frames), jbpt.rolls_from_events(events, n_frames))
    edge = [(0.0, 0.02, 21), (3.99, 5.0, 108), (1.0, 1.5, 20), (4.5, 5.0, 60)]
    _equal(basicpitch_train.rolls_from_events(edge, n_frames), jbpt.rolls_from_events(edge, n_frames))


def test_augmentations_targets_and_transitions_are_exact():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((6, 10, 120, 1)).astype(np.float32)
    Y = rng.integers(0, 24, 6).astype(np.int32)
    _equal(key_cnn_train.augment_batch(X, Y, np.random.default_rng(1)), jkct.augment_batch(X, Y, np.random.default_rng(1)))
    Xd = rng.standard_normal((6, 15 * 120)).astype(np.float32)
    Yd = (rng.uniform(size=(6, 12)) < 0.3).astype(np.float32)
    _equal(deepchroma_train.augment_batch(Xd, Yd, np.random.default_rng(2)), jdct.augment_batch(Xd, Yd, np.random.default_rng(2)))
    labels = [(0.0, 1.3, 7, "maj"), (1.3, 2.0, 9, "min"), (2.0, 3.1, 0, "maj7")]
    _equal(deepchroma_train.chroma_targets(labels, 40), jdct.chroma_targets(labels, 40))
    _equal(crf_chords_train._state_labels(labels, 40), jcct._state_labels(labels, 40))
    seqs = [rng.integers(0, 25, 30) for _ in range(3)]
    _equal(crf_chords_train._transitions_from_bigrams(seqs), jcct._transitions_from_bigrams(seqs))
    Xb, Yb = rng.standard_normal((2, 600, 4)).astype(np.float32), rng.uniform(size=(2, 600)).astype(np.float32)
    _equal(beat_rnn_train.windows(Xb, Yb), jbrt.windows(Xb, Yb))


def test_golden_corpus_is_absent_as_in_jax():
    from audiotabs_tpu.train.golden import golden_available

    assert golden.golden_available() is golden_available() is False
    assert golden.golden_available("beat_times.json") is False


def test_beat_dataset_matches_jax(tmp_path):
    X, Y, clips = beat_rnn_train.build_dataset(1, 10_004, duration=4.0, device="cpu")
    Xj, Yj, clips_j = jbrt.build_dataset(1, 10_004, duration=4.0)
    _equal(Y, Yj)
    _equal(clips, clips_j)
    _features_close(X, Xj)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and names[1].startswith("torch_beat_ds_")  # neither package reads the other's cache
    X2, Y2, _ = beat_rnn_train.build_dataset(1, 10_004, duration=4.0, device="cpu")
    _equal((X2, Y2), (X, Y))


def test_key_clips_match_jax():
    X, Y, audio = key_cnn_train.build_clips(1, 91_003, device="cpu")
    Xj, Yj, audio_j = jkct.build_clips(1, 91_003)
    _equal(Y, Yj)
    _features_close(X, Xj)
    for a, b in zip(audio, audio_j):
        _features_close(a, b)


def test_deepchroma_dataset_matches_jax():
    X, Y, clips, T = deepchroma_train.build_dataset(1, 51_002, device="cpu")
    Xj, Yj, clips_j, Tj = jdct.build_dataset(1, 51_002)
    assert T == Tj
    _equal(Y, Yj)
    _features_close(X, Xj)
    _equal([c[1] for c in clips], [c[1] for c in clips_j])


def test_crf_dataset_matches_jax():
    X, Y = crf_chords_train.build_dataset(1, 33_001, deepchroma.load_params(), device="cpu")
    Xj, Yj = jcct.build_dataset(1, 33_001, jdc.load_params())
    _equal(Y, Yj)
    for a, b in zip(X, Xj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)  # unit-norm rows
