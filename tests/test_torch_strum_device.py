"""The strum detector's batched envelope pass and its decision-margin guard.

``strum_flux_batch`` computes, for every segment of a song in one pass, the
median flux that ``_onset_strength_median_host`` gives for the segment's own
audio; here it runs on the CPU and is held within ``FLUX_DB`` of the host
envelope (rounding alone: another FFT, matmul and log10). The detector fed
that flux must give the host path's onsets byte for byte: where a deciding
comparison lies inside ``GUARD_DB`` it recomputes the host envelope, which
``strum_fallbacks`` counts. The routes of ``run_guitar_mode`` and
``run_accompaniment_mode`` on a CUDA device are driven with the pass run on
the CPU in its place, and held against the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.accompaniment import strum
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture: two intra-op threads)
from test_torch_tail import NATIVE_SR, SR, _mode_inputs, _same, _strums

FLUX_DB = 1e-4  # the pass against the host envelope on the CPU (7.6e-6 dB measured)


def _song() -> np.ndarray:
    """12 s of strums at 44.1 kHz, with a near-silent stretch at 9.5-11 s."""
    y = _strums(NATIVE_SR, 12.0, 0.3, seed=3)
    y[int(9.5 * NATIVE_SR) : int(11 * NATIVE_SR)] *= 1e-5
    return y


# ragged segments: origins off the 512 grid, one shorter than n_fft, two
# that overlap by 1.5 s, one reaching the song's end, one near-silent
SEGMENTS = [
    (1000, 2500),
    (5001, 5001 + 3 * NATIVE_SR),
    (int(1.5 * NATIVE_SR) + 7, int(4.5 * NATIVE_SR) + 7),
    (int(2.5 * NATIVE_SR) + 333, int(8 * NATIVE_SR)),
    (int(9.6 * NATIVE_SR), int(10.9 * NATIVE_SR)),
    (int(10.2 * NATIVE_SR) + 1, 12 * NATIVE_SR),
]


@pytest.fixture(scope="module")
def batch():
    y = _song()
    return y, strum.strum_flux_batch(y, NATIVE_SR, SEGMENTS, "cpu")


@pytest.mark.parametrize("k", range(len(SEGMENTS)))
def test_flux_batch_matches_host_envelope(batch, k):
    y, fluxes = batch
    a, b = SEGMENTS[k]
    host = strum._onset_strength_median_host(y[a:b], NATIVE_SR)
    got = fluxes[k]
    assert got.dtype == host.dtype == np.float32 and got.shape == host.shape
    assert float(np.abs(got - host).max()) <= FLUX_DB
    assert np.array_equal(got[:3], np.zeros(3, np.float32))  # the left shift's zeros


def test_flux_batch_one_segment_is_the_batch_of_one(batch):
    """A segment's flux does not depend on the others in its pass."""
    y, fluxes = batch
    alone = strum.strum_flux_batch(y, NATIVE_SR, SEGMENTS[1:2], "cpu")[0]
    np.testing.assert_allclose(alone, fluxes[1], rtol=0, atol=FLUX_DB)


def test_flux_batch_fft_has_one_shape_whatever_the_segments(monkeypatch):
    """The FFT runs in blocks of ``_ROWS`` rows at every song length, so the
    card makes one cuFFT plan (PERF.md)."""
    shapes, rfft = set(), torch.fft.rfft

    def kept(x, *args, **kwargs):
        shapes.add(tuple(x.shape))
        return rfft(x, *args, **kwargs)

    monkeypatch.setattr(torch.fft, "rfft", kept)
    y = _song()
    for bounds in (SEGMENTS, SEGMENTS[:1], [(0, len(y))]):
        strum.strum_flux_batch(y, NATIVE_SR, bounds, "cpu")
    assert shapes == {(strum._ROWS, 2048)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_median128_is_numpys_even_count_median(seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 3, (257, 128)), 0.0).astype(np.float32)  # clamped differences: zeros and ties
    x[:, : 40 * seed] = 0.0
    x[::7] = np.round(x[::7])
    got = strum._median128(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == np.median(x, axis=1).tobytes()


@pytest.mark.parametrize(
    "sr,period,delta,interval,beats",
    [
        (NATIVE_SR, 0.25, 0.2, 0.12, True),
        (NATIVE_SR, 0.4, 0.2, 0.12, False),
        (NATIVE_SR, 0.3, 0.25, 0.2, True),
        (NATIVE_SR, 0.17, 0.25, 0.2, False),
        (SR, 0.3, 0.2, 0.12, True),
    ],
)
def test_detect_on_device_flux_gives_host_onsets(sr, period, delta, interval, beats):
    y = _strums(sr, 6.0, period, seed=int(period * 100))
    kw = dict(beat_times=np.arange(0.0, 6.0, 0.5) if beats else None, tempo_bpm=120.0, onset_delta=delta, min_interval_s=interval)
    flux = strum.strum_flux_batch(y, sr, [(0, len(y))], "cpu")[0]
    ref = strum.detect_strum_onsets(y, sr, **kw)
    got = strum.detect_strum_onsets(y, sr, flux=flux, **kw)
    assert len(ref) >= 4
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def _fallbacks() -> int:
    return tracing.counters().get("strum_fallbacks", 0)


def _detect_counting(y, sr, flux, **kw) -> tuple[np.ndarray, int]:
    before = _fallbacks()
    got = strum.detect_strum_onsets(y, sr, flux=flux, **kw)
    return got, _fallbacks() - before


@pytest.mark.parametrize("where", ["threshold", "local_max", "gate", "dedup"])
def test_flux_inside_the_guard_falls_back_to_host_onsets(where):
    """The host flux, which clears the guard, nudged so that one decision
    lies inside it: the segment falls back, and its onsets are the host
    path's. Strums every 0.25 s: zero flux between the onsets' spikes, 22
    peaks in 6 s, so the percentile gate applies."""
    sr = NATIVE_SR
    y = _strums(sr, 6.0, 0.25, seed=25)
    kw = dict(beat_times=None, tempo_bpm=120.0, onset_delta=0.2, min_interval_s=1.0 if where == "dedup" else 0.12)
    flux = strum._onset_strength_median_host(y, sr)
    n_env = len(y) // 512 + 1
    env = strum._normalize(flux[:n_env])
    frames = strum._peak_pick_np(env, 0.2, sr)
    top, g = float(flux[:n_env].max()), strum.GUARD_DB
    assert len(frames) == 22 and _detect_counting(y, sr, flux, **kw)[1] == 0
    f = flux.astype(np.float64)
    if where == "threshold":
        # a lone bump between two onsets, a local max just under its
        # threshold: x - (x + 16 zeros) / 17 - 0.2 = -0.2 g
        j = (frames[1] + frames[2]) // 2
        f[j] = (0.2 * top - 0.2 * g) * 17 / 16
    elif where == "local_max":
        i = frames[2]
        f[i - 1] = f[i] - 0.3 * g  # the onset's neighbour within the guard of it
    elif where == "gate":
        # ranks 8 and 9 of the 22 strengths bound the percentile (p = 8.4):
        # within the guard of each other, rank 8's margin is inside it too
        order = frames[np.argsort(env[frames], kind="stable")]
        f[order[9]] = f[order[8]] + 0.3 * g
    else:
        # two onsets inside the 1 s interval, equal within the guard
        f[frames[0]] = top
        f[frames[1]] = top - 0.5 * g
    got, fell = _detect_counting(y, sr, f.astype(np.float32), **kw)
    assert fell == 1
    ref = strum.detect_strum_onsets(y, sr, **kw)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_flux_outside_the_guard_is_kept():
    """The host flux itself as the device flux: no decision inside the guard,
    no fallback, and a segment counted."""
    y = _strums(NATIVE_SR, 6.0, 0.25, seed=25)
    flux = strum._onset_strength_median_host(y, NATIVE_SR)
    segments = tracing.counters().get("strum_segments", 0)
    got, fell = _detect_counting(y, NATIVE_SR, flux, tempo_bpm=120.0)
    assert (tracing.counters().get("strum_segments", 0), fell) == (segments + 1, 0)
    assert got.tobytes() == strum.detect_strum_onsets(y, NATIVE_SR, tempo_bpm=120.0).tobytes()


@pytest.mark.parametrize("seconds,peaks", [(4.5, 16), (5.75, 21), (4.75, 17)])
def test_gate_percentile_ranks_need_no_fallback(seconds, peaks):
    """Gated segments whose percentile lands on a rank (p = 0.4·(n − 1) whole
    for 16 and 21 peaks) or between two: the ranks that bound it are kept
    whatever the rounding, so the host flux itself does not fall back."""
    y = _strums(NATIVE_SR, seconds, 0.25, seed=25)
    flux = strum._onset_strength_median_host(y, NATIVE_SR)
    env = strum._normalize(flux[: len(y) // 512 + 1])
    assert len(strum._peak_pick_np(env, 0.2, NATIVE_SR)) == peaks
    got, fell = _detect_counting(y, NATIVE_SR, flux, tempo_bpm=120.0)
    assert fell == 0
    assert got.tobytes() == strum.detect_strum_onsets(y, NATIVE_SR, tempo_bpm=120.0).tobytes()


def test_silent_flux_falls_back():
    """An all-zero device flux says nothing of the host's: it falls back."""
    y = _strums(NATIVE_SR, 3.0, 0.25, seed=4)
    got, fell = _detect_counting(y, NATIVE_SR, np.zeros(len(y) // 512 + 1, np.float32), tempo_bpm=120.0)
    assert fell == 1
    assert got.tobytes() == strum.detect_strum_onsets(y, NATIVE_SR, tempo_bpm=120.0).tobytes()


@pytest.mark.parametrize("device", ["cpu", None])
def test_card_fluxes_off_the_card_is_the_host_route(device, monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("the device pass ran off the card")

    monkeypatch.setattr(strum, "strum_flux_batch", fail)
    assert strum.card_fluxes(_song(), NATIVE_SR, SEGMENTS, device) == [None] * len(SEGMENTS)


def test_card_fluxes_on_the_card_raises_what_the_pass_raises(monkeypatch):
    """A pass that fails on the card is no host route: its error propagates."""

    def oom(*args, **kwargs):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(strum, "strum_flux_batch", oom)
    with pytest.raises(RuntimeError, match="out of memory"):
        strum.card_fluxes(_song(), NATIVE_SR, SEGMENTS[:2], "cuda")


def _pass_on_cpu(monkeypatch) -> list:
    """``strum_flux_batch`` on the CPU in the card's place; its calls' bounds."""
    calls, batch = [], strum.strum_flux_batch

    def on_cpu(y, sr, bounds, device, **kw):
        assert torch.device(device).type == "cuda"
        calls.append(list(bounds))
        return batch(y, sr, bounds, "cpu", **kw)

    monkeypatch.setattr(strum, "strum_flux_batch", on_cpu)
    return calls


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("native", [True, False])
def test_run_guitar_mode_card_route_matches_jax(seed, native, monkeypatch):
    """Guitar mode on a CUDA device: the strum segments' envelopes in one
    pass (the native audio, or the 22.05 kHz signal where no envelope is
    given), and the JAX package's result."""
    from audiotabs_tpu.runtime.modes import run_guitar_mode as jax_guitar
    from audiotabs_tpu_torch.runtime.modes import run_guitar_mode

    calls = _pass_on_cpu(monkeypatch)
    y, y_nat, jc, pc, beats, jev, pev, content = _mode_inputs(seed)
    kw = dict(use_flats=bool(seed), precomputed_content=content, y_strum=(y_nat, NATIVE_SR) if native else None)
    ref = jax_guitar(y, SR, jc, beats, 120.0, base_note_events=jev, **kw)
    segments = tracing.counters().get("strum_segments", 0)
    got = run_guitar_mode(y, SR, pc, beats, 120.0, base_note_events=pev, device="cuda", **kw)
    assert ref.strum_onsets and len(calls) == 1 and len(calls[0]) >= 2
    assert tracing.counters().get("strum_segments", 0) == segments + len(calls[0])
    _same(ref, got)


def test_run_guitar_mode_envelope_slices_bypass_the_pass(monkeypatch):
    """The batch runner's route: 22.05 kHz envelope slices, no device pass."""
    from audiotabs_tpu.runtime.modes import run_guitar_mode as jax_guitar
    from audiotabs_tpu_torch.runtime.modes import run_guitar_mode

    calls = _pass_on_cpu(monkeypatch)
    y, _y_nat, jc, pc, beats, jev, pev, content = _mode_inputs(0)
    env = strum._normalize(strum._onset_strength_median_host(y, SR)).astype(np.float32)
    kw = dict(precomputed_content=content, strum_envelope=env)
    ref = jax_guitar(y, SR, jc, beats, 120.0, base_note_events=jev, **kw)
    got = run_guitar_mode(y, SR, pc, beats, 120.0, base_note_events=pev, device="cuda", **kw)
    assert calls == [] and ref.strum_onsets
    _same(ref, got)


@pytest.mark.parametrize("seed,time_sig", [(0, "4/4"), (1, "3/4")])
def test_run_accompaniment_mode_card_route_matches_jax(seed, time_sig, monkeypatch):
    """Accompaniment on a CUDA device: the whole song as one segment."""
    from audiotabs_tpu.runtime.modes import run_accompaniment_mode as jax_acc
    from audiotabs_tpu.theory.chord_simplify import simplify_chords_for_accompaniment as jax_simplify
    from audiotabs_tpu_torch.runtime.modes import run_accompaniment_mode
    from audiotabs_tpu_torch.theory.chord_simplify import simplify_chords_for_accompaniment

    calls = _pass_on_cpu(monkeypatch)
    _y, y_nat, jc, pc, beats, _jev, _pev, _content = _mode_inputs(seed)
    ref = jax_acc(y_nat, NATIVE_SR, jax_simplify(jc), beats, 120.0, use_flats=bool(seed), time_signature=time_sig)
    got = run_accompaniment_mode(y_nat, NATIVE_SR, simplify_chords_for_accompaniment(pc), beats, 120.0,
                                 use_flats=bool(seed), time_signature=time_sig, device="cuda")
    assert calls == [[(0, len(y_nat))]] and ref.strum_onsets
    _same(ref, got)
