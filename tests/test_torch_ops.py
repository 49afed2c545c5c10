"""The port's DSP ops and host decode against the JAX package, on the same numpy inputs.

Float outputs at rtol 1e-4, atol 1e-5 (f32 FFTs and GEMMs summed in another
order); numpy-built banks and discrete outputs exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiotabs_tpu.ops import features as jfeat
from audiotabs_tpu.ops import onset as jonset
from audiotabs_tpu.ops import spectral as jspec
from audiotabs_tpu_torch.ops import features as tfeat
from audiotabs_tpu_torch.ops import onset as tonset
from audiotabs_tpu_torch.ops import spectral as tspec

# the modules, not the cqt functions that both packages' ops re-export under their name
jcqt = importlib.import_module("audiotabs_tpu.ops.cqt")
tcqt = importlib.import_module("audiotabs_tpu_torch.ops.cqt")

SR = 22050
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def clip():
    """1.5 s of two partials plus clicks and noise, from a seed."""
    rng = np.random.default_rng(7)
    t = np.arange(int(1.5 * SR)) / SR
    y = 0.3 * np.sin(2 * np.pi * 196.0 * t) + 0.2 * np.sin(2 * np.pi * 523.25 * t)
    y[:: SR // 4] += 0.8
    return (y + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _close(got: torch.Tensor, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("n_fft,hop,pad_mode", [(2048, 512, "reflect"), (1024, 256, "constant"), (1000, 300, "reflect")])
def test_stft_matches_jax(clip, n_fft, hop, pad_mode):
    ref = jspec.stft(jnp.asarray(clip), n_fft=n_fft, hop=hop, pad_mode=pad_mode)
    got = tspec.stft(torch.from_numpy(clip), n_fft=n_fft, hop=hop, pad_mode=pad_mode)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (1000, 300)])
def test_istft_matches_jax(clip, n_fft, hop):
    spec = np.array(jspec.stft(jnp.asarray(clip), n_fft=n_fft, hop=hop))
    ref = jspec.istft(jnp.asarray(spec), hop=hop, length=len(clip))
    got = tspec.istft(torch.from_numpy(spec), hop=hop, length=len(clip))
    _close(got, ref)


def test_frame_and_power_to_db_match_jax(clip):
    _close(tspec.frame(torch.from_numpy(clip), 4096, 220, pad_mode="constant"), jspec.frame(jnp.asarray(clip), 4096, 220, pad_mode="constant"), rtol=0, atol=0)
    S = np.abs(clip[:2000].reshape(40, 50)) ** 2
    _close(tspec.power_to_db(torch.from_numpy(S)), jspec.power_to_db(jnp.asarray(S)))


@pytest.mark.parametrize("scale", ["htk", "slaney"])
def test_mel_filterbank_is_the_same_array(scale):
    np.testing.assert_array_equal(tfeat.mel_filterbank(SR, 2048, 128, scale=scale), jfeat.mel_filterbank(SR, 2048, 128, scale=scale))


def test_melspectrogram_and_frame_features_match_jax(clip):
    y, yj = torch.from_numpy(clip), jnp.asarray(clip)
    ref = np.asarray(jfeat.melspectrogram(yj, SR))
    np.testing.assert_allclose(tfeat.melspectrogram(y, SR).numpy(), ref, rtol=1e-4, atol=1e-5 * ref.max())
    _close(tfeat.rms(y, 2048, 512), jfeat.rms(yj, 2048, 512))
    _close(tfeat.spectral_centroid(y, SR), jfeat.spectral_centroid(yj, SR), rtol=1e-4, atol=1e-2)
    _close(tfeat.spectral_rolloff(y, SR), jfeat.spectral_rolloff(yj, SR), rtol=0, atol=0)


def test_onset_strength_and_detection_match_jax(clip):
    y, yj = torch.from_numpy(clip), jnp.asarray(clip)
    ref = jonset.onset_strength(yj, SR, hop=512, n_fft=1024)
    env = tonset.onset_strength(y, SR, hop=512, n_fft=1024)
    _close(env, ref, rtol=1e-4, atol=1e-4)
    env_np = np.array(ref)
    np.testing.assert_array_equal(
        tonset.onset_detect_frames(torch.from_numpy(env_np), delta=0.5, wait=4).numpy(),
        np.asarray(jonset.onset_detect_frames(jnp.asarray(env_np), delta=0.5, wait=4)),
    )
    for kind in ("max", "mean"):
        _close(tonset._sliding_reduce(torch.from_numpy(env_np), 3, 5, kind), jonset._sliding_reduce(jnp.asarray(env_np), 3, 5, kind))


def test_cqt_bank_is_the_same_array():
    for args in [(SR,), (SR, 27.5, 264, 36, 1.0, 16384)]:
        bt, ft, kt = tcqt.cqt_kernel_bank(*args)
        bj, fj, kj = jcqt.cqt_kernel_bank(*args)
        assert kt == kj
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(ft, fj)


def test_cqt_and_hybrid_cqt_match_jax(clip):
    y, yj = torch.from_numpy(clip), jnp.asarray(clip)
    ref = np.asarray(jcqt.cqt(yj, SR, hop=256))
    np.testing.assert_allclose(tcqt.cqt(y, SR, hop=256).numpy(), ref, rtol=1e-4, atol=1e-5 * ref.max())
    ref = np.asarray(jcqt.hybrid_cqt(yj, SR, hop=256, fmin=27.5, n_bins=264, bins_per_octave=36, harmonics=(0.5, 1.0, 2.0, 3.0)))
    got = tcqt.hybrid_cqt(y, SR, hop=256, fmin=27.5, n_bins=264, bins_per_octave=36, harmonics=(0.5, 1.0, 2.0, 3.0))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * ref.max())


def test_pyin_matches_jax(clip):
    from audiotabs_tpu.ops.pyin import _beta_pmf as jbeta
    from audiotabs_tpu.ops.pyin import pyin as jpyin
    from audiotabs_tpu_torch.ops.pyin import _beta_pmf, pyin

    np.testing.assert_allclose(_beta_pmf(100), jbeta(100), rtol=1e-5, atol=1e-9)
    y = clip[: SR]
    kw = dict(fmin=82.40688922821748, fmax=1318.5102276514797, frame_length=2048, hop=512)
    f0j, vj, pj = (np.asarray(a) for a in jpyin(jnp.asarray(y), SR, **kw))
    f0, v, p = pyin(torch.from_numpy(np.stack([y, y[::-1].copy()])), SR, **kw)
    np.testing.assert_array_equal(v[0].numpy(), vj)
    np.testing.assert_allclose(f0[0].numpy(), f0j, rtol=1e-5)
    np.testing.assert_allclose(p[0].numpy(), pj, rtol=1e-4, atol=1e-5)


def test_strum_envelope_takes_the_mean_of_the_two_middle_bands(clip):
    """Parity trap: 128 mel bands is an even count; jnp.median averages the
    two middle values, torch.median would return the lower one."""
    from audiotabs_tpu.accompaniment.strum import _onset_strength_median as jenv
    from audiotabs_tpu_torch.accompaniment.strum import _onset_strength_median

    ref = np.asarray(jenv(jnp.asarray(clip), SR, 512))
    np.testing.assert_allclose(_onset_strength_median(torch.from_numpy(clip), SR, 512).numpy(), ref, rtol=1e-4, atol=1e-4)
    x = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    assert torch.quantile(x, 0.5, dim=-2).item() == float(np.median(x.numpy())) == 3.0
    assert torch.median(x, dim=-2).values.item() == 2.0


def test_quantile_interpolates_like_jnp_percentile():
    x = np.random.default_rng(1).random(37).astype(np.float32)
    for q in (0.1, 0.5):
        np.testing.assert_allclose(torch.quantile(torch.from_numpy(x), q).item(), float(jnp.percentile(jnp.asarray(x), 100 * q)), rtol=1e-6)


def test_resample_matches_native_resampler():
    from audiotabs_tpu.io.native import resample_native
    from audiotabs_tpu_torch.io.resample import resample_poly_host

    x = np.random.default_rng(2).standard_normal(5000).astype(np.float32)
    for sr_in, sr_out in [(44100, 22050), (48000, 22050), (22050, 22050)]:
        ref = resample_native(x, sr_in, sr_out)
        assert ref is not None, "the JAX package's native resampler did not build"
        np.testing.assert_allclose(resample_poly_host(x, sr_in, sr_out), ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pcm16", [True, False])
def test_wav_decode_matches_jax(tmp_path, pcm16):
    from audiotabs_tpu.io.wav import read_wav as jread
    from audiotabs_tpu.io.wav import write_wav
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize, read_wav

    x = (0.5 * np.random.default_rng(3).standard_normal((4410, 2))).clip(-1, 1).astype(np.float32)
    path = tmp_path / "a.wav"
    write_wav(path, x, 44100, pcm16=pcm16)
    got, sr = read_wav(path)
    ref, sr_ref = jread(path)
    assert sr == sr_ref == 44100
    np.testing.assert_array_equal(got, ref)
    y, sr_y, (native, sr_n) = decode_for_analysis(path, 22050)
    assert sr_y == 22050 and sr_n == 44100 and len(y) == 2205
    np.testing.assert_allclose(native, ref.mean(axis=1), rtol=0, atol=1e-7)
    assert np.isclose(np.abs(peak_normalize(y)).max(), 0.95)
