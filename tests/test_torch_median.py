"""The port's median filter and HPSS masks against the JAX package.

The plain version (what a CPU tensor takes) must equal the JAX XLA median
and the Pallas kernel in interpret mode exactly: a median selects an input
element. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py, and by the ``cuda``-marked test here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.ops.hpss import _median_filter_lastaxis
from audiotabs_tpu.ops.hpss import hpss_masks as jax_hpss_masks
from audiotabs_tpu.ops.pallas_median import median_filter_lastaxis_pallas
from audiotabs_tpu_torch.ops import median as tmed
from audiotabs_tpu_torch.ops.hpss import hpss_masks


def _jax_median(x: np.ndarray, win: int, axis: int) -> np.ndarray:
    if axis == -1:
        return np.asarray(_median_filter_lastaxis(jnp.asarray(x), win))
    return np.swapaxes(np.asarray(_median_filter_lastaxis(jnp.swapaxes(jnp.asarray(x), -1, -2), win)), -1, -2)


def _pallas_median(x: np.ndarray, win: int, axis: int) -> np.ndarray:
    def one(s):  # [F, T]
        if axis == -1:
            return median_filter_lastaxis_pallas(s, win, interpret=True)
        return median_filter_lastaxis_pallas(s.T, win, interpret=True).T

    xj = jnp.asarray(x)
    return np.asarray(jax.vmap(one)(xj) if x.ndim == 3 else one(xj))


@pytest.mark.parametrize("win", [5, 17, 31])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("shape", [(40, 70), (2, 37, 45)])
def test_plain_median_matches_jax_exactly(win, axis, shape):
    rng = np.random.default_rng(win + 10 * len(shape))
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = tmed.median_filter(torch.from_numpy(x), win, axis).numpy()
    np.testing.assert_array_equal(got, _jax_median(x, win, axis))


@pytest.mark.parametrize("win,axis,shape", [(31, -1, (20, 150)), (17, -2, (40, 60)), (5, -1, (2, 12, 40))])
def test_plain_median_matches_pallas_interpret_exactly(win, axis, shape):
    rng = np.random.default_rng(win)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = tmed.median_filter(torch.from_numpy(x), win, axis).numpy()
    np.testing.assert_array_equal(got, _pallas_median(x, win, axis))


def test_median_cpu_tensor_takes_plain_version_without_counting():
    x = torch.rand(8, 20)
    before = tmed.LAUNCHES
    torch.testing.assert_close(tmed.median_filter(x, 5), tmed.median_filter_plain(x, 5), rtol=0, atol=0)
    assert tmed.LAUNCHES == before


@pytest.mark.parametrize(
    "x,win,axis,err",
    [
        (torch.rand(8, 20), 4, -1, ValueError),  # even window
        (torch.rand(8, 20), 129, -1, ValueError),  # window too wide
        (torch.rand(8, 20, dtype=torch.float64), 5, -1, TypeError),
        (torch.rand(20), 5, -1, ValueError),  # 1-D
        (torch.rand(2, 3, 8, 20), 5, -1, ValueError),  # 4-D
        (torch.rand(2, 8, 20), 5, 0, ValueError),  # batch axis
        (torch.rand(8, 20, device="meta"), 5, -1, ValueError),  # neither cuda nor cpu
    ],
)
def test_median_rejects_bad_arguments(x, win, axis, err):
    with pytest.raises(err):
        tmed.median_filter(x, win, axis)


@pytest.mark.parametrize("kernels", [(31, 31), (17, 17)])
def test_hpss_masks_match_jax(kernels):
    rng = np.random.default_rng(3)
    S = np.abs(rng.standard_normal((64, 120))).astype(np.float32)
    S[:, 5] = 0.0  # a silent frame exercises the 0.5 fallback
    mh_ref, mp_ref = (np.asarray(m) for m in jax_hpss_masks(jnp.asarray(S), *kernels, use_pallas=False))
    mh, mp = (m.numpy() for m in hpss_masks(torch.from_numpy(S), *kernels))
    np.testing.assert_allclose(mh, mh_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mp, mp_ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win", [((1025, 1292), 31), ((513, 1292), 17), ((2, 1025, 1292), 31), ((3, 37, 70), 7)])
def test_cuda_kernel_equals_plain_version(shape, win):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the median kernel has no CPU mode")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)).cuda()
    for axis in (-1, -2):
        before = tmed.LAUNCHES
        got = tmed.median_filter(x, win, axis)
        torch.cuda.synchronize()
        assert tmed.LAUNCHES == before + 1
        assert torch.equal(got, tmed.median_filter_plain(x, win, axis))
