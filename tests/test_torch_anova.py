"""Port: the ANOVA interaction sum's plain version against the JAX package.

``anova_inter_plain`` (fast_tffm_tpu_torch/ops/anova.py) is the plain twin
of the CUDA kernel csrc/anova_fwd.cu.  Here, on the CPU, it is held against
the JAX package as its own tests run it: the Pallas kernel in interpret
mode and the brute-force oracle ``anova_inter_reference``.  The same inputs,
made with numpy from a seed, feed both.  Tolerance rtol 1e-5 / atol 1e-6:
both sides are float32 DPs that differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.ops.fm import _anova_scan_fwd as jax_anova_scan_fwd
from fast_tffm_tpu.ops.pallas_anova import anova_inter as jax_anova_inter
from fast_tffm_tpu.ops.pallas_anova import anova_inter_reference
from fast_tffm_tpu_torch.ops.anova import (
    MAX_ORDER,
    MIN_ORDER,
    _carries,
    anova_inter,
    anova_inter_plain,
)

RTOL, ATOL = 1e-5, 1e-6


def _z(rng, b, n, k, scale=0.4):
    return (rng.normal(size=(b, n, k)) * scale).astype(np.float32)


def _jax_interpret(z, order):
    return np.asarray(jax_anova_inter(jnp.asarray(z), order, True))


@pytest.mark.parametrize("order", [3, 4, 5])
def test_plain_matches_jax_kernel_and_oracle(order):
    rng = np.random.default_rng(order)
    z = _z(rng, 9, 6, 3)
    got = anova_inter_plain(torch.from_numpy(z), order).numpy()
    np.testing.assert_allclose(got, _jax_interpret(z, order), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, anova_inter_reference(z, order), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_plain_matches_jax_kernel_off_lane_multiple(order):
    # B = 130 is not a multiple of the TPU kernel's 128 lanes; k = 8 and
    # N = 11 are baseline5's widths.
    rng = np.random.default_rng(100 + order)
    z = _z(rng, 130, 11, 8, scale=0.2)
    got = anova_inter_plain(torch.from_numpy(z), order).numpy()
    np.testing.assert_allclose(got, _jax_interpret(z, order), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("order", [3, 4])
def test_padding_slots_are_neutral(order):
    rng = np.random.default_rng(7 + order)
    z = _z(rng, 8, 4, 3)
    z_pad = np.concatenate([z, np.zeros((8, 3, 3), np.float32)], axis=1)
    got = anova_inter_plain(torch.from_numpy(z_pad), order).numpy()
    np.testing.assert_allclose(got, anova_inter_plain(torch.from_numpy(z), order).numpy(), rtol=RTOL)
    np.testing.assert_allclose(got, _jax_interpret(z_pad, order), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, anova_inter_reference(z, order), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("order", [3, 6])
def test_scan_twin_matches_jax_scan(order):
    """ops/anova.py's DP with its per-feature carries (the backward pass's
    residuals) against fast_tffm_tpu/ops/fm.py::_anova_scan_fwd; order 6
    is above N, where the high degrees vanish."""
    rng = np.random.default_rng(20 + order)
    z = _z(rng, 13, 5, 4)
    *prevs, a_final = _carries(torch.from_numpy(z), order)
    a_prevs = torch.stack(prevs)
    j_final, j_prevs = jax_anova_scan_fwd(jnp.asarray(z), order)
    np.testing.assert_allclose(a_final.numpy(), np.asarray(j_final), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a_prevs.numpy(), np.asarray(j_prevs), rtol=RTOL, atol=ATOL)
    # Summed over degrees 2..order, the scan is the plain version.
    np.testing.assert_allclose(
        a_final[:, 2:, :].sum(dim=(1, 2)).numpy(),
        anova_inter_plain(torch.from_numpy(z), order).numpy(),
        rtol=RTOL,
        atol=ATOL,
    )


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    z = torch.from_numpy(_z(np.random.default_rng(3), 5, 4, 8))
    before = anova_inter.launches
    torch.testing.assert_close(anova_inter(z, 3), anova_inter_plain(z, 3), rtol=0, atol=0)
    assert anova_inter.launches == before  # a count of kernel launches only


@pytest.mark.parametrize("order", [MIN_ORDER - 1, MAX_ORDER + 1])
def test_wrapper_refuses_orders_the_kernel_lacks(order):
    z = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="orders"):
        anova_inter(z, order)
