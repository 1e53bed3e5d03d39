"""Port: the backward passes of FM scoring against the JAX package on the CPU.

* ``anova_inter_bwd_plain`` (the plain twin of csrc/anova_bwd.cu) against
  the ``jax.vjp`` of the JAX ``anova_inter`` with its Pallas backward in
  interpret mode, and against the ``jax.vjp`` of ``fm_score(...,
  use_pallas=False)`` (the ``lax.scan`` adjoint ``_fm_score_anova_bwd``).
* The autograd repair: the port's order-3 ``fm_score`` carries a gradient
  through the ANOVA term (``torch.autograd.grad`` against ``jax.grad``).
* The order-2 hand-written VJP against ``jax.grad`` of the JAX order-2
  ``fm_score``.

Inputs come from numpy seeds; padding slots carry zero values and B = 130
is off the TPU kernel's 128-lane multiple.  Tolerance rtol 1e-5 / atol 1e-6:
float32 DPs that differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.ops.fm import fm_score as jax_fm_score
from fast_tffm_tpu.ops.pallas_anova import anova_inter as jax_anova_inter
from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_bwd, anova_inter_bwd_plain
from fast_tffm_tpu_torch.ops.fm import fm_score

RTOL, ATOL = 1e-5, 1e-6


def _z(rng, b, n, k, pad=0, scale=0.4):
    z = (rng.normal(size=(b, n, k)) * scale).astype(np.float32)
    if pad:
        z[:, n - pad :, :] = 0.0  # padding slots: z = v·0
    return z


def _rows_vals(rng, b=12, n=11, k=8):
    rows = (rng.normal(size=(b, n, 1 + k)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.1, 1.0, size=(b, n)).astype(np.float32)
    vals[:, n - 3 :] = 0.0  # padding slots
    vals[0, :] = 0.0  # an all-padding row
    return rows, vals


@pytest.mark.parametrize("order", [3, 4, 5])
@pytest.mark.parametrize(
    "b,n,k,pad,scale",
    # At baseline5's widths (N = 11, k = 8) the degree sums cancel in
    # float32 at z ~ N(0, 0.4²); 0.2 keeps the comparison about the
    # algorithm, as the forward's parity test does.
    [(9, 6, 3, 0, 0.4), (130, 11, 8, 3, 0.2)],
)
def test_bwd_plain_matches_jax_pallas_vjp(order, b, n, k, pad, scale):
    rng = np.random.default_rng(order * 100 + b)
    z = _z(rng, b, n, k, pad, scale)
    g = rng.normal(size=b).astype(np.float32)
    _, vjp = jax.vjp(lambda zz: jax_anova_inter(zz, order, True), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    got = anova_inter_bwd_plain(torch.from_numpy(z), torch.from_numpy(g), order).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # The CPU wrapper is the plain version.
    np.testing.assert_array_equal(
        anova_inter_bwd(torch.from_numpy(z), torch.from_numpy(g), order).numpy(), got
    )


@pytest.mark.parametrize("order", [3, 4, 5])
def test_bwd_plain_matches_jax_scan_adjoint(order):
    """Through fm_score: d score / d rows from the port's autograd (linear
    term and z = v·x by autograd, the DP by anova_inter_bwd_plain) against
    the JAX hand-written scan adjoint."""
    rng = np.random.default_rng(40 + order)
    rows, vals = _rows_vals(rng, b=130)
    g = rng.normal(size=130).astype(np.float32)
    _, vjp = jax.vjp(
        lambda r, v: jax_fm_score(r, v, order=order, use_pallas=False),
        jnp.asarray(rows), jnp.asarray(vals),
    )
    want_rows, want_vals = vjp(jnp.asarray(g))
    r = torch.from_numpy(rows).requires_grad_(True)
    v = torch.from_numpy(vals).requires_grad_(True)
    got_rows, got_vals = torch.autograd.grad(fm_score(r, v, order), [r, v], torch.from_numpy(g))
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_order3_fm_score_gradient_matches_jax_grad(use_pallas):
    """The repair: anova_inter is an autograd Function, so the interaction
    term has a gradient (on the card its backward is the B2 kernel; here
    the plain twin)."""
    rng = np.random.default_rng(3)
    rows, vals = _rows_vals(rng)
    w = rng.normal(size=12).astype(np.float32)

    def jloss(r):
        return jnp.sum(jax_fm_score(r, jnp.asarray(vals), order=3, use_pallas=use_pallas) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(rows)))
    r = torch.from_numpy(rows).requires_grad_(True)
    (got,) = torch.autograd.grad(
        torch.sum(fm_score(r, torch.from_numpy(vals), 3) * torch.from_numpy(w)), r
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.abs(got.numpy()[..., 1:]).max() > 1e-3  # the factor columns move


def test_anova_inter_gradient_is_its_backward():
    rng = np.random.default_rng(8)
    z = torch.from_numpy(_z(rng, 7, 5, 4)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    before = anova_inter_bwd.launches
    (got,) = torch.autograd.grad(anova_inter(z, 4), z, g)
    torch.testing.assert_close(got, anova_inter_bwd_plain(z.detach(), g, 4), rtol=0, atol=0)
    assert anova_inter_bwd.launches == before  # a count of kernel launches only


def test_order2_vjp_matches_jax_grad():
    rng = np.random.default_rng(2)
    rows, vals = _rows_vals(rng)
    w = rng.normal(size=12).astype(np.float32)

    def jloss(r, v):
        return jnp.sum(jax_fm_score(r, v, order=2) * w)

    want_r, want_v = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rows), jnp.asarray(vals))
    r = torch.from_numpy(rows).requires_grad_(True)
    v = torch.from_numpy(vals).requires_grad_(True)
    got_r, got_v = torch.autograd.grad(torch.sum(fm_score(r, v, 2) * torch.from_numpy(w)), [r, v])
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)
