"""Port: FM scoring and the model against the JAX package on the CPU.

The same ``[B, N, 1+k]`` rows and ``[B, N]`` values, made with numpy from a
seed, go through ``fast_tffm_tpu_torch.ops.fm.fm_score`` and
``fast_tffm_tpu.ops.fm.fm_score`` (order 2: the (Σv)²−Σv² path; order ≥ 3:
the scan DP and the Pallas kernel in interpret mode).  Zero values mark
padding slots.  Tolerance rtol 1e-5 / atol 1e-6 (float32, summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.models.base import Batch as JaxBatch
from fast_tffm_tpu.models.fm import FMModel as JaxFMModel
from fast_tffm_tpu.ops.fm import fm_score as jax_fm_score
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.trainer import make_predict_step as jax_make_predict_step
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.models.fm import FMModel
from fast_tffm_tpu_torch.ops.fm import fm_score
from fast_tffm_tpu_torch.trainer import TrainState, make_predict_step

RTOL, ATOL = 1e-5, 1e-6


def _rows_vals(rng, b=12, n=11, k=8):
    rows = (rng.normal(size=(b, n, 1 + k)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.1, 1.0, size=(b, n)).astype(np.float32)
    vals[:, n - 3 :] = 0.0  # padding slots
    vals[0, :] = 0.0  # an all-padding row scores 0
    return rows, vals


@pytest.mark.parametrize(
    "order,use_pallas", [(2, False), (3, False), (3, True), (4, False), (4, True)]
)
def test_fm_score_matches_jax(order, use_pallas):
    rng = np.random.default_rng(order)
    rows, vals = _rows_vals(rng)
    got = fm_score(torch.from_numpy(rows), torch.from_numpy(vals), order).numpy()
    want = np.asarray(
        jax_fm_score(jnp.asarray(rows), jnp.asarray(vals), order=order, use_pallas=use_pallas)
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0] == 0.0


def test_fm_score_refuses_order_below_two():
    with pytest.raises(ValueError):
        fm_score(torch.zeros((1, 2, 3)), torch.zeros((1, 2)), order=1)


def test_init_table_distribution_and_determinism():
    model = FMModel(vocabulary_size=64, factor_num=4, order=3, init_value_range=0.05)
    t1 = model.init_table(torch.Generator().manual_seed(0))
    t2 = model.init_table(torch.Generator().manual_seed(0))
    assert t1.shape == (64, model.row_dim) and t1.dtype == torch.float32
    torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    assert torch.all(t1[:, 0] == 0)
    assert float(t1[:, 1:].abs().max()) <= 0.05
    assert float(t1[:, 1:].std()) > 0.01  # not degenerate


@pytest.mark.parametrize("order", [2, 3])
def test_predict_step_matches_jax(order):
    """sigmoid(score(table[ids])) on one shared table, through both
    packages' model and predict step."""
    rng = np.random.default_rng(10 + order)
    v, k, b, n = 50, 8, 9, 11
    jmodel = JaxFMModel(vocabulary_size=v, factor_num=k, order=order)
    table = rng.uniform(-0.3, 0.3, size=(v, 1 + k)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, n)).astype(np.int32)
    vals = rng.uniform(0.0, 1.0, size=(b, n)).astype(np.float32)
    vals[:, -2:] = 0.0
    jstate = jax_init_state(jmodel, jax.random.key(0))._replace(table=jnp.asarray(table))
    jbatch = JaxBatch(
        labels=jnp.zeros(b), ids=jnp.asarray(ids), vals=jnp.asarray(vals),
        fields=jnp.zeros((b, 0), jnp.int32), weights=jnp.ones(b),
    )
    want = np.asarray(jax_make_predict_step(jmodel)(jstate, jbatch))
    model = FMModel(vocabulary_size=v, factor_num=k, order=order)
    batch = Batch(
        labels=torch.zeros(b), ids=torch.from_numpy(ids), vals=torch.from_numpy(vals),
        fields=torch.zeros((b, 0), dtype=torch.int32), weights=torch.ones(b),
    )
    got = make_predict_step(model)(TrainState(torch.from_numpy(table), [], 0), batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
