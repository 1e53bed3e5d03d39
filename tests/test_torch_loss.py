"""Port: the training loss's gradient where a score is exactly 0.

``models/base.logistic_per_example`` is the reference's stable
log-sum-exp form of the sigmoid cross-entropy.  Autograd of that form gives
1 - y at s = 0 (max(s, 0) and |s| have no derivative there) where
sigmoid(0) - y = 1/2 - y is the loss's gradient, so a score that lands on
0.0 exactly on one device and an ulp off it on the other took gradients a
factor of 2 apart.

* At s = 0 the gradient is 1/2 - y, continuous with its neighbours'.
* The loss, and the gradient at every other score, is the form's own, bit
  for bit.
* Away from 0, loss and gradient are the JAX package's within float32
  rounding (the JAX form's own gradient at 0 is -y).
* A step whose scores are exactly 0 (zero biases and one feature a row, so
  no interaction term) takes the sigmoid(0) - y gradient in the
  single-device and the sharded step bodies alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.models.base import logistic_loss as jax_logistic_loss
from fast_tffm_tpu_torch.models import Batch
from fast_tffm_tpu_torch.models.base import logistic_loss, logistic_per_example
from fast_tffm_tpu_torch.models.fm import FMModel
from fast_tffm_tpu_torch.parallel.mesh import Mesh
from fast_tffm_tpu_torch.parallel.train_step import _sharded_grads
from fast_tffm_tpu_torch.trainer import TrainState, _grads


def _stable_form(s, y):
    return torch.clamp_min(s, 0.0) - s * y + torch.log1p(torch.exp(-torch.abs(s)))


def _loss_and_grad(scores, labels, weights):
    s = torch.from_numpy(scores).requires_grad_(True)
    loss = logistic_loss(s, torch.from_numpy(labels), torch.from_numpy(weights))
    (g,) = torch.autograd.grad(loss, [s])
    return loss.detach().numpy(), g.numpy()


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_gradient_at_zero_is_sigmoid_minus_label(label):
    scores = np.array([0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7], np.float32)
    labels = np.full(scores.shape, label, np.float32)
    weights = np.ones(scores.shape, np.float32)
    _, g = _loss_and_grad(scores, labels, weights)
    per_example = g * weights.sum()
    np.testing.assert_allclose(per_example[:2], 0.5 - label, rtol=0, atol=1e-7)
    np.testing.assert_allclose(per_example, 0.5 - label, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1e-2, 1.0, 40.0])
def test_loss_and_other_gradients_are_the_stable_forms_bitwise(scale):
    g = torch.Generator().manual_seed(3)
    s0 = torch.randn(50_000, generator=g) * scale
    s0[::97] = 0.0
    y = (torch.rand(50_000, generator=g) < 0.5).float()
    w = torch.rand(50_000, generator=g)
    out = []
    for f in (_stable_form, logistic_per_example):
        s = s0.clone().requires_grad_(True)
        per = f(s, y)
        (gs,) = torch.autograd.grad(torch.sum(per * w) / torch.sum(w), [s])
        out.append((per.detach(), gs))
    nonzero = s0 != 0
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1][nonzero], out[1][1][nonzero])
    # The form's own gradient at 0 is 1 - y; the loss's is 1/2 - y.
    at_zero = (out[1][1][~nonzero] * torch.sum(w) / w[~nonzero]).numpy()
    np.testing.assert_allclose(at_zero, 0.5 - y[~nonzero].numpy(), rtol=0, atol=1e-6)


def test_away_from_zero_the_loss_is_the_jax_packages():
    rng = np.random.default_rng(11)
    scores = (rng.standard_normal(4096) * 3).astype(np.float32)
    scores[scores == 0] = 0.5
    labels = (rng.random(4096) < 0.4).astype(np.float32)
    weights = rng.random(4096).astype(np.float32)
    loss, g = _loss_and_grad(scores, labels, weights)
    jloss, jg = jax.value_and_grad(jax_logistic_loss)(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights))
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=1e-6)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("body", ["single", "sharded"])
def test_step_on_exact_zero_scores_takes_the_sigmoid_gradient(body):
    model = FMModel(vocabulary_size=16, factor_num=4)
    table = torch.zeros((16, model.row_dim))
    table[:, 1:] = torch.from_numpy(
        np.random.default_rng(2).uniform(-0.01, 0.01, (16, 4)).astype(np.float32))
    state = TrainState(table=table, dense=[], step=0, table_accum=torch.full_like(table, 0.1))
    ids = torch.tensor([[3, 0], [5, 0], [9, 0], [12, 0]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 0.0], [0.5, 0.0], [2.0, 0.0], [1.5, 0.0]])
    labels = torch.tensor([1.0, 0.0, 1.0, 0.0])
    batch = Batch(labels=labels, ids=ids, vals=vals, fields=torch.zeros((4, 0), dtype=torch.int32),
                  weights=torch.ones(4))
    assert torch.equal(model.score(table[ids], [], batch), torch.zeros(4))
    rows = state.table[batch.ids]
    if body == "single":
        _, g_rows, _ = _grads(model, rows, state, batch)
    else:
        _, g_rows, _ = _sharded_grads(model, rows, state, batch, Mesh())
    want = (0.5 - labels) * vals[:, 0] / 4
    torch.testing.assert_close(g_rows[:, 0, 0], want, rtol=0, atol=1e-8)
