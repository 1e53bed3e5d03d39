"""The order-2 FM score with its L2 term in one call (``ops/fm.fm2_score_l2``).

On the card it is the kernel pair of ``csrc/fm2_score.cu`` (held to this
plain twin in ``tests/test_torch_cuda.py``); on the CPU it is the plain twin,
``_FmScoreOrder2`` and ``masked_l2`` under autograd.  Here, on the CPU:

* the twin's score and L2 term together pass ``gradcheck`` in float64, at
  N 1 and 39, k 1 to 16, with padding slots, duplicate ids and λ 0 or not;
* ``trainer.batch_loss`` through ``score_and_regularization`` is bitwise
  the composition it replaces, ``score`` + ``regularization``, for the
  order-2 FM and DeepFM: loss and every gradient;
* FFM and the FM at order 3 still take ``score`` + ``regularization``.
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.models import Batch, DeepFMModel, FFMModel, FMModel
from fast_tffm_tpu_torch.models import fm as fm_module
from fast_tffm_tpu_torch.models.base import logistic_loss
from fast_tffm_tpu_torch.ops.fm import _FmScoreOrder2, fm2_score_l2, masked_l2
from fast_tffm_tpu_torch.trainer import batch_loss


def _ids_vals(rng, b, n, vocab):
    """Ids drawn from a small vocabulary (duplicates within and across
    examples), values in (0.1, 1] with the last slot of every example and
    the whole of example 0 padding when there is room."""
    ids = rng.integers(0, vocab, size=(b, n))
    vals = rng.uniform(0.1, 1.0, size=(b, n))
    if n > 1:
        vals[:, -1] = 0.0
    vals[0, :] = 0.0
    return torch.from_numpy(ids), torch.from_numpy(vals)


@pytest.mark.parametrize("n", [1, 39])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.3, 0.7)], ids=["lam0", "lam"])
def test_plain_twin_score_and_l2_pass_gradcheck(n, k, lam):
    rng = np.random.default_rng(100 * n + k)
    b, vocab = 3, 5
    ids, vals = _ids_vals(rng, b, n, vocab)
    table = torch.from_numpy(rng.normal(size=(vocab, 1 + k)) * 0.5).requires_grad_(True)
    vals.requires_grad_(True)

    def both(t, v):
        return fm2_score_l2(t[ids], v, *lam)

    assert torch.autograd.gradcheck(both, (table, vals), eps=1e-6, atol=1e-7, rtol=1e-6)


def _batch(rng, b, n, vocab):
    ids, vals = _ids_vals(rng, b, n, vocab)
    return Batch(
        labels=torch.from_numpy(rng.integers(0, 2, size=b).astype(np.float32)),
        ids=ids.to(torch.int32),
        vals=vals.float(),
        fields=torch.zeros((b, 0), dtype=torch.int32),
        weights=torch.ones(b),
    )


def _old_composition(model, rows, dense, batch):
    """``trainer.batch_loss`` as it was: the model's ``score`` (order 2 the
    plain ``_FmScoreOrder2``), the logistic loss, then ``regularization``
    (``masked_l2``)."""
    scores = model.score(rows, dense, batch)
    data_loss = logistic_loss(scores, batch.labels, batch.weights)
    return data_loss + model.regularization(rows, dense, batch), data_loss


@pytest.mark.parametrize("name", ["fm2", "deepfm", "deepfm_bf16"])
def test_cpu_batch_loss_is_bitwise_the_score_plus_regularization_it_replaces(name):
    vocab, n = 257, 11
    model = {
        "fm2": lambda: FMModel(vocabulary_size=vocab, factor_num=8, bias_lambda=1e-3,
                               factor_lambda=2e-3),
        "deepfm": lambda: DeepFMModel(vocabulary_size=vocab, num_fields=n, factor_num=8,
                                      hidden_dims=(16, 8), bias_lambda=1e-3, factor_lambda=2e-3),
        "deepfm_bf16": lambda: DeepFMModel(vocabulary_size=vocab, num_fields=n, factor_num=8,
                                           hidden_dims=(16, 8), bias_lambda=1e-3,
                                           factor_lambda=2e-3, compute_dtype="bfloat16"),
    }[name]()
    gen = torch.Generator().manual_seed(5)
    table, dense = model.init_table(gen), model.init_dense(gen)
    table[:, 0] = torch.randn(vocab, generator=gen) * 0.1  # a bias the L2 term sees
    batch = _batch(np.random.default_rng(6), 64, n, vocab)
    got, want = [], []
    for fn, out in ((batch_loss, got), (_old_composition, want)):
        rows = table[batch.ids.long()].requires_grad_(True)
        leaves = [p.clone().requires_grad_(True) for p in dense]
        total, data_loss = fn(model, rows, leaves, batch)
        out += [total, data_loss, *torch.autograd.grad(total, [rows, *leaves])]
    assert len(got) == len(want) == 3 + len(dense)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_cpu_fm2_score_l2_is_the_plain_functions():
    rng = np.random.default_rng(8)
    ids, vals = _ids_vals(rng, 6, 7, 9)
    rows = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))[ids]
    scores, reg = fm2_score_l2(rows, vals.float(), 0.25, 0.5)
    assert torch.equal(scores, _FmScoreOrder2.apply(rows, vals.float()))
    assert torch.equal(reg, masked_l2(rows, vals.float(), 0.25, 0.5))
    assert scores[0] == 0.0  # an all-padding example


@pytest.mark.parametrize("name", ["ffm", "fm3"])
def test_batch_loss_keeps_score_plus_regularization_for_ffm_and_order_3(name, monkeypatch):
    def refuse(*_):
        raise AssertionError("the order-2 pair must not serve this model")

    monkeypatch.setattr(fm_module, "fm2_score_l2", refuse)
    n = 6
    if name == "ffm":
        model = FFMModel(vocabulary_size=97, num_fields=3, factor_num=2, bias_lambda=1e-3,
                         factor_lambda=2e-3)
        assert not hasattr(model, "score_and_regularization")
    else:
        model = FMModel(vocabulary_size=97, factor_num=4, order=3, bias_lambda=1e-3,
                        factor_lambda=2e-3)
    gen = torch.Generator().manual_seed(9)
    table = model.init_table(gen)
    rng = np.random.default_rng(10)
    batch = _batch(rng, 16, n, 97)
    if model.uses_fields:
        fields = torch.from_numpy(rng.integers(0, 3, size=(16, n)).astype(np.int32))
        batch = Batch(batch.labels, batch.ids, batch.vals, fields, batch.weights)
    rows = table[batch.ids.long()]
    got = batch_loss(model, rows, [], batch)
    want = _old_composition(model, rows, [], batch)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
