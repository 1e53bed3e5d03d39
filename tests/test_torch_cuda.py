"""Port kernels on the card: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device and nvcc; elsewhere every test skips.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.ops.anova import (
    MAX_ORDER,
    anova_inter,
    anova_inter_bwd,
    anova_inter_bwd_plain,
    anova_inter_plain,
)
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.models.fm import FMModel
from fast_tffm_tpu_torch.ops.fm import fm_score
from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update
from fast_tffm_tpu_torch.optim import dedup_rows, sparse_adagrad_update
from fast_tffm_tpu_torch.trainer import (
    init_state,
    make_decayed_body,
    make_pallas_tail_body,
    make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,n,k,order",
    [
        (1, 11, 8, 3),
        (512, 11, 8, 4),
        (130, 7, 5, 3),  # ragged: shared-memory reduction, partial last block
        (33, 4, 40, 5),  # k above a warp
        (9, 3, 300, 3),  # k above a block: a thread walks several factors
        (64, 12, 1, 8),
        (17, 0, 8, 3),  # no features: every degree >= 1 is 0
    ],
)
def test_anova_kernel_matches_plain(cuda, b, n, k, order):
    rng = np.random.default_rng(b * 1000 + n * 10 + order)
    z = torch.from_numpy((rng.normal(size=(b, n, k)) * 0.4).astype(np.float32)).to(cuda)
    before = anova_inter.launches
    got = anova_inter(z, order)
    torch.cuda.synchronize()
    assert anova_inter.launches == before + 1
    torch.testing.assert_close(got, anova_inter_plain(z, order), rtol=1e-5, atol=1e-6)


def test_anova_kernel_refuses_what_it_does_not_take(cuda):
    z = torch.zeros((4, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        anova_inter(z, MAX_ORDER + 1)
    with pytest.raises(ValueError):
        anova_inter(z.transpose(0, 1), 3)  # not contiguous
    with pytest.raises(ValueError):
        anova_inter(z.double(), 3)


@pytest.mark.parametrize(
    "b,n,k,order",
    [
        (1, 11, 8, 3),
        (512, 11, 8, 4),
        (16384, 11, 8, 3),  # the baseline5 training batch
        (130, 7, 5, 3),  # ragged
        (64, 39, 8, 3),  # criteo width
        (9, 100, 4, 8),  # stash above 48 KB: a 32-thread block, raised limit
    ],
)
def test_anova_bwd_kernel_matches_plain(cuda, b, n, k, order):
    rng = np.random.default_rng(b + n + k + order)
    # z = v·x as training forms it: factors ~U(±0.25), values in (0, 1].
    z = rng.uniform(-0.25, 0.25, size=(b, n, k)) * (1.0 - rng.random((b, n, 1)))
    z = torch.from_numpy(z.astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).to(cuda)
    before = anova_inter_bwd.launches
    got = anova_inter_bwd(z, g, order)
    torch.cuda.synchronize()
    assert anova_inter_bwd.launches == before + 1
    torch.testing.assert_close(got, anova_inter_bwd_plain(z, g, order), rtol=1e-5, atol=1e-6)


def test_order3_gradient_on_the_card_matches_the_cpu(cuda):
    """The forward kernel carries a gradient: autograd through fm_score at
    order 3 on the card equals the CPU twin's, factor columns included."""
    rng = np.random.default_rng(5)
    rows = rng.uniform(-0.3, 0.3, size=(64, 11, 9)).astype(np.float32)
    vals = rng.uniform(0.1, 1.0, size=(64, 11)).astype(np.float32)
    vals[:, -2:] = 0.0
    grads = []
    for dev in ("cpu", cuda):
        r = torch.from_numpy(rows).to(dev).requires_grad_(True)
        score = fm_score(r, torch.from_numpy(vals).to(dev), order=3)
        (g,) = torch.autograd.grad(torch.sum(score * torch.linspace(-1, 1, 64, device=dev)), r)
        grads.append(g.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)
    assert float(grads[1][..., 1:].abs().max()) > 1e-3


def _tail_case(rng, v, d, a, m):
    table = rng.uniform(-0.1, 0.1, size=(v, d)).astype(np.float32)
    accum = rng.uniform(0.1, 0.5, size=(v, a)).astype(np.float32)
    ids = (rng.zipf(1.3, size=m) % v).astype(np.int32)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    return table, accum, ids, grads


@pytest.mark.parametrize(
    "v,d,a,m,decay",
    [
        (4096, 9, 9, 2000, 1.0),
        (4096, 9, 1, 2000, 1.0),
        (4096, 9, 9, 2000, 0.9),
        (4096, 9, 1, 2000, 0.9),
        (64, 9, 9, 1, 1.0),  # K = 1
        (1 << 20, 9, 9, 180224, 1.0),  # baseline5 width
    ],
)
def test_rows_tail_kernel_matches_twin(cuda, v, d, a, m, decay):
    rng = np.random.default_rng(v + a + m)
    table, accum, ids, grads = _tail_case(rng, v, d, a, m)
    t_k, a_k = torch.from_numpy(table).to(cuda), torch.from_numpy(accum).to(cuda)
    t_p, a_p = t_k.clone(), a_k.clone()
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    before = rows_tail_adagrad_update.launches
    rows_tail_adagrad_update(t_k, a_k, ids_t, g_t, 0.05, decay=decay)
    sparse_adagrad_update(t_p, a_p, ids_t, g_t, 0.05, decay=decay)
    torch.cuda.synchronize()
    assert rows_tail_adagrad_update.launches == before + 1
    if a == d and decay == 1.0:
        assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)
    else:
        torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=0)
        torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=0)


def test_dedup_is_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(2)
    ids = torch.from_numpy((rng.zipf(1.2, size=180224) % (1 << 20)).astype(np.int32)).to(cuda)
    grads = torch.from_numpy(rng.normal(size=(180224, 9)).astype(np.float32)).to(cuda)
    u1, g1 = dedup_rows(ids, grads)
    u2, g2 = dedup_rows(ids, grads)
    assert torch.equal(u1, u2) and torch.equal(g1, g2)
    uc, gc = dedup_rows(ids.cpu(), grads.cpu())
    assert torch.equal(u1.cpu(), uc)
    torch.testing.assert_close(g1.cpu(), gc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("body", ["default", "decayed", "pallas"])
def test_every_step_body_runs_the_tail_kernel_on_the_card(cuda, body):
    """No step body takes the plain tail on a CUDA state: each step is one
    launch of the rows Adagrad kernel, and the state matches the CPU twin's."""
    model = FMModel(vocabulary_size=4096, factor_num=8, order=3)
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(0, 4096, size=(64, 11)).astype(np.int32))
    batch = Batch(
        labels=torch.from_numpy(rng.integers(0, 2, size=64).astype(np.float32)),
        ids=ids,
        vals=torch.from_numpy(rng.uniform(0.1, 1.0, size=(64, 11)).astype(np.float32)),
        fields=torch.zeros((64, 0), dtype=torch.int32),
        weights=torch.ones(64),
    )
    bodies = {"default": None, "decayed": make_decayed_body(0.9), "pallas": make_pallas_tail_body()}
    states = {}
    for dev in ("cpu", cuda):
        gen = torch.Generator(device="cpu").manual_seed(3)
        st = init_state(model, gen)
        st.table, st.table_accum = st.table.to(dev), st.table_accum.to(dev)
        step = make_train_step(model, 0.05, body=bodies[body])
        before = rows_tail_adagrad_update.launches
        for _ in range(3):
            st, _ = step(st, batch.to(dev))
        torch.cuda.synchronize()
        launched = rows_tail_adagrad_update.launches - before
        assert launched == (3 if dev == cuda else 0)
        states[str(dev)] = st
    cpu, card = states["cpu"], states[str(cuda)]
    torch.testing.assert_close(card.table.cpu(), cpu.table, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(card.table_accum.cpu(), cpu.table_accum, rtol=1e-5, atol=1e-7)
