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
from fast_tffm_tpu_torch.ops.packed_table import (
    fused_rows_per_tile,
    fused_slots,
    pack_fused,
    unpack_fused,
)
from fast_tffm_tpu_torch.ops.tail import (
    fused_adagrad_plain,
    fused_tail_adagrad_update,
    fused_tail_apply,
    rows_tail_adagrad_update,
)
from fast_tffm_tpu_torch.optim import dedup_rows, sparse_adagrad_update
from fast_tffm_tpu_torch.trainer import (
    init_state,
    make_decayed_body,
    make_packed_train_step,
    make_pallas_tail_body,
    make_train_step,
    pack_state,
    unpack_state,
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


def _case_ids(rng, v, m, ids_from):
    """[M] occurrence ids, and the occurrences whose gradient is zero.
    "padded": a 1000-of-16384-row batch padded the way data/libsvm.pad_batch
    pads it, every pad slot id 0 with a zero gradient; "hot": the same ids
    with non-zero gradients; "out of range": ids below 0 and past V."""
    zero = np.zeros(m, bool)
    if ids_from in ("padded", "hot"):
        real = max(1, m * 1000 // 16384)
        ids = np.zeros(m, np.int64)
        ids[:real] = rng.integers(0, v, size=real)
        if ids_from == "padded":
            zero[real:] = True
    else:
        ids = {
            "zipf": lambda: rng.zipf(1.3, size=m) % v,
            "uniform": lambda: rng.integers(0, v, size=m),
            "unique": lambda: rng.choice(v, size=m, replace=False),
            "out of range": lambda: rng.zipf(1.3, size=m) % (v + 64) - 32,
        }[ids_from]()
    return ids.astype(np.int32), zero


def _tail_case(rng, v, d, a, m, ids_from):
    table = rng.uniform(-0.1, 0.1, size=(v, d)).astype(np.float32)
    accum = rng.uniform(0.1, 0.5, size=(v, a)).astype(np.float32)
    ids, zero = _case_ids(rng, v, m, ids_from)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    grads[zero] = 0.0
    return table, accum, ids, grads


@pytest.mark.parametrize(
    "v,d,a,m,decay,ids_from",
    [
        (4096, 9, 9, 2000, 1.0, "zipf"),
        (4096, 9, 1, 2000, 1.0, "zipf"),
        (4096, 9, 9, 2000, 0.9, "zipf"),
        (4096, 9, 1, 2000, 0.9, "zipf"),
        (64, 9, 9, 1, 1.0, "zipf"),  # K = 1
        (1 << 20, 9, 9, 180224, 1.0, "zipf"),  # baseline5 width
        (1 << 20, 9, 9, 180224, 1.0, "padded"),  # id 0 ~169K times: the block path
        (1 << 20, 9, 1, 180224, 0.9, "hot"),
        (4096, 9, 9, 2000, 1.0, "out of range"),
        (4096, 9, 1, 2000, 0.9, "out of range"),
        (4096, 17, 17, 3000, 1.0, "hot"),  # factor_num 16
        (4096, 17, 1, 3000, 0.9, "zipf"),
        (300, 64, 64, 3000, 1.0, "hot"),  # wider than a warp: the block path only
        (300, 64, 1, 3000, 0.9, "zipf"),
    ],
)
def test_rows_tail_kernel_matches_twin(cuda, v, d, a, m, decay, ids_from):
    """B4 on the sort's output against its twin (the dedup, then the plain
    update) on the card, bitwise in both accumulator modes and at γ < 1:
    the twin pins every order (the card's ``segment_reduce`` adds left to
    right, ``accum_sq`` sums ‖g‖² in d order, γ·acc is its own multiply);
    ids outside [0, V) left alone."""
    rng = np.random.default_rng(v + d + a + m)
    table, accum, ids, grads = _tail_case(rng, v, d, a, m, ids_from)
    t_k, a_k = torch.from_numpy(table).to(cuda), torch.from_numpy(accum).to(cuda)
    t_p, a_p = t_k.clone(), a_k.clone()
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    before = rows_tail_adagrad_update.launches
    rows_tail_adagrad_update(t_k, a_k, ids_t, g_t, 0.05, decay=decay)
    sparse_adagrad_update(t_p, a_p, ids_t, g_t, 0.05, decay=decay)
    torch.cuda.synchronize()
    assert rows_tail_adagrad_update.launches == before + 1
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)
    assert not torch.equal(a_k, torch.from_numpy(accum).to(cuda))


def test_dedup_is_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(2)
    ids = torch.from_numpy((rng.zipf(1.2, size=180224) % (1 << 20)).astype(np.int32)).to(cuda)
    grads = torch.from_numpy(rng.normal(size=(180224, 9)).astype(np.float32)).to(cuda)
    u1, g1 = dedup_rows(ids, grads)
    u2, g2 = dedup_rows(ids, grads)
    assert torch.equal(u1, u2) and torch.equal(g1, g2)
    uc, gc = dedup_rows(ids.cpu(), grads.cpu())
    assert torch.equal(u1.cpu(), uc)
    assert torch.equal(g1.cpu(), gc)  # both add each segment left to right from 0


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


def _fused_case(rng, v, d, m, ids_from, cuda):
    table = torch.from_numpy(rng.uniform(-0.1, 0.1, size=(v, d)).astype(np.float32)).to(cuda)
    accum = torch.from_numpy(rng.uniform(0.1, 0.5, size=(v, 1)).astype(np.float32)).to(cuda)
    ids, zero = _case_ids(rng, v, m, ids_from)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    grads[zero] = 0.0
    return table, accum, torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)


@pytest.mark.parametrize(
    "v,d,m,ids_from,decay",
    [
        ((1 << 20), 9, 180224, "uniform", 1.0),  # baseline5's batch: K ~ 165k of 2^20
        ((1 << 20), 9, 180224, "zipf", 0.9),
        ((1 << 20), 9, 180224, "padded", 1.0),  # id 0 ~169K times: the block path
        (100, 9, 1, "unique", 1.0),  # K = 1
        (4099, 9, 1001, "unique", 1.0),  # K = 1001; V off the tile row (4099 % 12 = 7)
        (4099, 9, 3000, "hot", 0.9),
        (4099, 9, 3000, "out of range", 1.0),  # ids < 0 and >= VPf·P skipped
        (640, 7, 3000, "zipf", 1.0),  # D + 1 = 8 divides 128
        (4099, 17, 3000, "hot", 1.0),  # factor_num 16: 2-lane float2 slots
        (300, 64, 500, "zipf", 1.0),  # P = 1, wider than a warp: the block path
        (300, 64, 3000, "hot", 0.9),
    ],
)
def test_fused_tail_kernel_is_bitwise_its_twin_and_the_rows_kernel(cuda, v, d, m, ids_from, decay):
    """B3 against its plain twin on the card (same dedup), and after
    unpacking against B4 in row mode on the logical clones: bitwise."""
    rng = np.random.default_rng(v + d + m)
    table, accum, ids, grads = _fused_case(rng, v, d, m, ids_from, cuda)
    fused = pack_fused(table, accum, 0.1)
    before = fused_tail_adagrad_update.launches
    got = fused_tail_adagrad_update(fused.clone(), ids, grads, 0.05, decay=decay)
    torch.cuda.synchronize()
    assert fused_tail_adagrad_update.launches == before + 1
    uids, gsum = dedup_rows(ids, grads)
    twin = fused_adagrad_plain(fused.clone(), uids, gsum, 0.05, decay)  # on the card
    assert torch.equal(got, twin)
    t_r, a_r = table.clone(), accum.clone()
    rows_tail_adagrad_update(t_r, a_r, ids, grads, 0.05, decay=decay)
    t_f, a_f = unpack_fused(got, v, d)
    assert torch.equal(t_f, t_r) and torch.equal(a_f, a_r)
    # Untouched slots, pad slots and tail lanes: bitwise unchanged.
    assert torch.equal(_blank_touched(got, ids, d), _blank_touched(fused, ids, d))
    assert not torch.equal(got, fused)


def _blank_touched(fused, ids, d):
    """``fused`` with the slots of ``ids`` zeroed: what the update must leave."""
    out = fused.clone()
    p = fused_rows_per_tile(d)
    i = ids.long().unique()
    i = i[(i >= 0) & (i < fused.shape[0] * p)]
    fused_slots(out, d)[i // p, i % p] = 0.0
    return out


def test_tail_updates_make_no_host_sync(cuda):
    """``*_update`` on a CUDA state is torch.sort plus one kernel launch and
    reads no tensor value on the host: it passes under sync debug mode
    "error" (which raises at any synchronising call)."""
    rng = np.random.default_rng(17)
    table, accum, ids, grads = _tail_case(rng, 4096, 9, 9, 2000, "zipf")
    t, a = torch.from_numpy(table).to(cuda), torch.from_numpy(accum).to(cuda)
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    fused = pack_fused(t, a[:, :1].contiguous(), 0.1)
    rows_tail_adagrad_update(t, a, ids_t, g_t, 0.05)  # builds and loads the kernels
    fused_tail_adagrad_update(fused, ids_t, g_t, 0.05)
    torch.cuda.synchronize()
    before = (rows_tail_adagrad_update.launches, fused_tail_adagrad_update.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows_tail_adagrad_update(t, a, ids_t, g_t, 0.05, decay=0.9)
        fused_tail_adagrad_update(fused, ids_t, g_t, 0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (rows_tail_adagrad_update.launches, fused_tail_adagrad_update.launches) == (
        before[0] + 1, before[1] + 1)


def test_fused_tail_launches_nothing_at_k0_and_refuses_what_it_does_not_take(cuda):
    fused = pack_fused(torch.zeros((24, 9), device=cuda), torch.full((24, 1), 0.1, device=cuda), 0.1)
    before = fused_tail_adagrad_update.launches
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    fused_tail_apply(fused, empty, torch.zeros((0, 9), device=cuda), 0.05)
    assert fused_tail_adagrad_update.launches == before
    uids = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    gsum = torch.ones((2, 9), device=cuda)
    with pytest.raises(ValueError):
        fused_tail_apply(fused, uids.long(), gsum, 0.05)  # int64 ids
    with pytest.raises(ValueError):
        fused_tail_apply(fused, uids, gsum.double(), 0.05)
    with pytest.raises(ValueError):
        fused_tail_apply(fused, uids, torch.ones((9, 2), device=cuda).t(), 0.05)  # not contiguous
    with pytest.raises(ValueError):
        fused_tail_apply(fused[:, :64], uids, gsum, 0.05)  # not [VPf, 128]
    with pytest.raises(ValueError):
        fused_tail_apply(fused, uids, torch.ones((3, 9), device=cuda), 0.05)
    assert fused_tail_adagrad_update.launches == before


def test_packed_fused_train_step_on_the_card_matches_the_cpu(cuda):
    """Three fused train steps (order 3): one B3 launch each, and the card's
    logical table and accumulator within 1e-7 of the CPU's."""
    model = FMModel(vocabulary_size=4099, factor_num=8, order=3)
    rng = np.random.default_rng(13)
    batch = Batch(
        labels=torch.from_numpy(rng.integers(0, 2, size=64).astype(np.float32)),
        ids=torch.from_numpy(rng.integers(0, 4099, size=(64, 11)).astype(np.int32)),
        vals=torch.from_numpy(rng.uniform(0.1, 1.0, size=(64, 11)).astype(np.float32)),
        fields=torch.zeros((64, 0), dtype=torch.int32),
        weights=torch.ones(64),
    )
    states = {}
    for dev in ("cpu", cuda):
        st = init_state(model, torch.Generator(device="cpu").manual_seed(3), 0.1, "row")
        st.table, st.table_accum = st.table.to(dev), st.table_accum.to(dev)
        st = pack_state(st, 0.1, fused=True)
        step = make_packed_train_step(model, 0.05)
        before = fused_tail_adagrad_update.launches
        for _ in range(3):
            st, _ = step(st, batch.to(dev))
        torch.cuda.synchronize()
        assert fused_tail_adagrad_update.launches - before == (3 if dev == cuda else 0)
        states[str(dev)] = unpack_state(st, model)
    cpu, card = states["cpu"], states[str(cuda)]
    torch.testing.assert_close(card.table.cpu(), cpu.table, rtol=0, atol=1e-7)
    torch.testing.assert_close(card.table_accum.cpu(), cpu.table_accum, rtol=0, atol=1e-7)
