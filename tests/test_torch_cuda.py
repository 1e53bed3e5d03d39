"""Port kernels on the card: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device and nvcc; elsewhere every test skips.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The order-2 FM score and L2 pair (``csrc/fm2_score.cu``) is held to its
plain twin at the benchmark cells' widths and ragged shapes, bitwise across
calls and for an example scored alone or in a batch, and refuses a
gradient for the values.  The K-step CUDA graphs (``steps_per_call``) are
held bitwise against the eager steps they replay (the order-2 FM and DeepFM
among them), and a failed build of the native parser raises.
The rows tail at the packed address is held bitwise to its twin and to the
rows layout's update; a stopped and resumed card run (streamed, and cached
at K = 8) bitwise to the uninterrupted one; the dedup body captures in a
K = 8 graph.  An async save's snapshot holds the boundary's bits though the
next in-place step and K = 8 replay are launched right behind it; the
touched-row bitmap after a K = 8 replay is its batches' unique ids; a delta
chain written on the card replays bitwise; ``device_live_bytes`` makes no
device sync.  A rollback at K = 8 restores into the graph's own state (one
capture) and ends bitwise its reference; accumulator restarts inside a
K = 8 graph are bitwise the eager run's.  A ``[ParamStore]`` card run is
bitwise the resident run at K = 1 and 8; the packed wire's side-stream copy
and unpack give the arrays path's batch, a ring of two pinned buffers under
a queue of twelve never refills one under its copy, and packed training is
bitwise arrays at K = 1 and 8.  The sharded update's shard apply at base > 0
(R = 2 and 4) is bitwise its twin and the whole-table update, and
``dist_train`` at world size 1 is bitwise ``train`` on each layout, K = 8
and alltoall; the resident epoch's sharded step at world size 1 (K = 1,
and K = 8 in one graph) is bitwise the cached train step, and cached
``dist_train`` with deltas bitwise cached ``train``.
"""

import os

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.data import device_cache
from fast_tffm_tpu_torch.ops import kernel_build

from fast_tffm_tpu_torch.ops.anova import (
    MAX_ORDER,
    anova_inter,
    anova_inter_bwd,
    anova_inter_bwd_plain,
    anova_inter_plain,
)
from fast_tffm_tpu_torch.models import Batch, DCNv2Model, DeepFMModel, FFMModel, FMModel
from fast_tffm_tpu_torch.ops.dcn import (
    X0Grad,
    cross_combine,
    cross_fwd_plain,
    dcn_cross_bwd,
    dcn_cross_fwd,
)
from fast_tffm_tpu_torch.ops.fm import (
    _FmScoreOrder2,
    fm2_score_bwd,
    fm2_score_fwd,
    fm2_score_l2,
    fm_score,
    masked_l2,
)
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
    make_scanned_train_step,
    make_train_step,
    pack_state,
    packed_train_step_body,
    train_step_body,
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


FM2_LAMBDAS = (0.3, 0.7)  # large enough that the L2 term's gradient shows beside the score's


def _fm2_case(rng, b, n, d, offset=0, cuda=None):
    """Rows [B, N, D] ~ N(0, 0.3²) (``offset`` floats into their storage, so
    not 16-byte aligned when it is not a multiple of 4), values in (0.1, 1]
    with the last slot padding (N > 1), the first and last example all
    padding."""
    flat = rng.normal(size=offset + b * n * d).astype(np.float32) * 0.3
    rows = torch.from_numpy(flat).to(cuda)[offset:].view(b, n, d)
    vals = rng.uniform(0.1, 1.0, size=(b, n)).astype(np.float32)
    if n > 1:
        vals[:, -1] = 0.0
    vals[0, :] = vals[-1, :] = 0.0
    return rows, torch.from_numpy(vals).to(cuda)


def _fm2_pair(rows, vals, g, g_reg, fn=fm2_score_l2):
    """(scores, L2 term, d_rows) of ``fn`` under the cotangents g [B], g_reg."""
    r = rows.detach().requires_grad_(True)
    scores, reg = fn(r, vals, *FM2_LAMBDAS)
    (d_rows,) = torch.autograd.grad((scores, reg), r, (g, g_reg))
    return scores.detach(), reg.detach(), d_rows


def _fm2_twin(rows, vals, lam_b, lam_f):
    return _FmScoreOrder2.apply(rows, vals), masked_l2(rows, vals, lam_b, lam_f)


@pytest.mark.parametrize(
    "b,n,d,offset",
    [
        (16384, 39, 17, 0),  # fm2_criteo1tb's batch: D 17
        (8192, 39, 9, 0),  # deepfm_criteo1tb's: D 9
        (13, 11, 2, 0),  # B off the block edge (8 examples a block), k 1
        (130, 7, 5, 0),  # ragged: N·D 35, every example at another 16-byte offset
        (130, 7, 5, 1),  # rows not 16-byte aligned: the scalar copies
        (4, 1, 17, 0),  # one feature
        (40, 3, 65, 0),  # D above a warp: a lane owns 3 columns
        (9, 100, 33, 0),  # N·D 3,300 past a warp's shared memory: read from device memory
    ],
)
def test_fm2_kernel_pair_matches_the_plain_twin(cuda, b, n, d, offset):
    """Scores, the L2 term and d_rows of the kernel pair against the plain
    twin (``_FmScoreOrder2`` + ``masked_l2`` under autograd) on the card.
    Both sum the same float32 terms in other orders (the kernel over the
    features in order, then a butterfly over the lanes; the twin's ATen
    reductions by trees), so scores and d_rows are held within 1e-5 of the
    largest magnitude among them (~80 ulps of it: a sum of 39 terms may
    differ by a few ulps of its partial sums, and s1² − s2 cancels), the
    L2 term, a sum of B·N·D squares, within rtol 1e-5.  One forward and one
    backward launch a call."""
    rng = np.random.default_rng(b + n + d + offset)
    rows, vals = _fm2_case(rng, b, n, d, offset, cuda)
    g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).to(cuda)
    g_reg = torch.tensor(1.7, device=cuda)
    before = (fm2_score_fwd.launches, fm2_score_bwd.launches)
    got = _fm2_pair(rows, vals, g, g_reg)
    torch.cuda.synchronize()
    assert (fm2_score_fwd.launches - before[0], fm2_score_bwd.launches - before[1]) == (1, 1)
    want = _fm2_pair(rows, vals, g, g_reg, _fm2_twin)
    for got_t, want_t in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(got_t, want_t, rtol=0,
                                   atol=1e-5 * float(want_t.abs().max()))
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert float(got[0][0]) == float(got[0][-1]) == 0.0  # all-padding examples score 0
    assert float(got[2][0].abs().max()) == 0.0  # ... and take no gradient


def test_fm2_kernel_pair_is_bitwise_reproducible_and_row_independent(cuda):
    """Two calls give the same bits; an example scored alone (a copy of its
    rows, at another 16-byte offset) gives the bits it gets inside the
    batch, its score and its d_rows.  No atomics, no sum across examples
    but the L2 term's."""
    rng = np.random.default_rng(41)
    rows, vals = _fm2_case(rng, 1031, 39, 17, 0, cuda)
    g = torch.from_numpy(rng.normal(size=1031).astype(np.float32)).to(cuda)
    g_reg = torch.tensor(0.9, device=cuda)
    one, two = _fm2_pair(rows, vals, g, g_reg), _fm2_pair(rows, vals, g, g_reg)
    assert all(torch.equal(a, b) for a, b in zip(one, two, strict=True))
    for j in (1, 2, 517, 1030):
        alone = _fm2_pair(rows[j : j + 1].clone(), vals[j : j + 1].clone(), g[j : j + 1], g_reg)
        assert torch.equal(alone[0], one[0][j : j + 1])
        assert torch.equal(alone[2], one[2][j : j + 1])
    with torch.inference_mode():  # predict and serving: the forward kernel alone
        before = (fm2_score_fwd.launches, fm2_score_bwd.launches)
        scores = fm_score(rows, vals, 2)
    assert (fm2_score_fwd.launches - before[0], fm2_score_bwd.launches - before[1]) == (1, 0)
    assert torch.equal(scores, one[0])


def test_fm2_kernel_refuses_a_gradient_for_vals(cuda):
    """The pair computes no d_vals: a CUDA ``vals`` that requires a
    gradient raises, through the pair and through ``fm_score``."""
    rows, vals = _fm2_case(np.random.default_rng(43), 16, 5, 9, 0, cuda)
    vals.requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient for vals"):
        fm2_score_l2(rows.requires_grad_(True), vals, *FM2_LAMBDAS)
    with pytest.raises(ValueError, match="no gradient for vals"):
        fm_score(rows, vals, 2)


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
        (1 << 20, 89, 89, 180224, 1.0, "zipf"),  # baseline3 (FFM, 22 fields x k 4): D = 89
        (1 << 20, 89, 1, 180224, 0.9, "uniform"),
        (4096, 89, 89, 3000, 0.9, "hot"),
        (4096, 89, 1, 3000, 1.0, "padded"),
        (1 << 20, 9, 9, 638976, 1.0, "zipf"),  # baseline1 (criteo): 16384 x 39 occurrences
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
        (4099, 89, 3000, "hot", 1.0),  # D = 89: P = 128 // 90 = 1, the widest slot
        ((1 << 20), 89, 180224, "uniform", 0.9),
        (4099, 89, 3000, "out of range", 1.0),
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


def _batches(rng, n, b=64, v=4099):
    return [
        Batch(
            labels=torch.from_numpy(rng.integers(0, 2, size=b).astype(np.float32)),
            ids=torch.from_numpy(rng.integers(0, v, size=(b, 11)).astype(np.int32)),
            vals=torch.from_numpy(rng.uniform(0.1, 1.0, size=(b, 11)).astype(np.float32)),
            fields=torch.zeros((b, 0), dtype=torch.int32),
            weights=torch.from_numpy(rng.uniform(0.0, 1.0, size=b).astype(np.float32)),
        )
        for _ in range(n)
    ]


def _card_state(model, fused, cuda):
    st = init_state(model, torch.Generator(device="cpu").manual_seed(5), 0.1,
                    "row" if fused else "element")
    st.table, st.table_accum = st.table.to(cuda), st.table_accum.to(cuda)
    return pack_state(st, 0.1, fused=True) if fused else st


@pytest.mark.parametrize("fused", [False, True], ids=["rows", "fused"])
def test_graph_replay_is_bitwise_the_eager_steps(cuda, fused):
    """K = 3 over 7 batches (groups 3, 3, 1): each group one replay of a
    captured graph, the losses and the state bitwise those of 7 eager
    steps.  The wrappers counted only the warm-ups' launches (3 + 1
    steps): a capture launches nothing, and a replay does not pass
    through a wrapper."""
    model = FMModel(vocabulary_size=4099, factor_num=8, order=3)
    batches = _batches(np.random.default_rng(17), 7)
    eager_step = (make_packed_train_step if fused else make_train_step)(model, 0.05)
    eager, want = _card_state(model, fused, cuda), []
    for b in batches:
        eager, loss = eager_step(eager, b.to(cuda))
        want.append(loss)
    body = packed_train_step_body if fused else train_step_body
    step = make_scanned_train_step(model, 0.05, body=body)
    tail_fn = fused_tail_adagrad_update if fused else rows_tail_adagrad_update
    anova_inter.launches = anova_inter_bwd.launches = tail_fn.launches = 0
    st, got = _card_state(model, fused, cuda), []
    for lo in range(0, 7, 3):
        group = batches[lo : lo + 3]
        sb = Batch(*(torch.stack([getattr(b, f) for b in group])
                     for f in ("labels", "ids", "vals", "fields", "weights")))
        st, losses = step(st, sb)  # a host superbatch, as training gives it
        got.append(losses)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert st.step == eager.step == 7
    assert torch.equal(st.table, eager.table)
    if not fused:
        assert torch.equal(st.table_accum, eager.table_accum)
    assert (step.graphs.captures, step.graphs.replays) == (2, 3)
    assert anova_inter.launches == anova_inter_bwd.launches == tail_fn.launches == 4


@pytest.mark.parametrize("fused", [False, True], ids=["rows", "fused"])
def test_cached_graph_replay_is_bitwise_the_cached_eager_steps(cuda, fused):
    """The resident epoch, shuffled: K = 4 graph replays over 10 batches
    bitwise the eager K = 1 cached steps."""
    model = FMModel(vocabulary_size=4099, factor_num=8, order=3)
    rng = np.random.default_rng(19)
    batches = _batches(rng, 10)
    data = device_cache.DeviceDataset(
        *(torch.cat([getattr(b, f) for b in batches]).to(cuda)
          for f in ("labels", "ids", "vals", "fields", "weights")),
        batches=10, batch_size=64, n_rows=640,
        offsets=torch.arange(64, device=cuda),
    )
    device_cache.set_permutation(data, rng.permutation(640))
    body = packed_train_step_body if fused else train_step_body
    _, one = device_cache.make_cached_train_step(model, 0.05, data, body)
    eager, want = _card_state(model, fused, cuda), []
    for i in range(10):
        eager, loss = one(eager, torch.tensor(i, device=cuda))
        want.append(loss)
    _, scan = device_cache.make_cached_scan_train_step(model, 0.05, data, body)
    st, got = _card_state(model, fused, cuda), []
    for idxs in device_cache.epoch_index_chunks(10, 4, cuda):
        st, losses = scan(st, idxs)
        got.append(losses)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert torch.equal(st.table, eager.table) and st.step == 10
    assert scan.replays == 3 and scan.captures == 2


ZOO = {
    # λ > 0 on the order-2 models: the fm2_score pair folds the L2 term in.
    "fm2": lambda: FMModel(vocabulary_size=4099, factor_num=8, order=2, bias_lambda=1e-3,
                           factor_lambda=1e-3),
    "ffm": lambda: FFMModel(vocabulary_size=4099, num_fields=22, factor_num=4),
    "deepfm": lambda: DeepFMModel(vocabulary_size=4099, num_fields=11, factor_num=8,
                                  bias_lambda=1e-3, factor_lambda=1e-3),
    "deepfm_bf16": lambda: DeepFMModel(vocabulary_size=4099, num_fields=11, factor_num=8,
                                       compute_dtype="bfloat16"),
}


def _zoo_batches(rng, model, n, b=64):
    """Batches of the model's width: FFM 22 slots with field ids up to 23
    (the two past F one-hot to zeros), the others 11; two padding slots."""
    nnz = 22 if isinstance(model, FFMModel) else 11
    out = []
    for _ in range(n):
        vals = rng.uniform(0.1, 1.0, size=(b, nnz)).astype(np.float32)
        vals[:, -2:] = 0.0
        fields = rng.integers(0, 24, size=(b, nnz)).astype(np.int32)
        out.append(Batch(
            labels=torch.from_numpy(rng.integers(0, 2, size=b).astype(np.float32)),
            ids=torch.from_numpy(rng.integers(0, 4099, size=(b, nnz)).astype(np.int32)),
            vals=torch.from_numpy(vals),
            fields=torch.from_numpy(fields if model.uses_fields else fields[:, :0].copy()),
            weights=torch.ones(b),
        ))
    return out


def _zoo_state(model, dev):
    st = init_state(model, torch.Generator(device="cpu").manual_seed(7), 0.1, "element")
    st.table, st.table_accum = st.table.to(dev), st.table_accum.to(dev)
    st.dense = [p.to(dev) for p in st.dense]
    st.dense_accum = [a.to(dev) for a in st.dense_accum]
    return st


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_train_steps_on_the_card_match_the_cpu(cuda, name):
    """Three steps of each zoo model: one B4 launch a step, and for the
    order-2 FM and DeepFM one launch of each of the fm2_score pair, and no
    other kernel; the card's table and accumulators within 1e-7 of the CPU's,
    and the MLP's leaves and accumulators (DeepFM) within 1e-6.  At
    bfloat16 a gradient element may round to its other bfloat16 neighbour
    on one device (the float32 sums before the cast run in another
    order), moving its step by up to 2^-8: there each tensor is held
    within 2^-6 of its largest step (plus those atols)."""
    model = ZOO[name]()
    batches = _zoo_batches(np.random.default_rng(23), model, 3)
    states = {}
    for dev in ("cpu", cuda):
        st, step = _zoo_state(model, dev), make_train_step(model, 0.05)
        wrappers = (anova_inter, anova_inter_bwd, rows_tail_adagrad_update, fm2_score_fwd,
                    fm2_score_bwd)
        counts = [w.launches for w in wrappers]
        for b in batches:
            st, loss = step(st, b.to(dev))
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        launched = tuple(w.launches - c for w, c in zip(wrappers, counts, strict=True))
        pair = 0 if name == "ffm" else 3
        assert launched == ((0, 0, 3, pair, pair) if dev == cuda else (0,) * 5)
        states[str(dev)] = st
    cpu, card = states["cpu"], states[str(cuda)]
    init = _zoo_state(model, "cpu")
    share = 2.0**-6 if name.endswith("bf16") else 0.0
    pairs = [(card.table, cpu.table, init.table, 1e-7),
             (card.table_accum, cpu.table_accum, init.table_accum, 1e-7),
             *((a, b, c, 1e-6) for a, b, c in zip(card.dense + card.dense_accum,
                                                  cpu.dense + cpu.dense_accum,
                                                  init.dense + init.dense_accum, strict=True))]
    assert len(card.dense) == (8 if name.startswith("deepfm") else 0)
    for got, want, start, atol in pairs:
        step = float((want - start).abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol + share * step)


@pytest.mark.parametrize("name", ["ffm", "deepfm_bf16", "fm2", "deepfm"])
def test_zoo_graph_replay_is_bitwise_the_eager_steps(cuda, name):
    """K = 8 over 16 batches: two replays of one captured graph (cuBLAS
    products, FFM's one-hot and einsums, the order-2 FM's and DeepFM's
    fm2_score pair, DeepFM's dense update inside), the losses and the
    whole state bitwise 16 eager steps."""
    model = ZOO[name]()
    batches = _zoo_batches(np.random.default_rng(29), model, 16)
    eager_step, eager, want = make_train_step(model, 0.05), _zoo_state(model, cuda), []
    for b in batches:
        eager, loss = eager_step(eager, b.to(cuda))
        want.append(loss)
    step = make_scanned_train_step(model, 0.05)
    st, got = _zoo_state(model, cuda), []
    for lo in (0, 8):
        group = batches[lo : lo + 8]
        sb = Batch(*(torch.stack([getattr(b, f) for b in group])
                     for f in ("labels", "ids", "vals", "fields", "weights")))
        st, losses = step(st, sb)
        got.append(losses)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert st.step == eager.step == 16
    assert (step.graphs.captures, step.graphs.replays) == (1, 2)
    pairs = [(st.table, eager.table), (st.table_accum, eager.table_accum),
             *zip(st.dense, eager.dense), *zip(st.dense_accum, eager.dense_accum)]
    assert all(torch.equal(a, b) for a, b in pairs)


def test_native_parser_build_failure_raises(monkeypatch, tmp_path):
    """No g++, or a g++ that fails: the parser raises, and nothing parses
    in Python in its place."""
    from fast_tffm_tpu_torch.data.native import best_parser

    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernel_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        best_parser(2)
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="host build of libsvm_parser.cpp failed"):
        best_parser(2)
    assert not os.path.exists(tmp_path / "_build" / "liblibsvm_parser.so")


# --- the packed address, exact resume and dedup_gather_rows on the card ------


@pytest.mark.parametrize("d", [1, 9, 64, 89])  # P = 128, 14, 2, 1
@pytest.mark.parametrize("accumulator", ["element", "row"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_packed_tail_kernel_is_bitwise_its_twin_and_the_rows_kernel(cuda, d, accumulator, decay):
    """B4 at the packed address (P = max(1, 128 // D) rows a 128-float tile
    row) against its twin on the card, bitwise; ids below 0 or past VP·P
    skipped, pad lanes and slots untouched; unpacked, bitwise the rows
    kernel on the logical arrays."""
    from fast_tffm_tpu_torch.ops.packed_table import (
        pack_accum_any,
        pack_table,
        packed_rows,
        rows_per_tile,
        unpack_accum_any,
        unpack_table,
    )
    from fast_tffm_tpu_torch.ops.tail import rows_tail_sorted_plain

    v, m = 4099, 3000
    p, a = rows_per_tile(d), d if accumulator == "element" else 1
    rng = np.random.default_rng(d * 10 + a)
    table, accum, ids, grads = _tail_case(rng, v, d, a, m, "zipf")
    ids[:40] = rng.integers(-32, 0, 40)
    ids[40:50] = packed_rows(v, d) * p + 5  # past the packed rows
    ids[50:400] = 0
    grads[50:400] = 0.0  # padding slots
    tp = pack_table(torch.from_numpy(table)).to(cuda)
    ap = pack_accum_any(torch.from_numpy(accum), d, 0.1).to(cuda)
    t_k, a_k, t_p, a_p = tp.clone(), ap.clone(), tp.clone(), ap.clone()
    ids_t, g_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    before = rows_tail_adagrad_update.launches
    rows_tail_adagrad_update(t_k, a_k, ids_t, g_t, 0.05, decay=decay, packed=True)
    sid, order = torch.sort(ids_t, stable=True)
    rows_tail_sorted_plain(t_p, a_p, sid, order, g_t, 0.05, decay, packed=True)
    torch.cuda.synchronize()
    assert rows_tail_adagrad_update.launches == before + 1
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)
    assert torch.equal(t_k[:, p * d:], tp[:, p * d:])  # pad lanes
    pad = (-v) % p * d
    if pad:
        assert torch.equal(t_k[-1, p * d - pad : p * d], tp[-1, p * d - pad : p * d])
    t_r, a_r = torch.from_numpy(table).to(cuda), torch.from_numpy(accum).to(cuda)
    rows_tail_adagrad_update(t_r, a_r, ids_t, g_t, 0.05, decay=decay)
    assert torch.equal(unpack_table(t_k, v, d), t_r)
    assert torch.equal(unpack_accum_any(a_k, v, d), a_r)
    assert not torch.equal(a_r, torch.from_numpy(accum).to(cuda))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _resume_cfg(tmp_path, name, **kw):
    from fast_tffm_tpu_torch.config import Config

    return Config(
        model="fm", order=3, factor_num=8, vocabulary_size=256, max_nnz=8, batch_size=20,
        epoch_num=2, learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=3,
        thread_num=2, model_file=str(tmp_path / name),
        train_files=(str(tmp_path / "train.libsvm"),),
        validation_files=(str(tmp_path / "test.libsvm"),), **kw,
    ).validate()


@pytest.mark.parametrize(
    "mode",
    [dict(), dict(device_cache=True, binary_cache=True, shuffle=True, steps_per_call=8)],
    ids=["streamed", "cached-shuffle-K8"],
)
def test_stopped_and_resumed_card_run_is_bitwise_the_uninterrupted_one(
        cuda, tmp_path, monkeypatch, mode):
    """A card run stopped by SIGTERM from its step hook (at step 23: the
    K = 8 run stops at the call ending at step 28, epoch 1 batch 8) and
    resumed ends bitwise equal to the uninterrupted card run; the
    K-aligned resume captures no graph beyond the one length-8 graph (and
    the epoch's length-4 tail graph) an uninterrupted run captures."""
    import shutil
    import signal

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState
    from fast_tffm_tpu_torch.training import train
    from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    rng = np.random.default_rng(23)
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, 9), 0.1)))
    captures = []
    real = StepGraphs._capture
    monkeypatch.setattr(StepGraphs, "_capture",
                        lambda self, *a: captures.append(1) or real(self, *a))
    runs = {}
    for name in ("whole", "cut"):
        cfg = _resume_cfg(tmp_path, f"{name}.ckpt", **mode)
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
        runs[name] = cfg
    quiet = lambda *_: None  # noqa: E731
    want = train(runs["whole"], resume=True, log=quiet, device="cuda")
    whole_captures, captures[:] = len(captures), []
    fired = []

    def hook(step):
        if step >= 23 and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    train(runs["cut"], resume=True, log=quiet, device="cuda", step_hook=hook)
    k = runs["cut"].steps_per_call
    assert fired == [23 if k == 1 else 28]
    cursor = read_input_cursor(runs["cut"].model_file)
    assert (cursor["epoch"], cursor["batch_in_epoch"]) == divmod(fired[0], 20)
    captures[:] = []
    got = train(runs["cut"], resume=True, log=quiet, device="cuda")
    torch.cuda.synchronize()
    assert got.step == want.step == 40
    assert torch.equal(got.table, want.table) and torch.equal(got.table_accum, want.table_accum)
    if k > 1:
        assert whole_captures == 2 and len(captures) == 2  # lengths 8 and 4 (20 = 8 + 8 + 4)


@pytest.mark.parametrize("k", [1, 8])
def test_dedup_gather_rows_card_run_is_bitwise_the_plain_run(cuda, tmp_path, monkeypatch, k):
    """``dedup_gather_rows`` on the card (the port gathers directly and
    checks the cap): bitwise the plain run, at K = 8 in the plain run's
    graphs; a cap below a batch's unique ids raises before any launch."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState
    from fast_tffm_tpu_torch.training import train
    from fast_tffm_tpu_torch.utils.prefetch import PrefetchError
    from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    rng = np.random.default_rng(29)
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, 9), 0.1)))
    captures = []
    real = StepGraphs._capture
    monkeypatch.setattr(StepGraphs, "_capture",
                        lambda self, *a: captures.append(1) or real(self, *a))
    runs = {}
    for name, cap in (("plain", 0), ("dedup", 20 * 8), ("small", 4)):
        runs[name] = _resume_cfg(tmp_path, f"{name}.ckpt", steps_per_call=k,
                                 dedup_gather_rows=cap)
        shutil.copy(tmp_path / "init.ckpt", runs[name].model_file)
    quiet = lambda *_: None  # noqa: E731
    want = train(runs["plain"], resume=True, log=quiet, device="cuda")
    plain_captures, captures[:] = len(captures), []
    got = train(runs["dedup"], resume=True, log=quiet, device="cuda")
    torch.cuda.synchronize()
    assert got.step == want.step == 40
    assert torch.equal(got.table, want.table) and torch.equal(got.table_accum, want.table_accum)
    assert len(captures) == plain_captures == (0 if k == 1 else 2)
    before = rows_tail_adagrad_update.launches
    with pytest.raises(PrefetchError, match="dedup_gather_rows = 4 but a batch carries"):
        train(runs["small"], resume=True, log=quiet, device="cuda")
    assert rows_tail_adagrad_update.launches == before


# --- async and delta checkpoints, telemetry ------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["rows", "fused"])
def test_async_snapshot_is_the_boundary_state_though_launches_follow_at_once(
        cuda, tmp_path, fused):
    """An async save boundary clones the state on the compute stream; the
    next eager step (B4 or B3 in place) and the next K = 8 replay are
    launched right behind it, and the writer's D2H runs on its own stream:
    the file holds the boundary's bits."""
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer

    model = FMModel(vocabulary_size=1 << 20, factor_num=8, order=3)
    batches = _batches(np.random.default_rng(31), 10, b=4096, v=1 << 20)
    body = packed_train_step_body if fused else train_step_body
    eager = (make_packed_train_step if fused else make_train_step)(model, 0.05)
    graph = make_scanned_train_step(model, 0.05, body=body)
    st = _card_state(model, fused, cuda)
    st, _ = eager(st, batches[0].to(cuda))
    stack = lambda group: Batch(*(torch.stack([getattr(b, f) for b in group])  # noqa: E731
                                  for f in ("labels", "ids", "vals", "fields", "weights")))
    st, _ = graph(st, stack(batches[1:9]))  # the capture happens before the boundary
    torch.cuda.synchronize()
    want = unpack_state(st, model)
    want_table, want_accum = want.table.cpu().clone(), want.table_accum.cpu().clone()
    path = str(tmp_path / "m.ckpt")
    ck = AsyncCheckpointer(path, device=cuda, async_save=True, chunk_bytes=4 << 20, log=print)
    ck.save_boundary(st, lambda s: unpack_state(s, model), st.step)
    st, _ = eager(st, batches[9].to(cuda))  # in place, right behind the snapshot
    st, _ = graph(st, stack(batches[1:9]))  # a replay overwrites the static state
    ck.finalize()
    assert ck.full_saves == 1 and ck.write_failures == 0
    got = restore_checkpoint(path, torch.device("cpu"), accum_width=1 if fused else 9)
    assert got.step == 9
    assert torch.equal(got.table, want_table) and torch.equal(got.table_accum, want_accum)
    assert not torch.equal(unpack_state(st, model).table.cpu(), want_table)  # it moved on


@pytest.mark.parametrize("shuffled", [False, True])
def test_touched_rows_after_a_k8_replay_are_its_batches_unique_ids(cuda, shuffled):
    """The delta bitmap marked after a K = 8 replay, from the resident ids
    through the call's indices (and, streamed, from the graph's static
    buffers), holds exactly the unique ids of the 8 batches."""
    model = FMModel(vocabulary_size=4099, factor_num=8, order=3)
    rng = np.random.default_rng(37)
    batches = _batches(rng, 16)
    data = device_cache.DeviceDataset(
        *(torch.cat([getattr(b, f) for b in batches]).to(cuda)
          for f in ("labels", "ids", "vals", "fields", "weights")),
        batches=16, batch_size=64, n_rows=1024, offsets=torch.arange(64, device=cuda),
    )
    perm = rng.permutation(1024)
    device_cache.set_permutation(data, perm)
    step, step_shuffled = device_cache.make_cached_scan_train_step(model, 0.05, data)
    scan = step_shuffled if shuffled else step
    st = _card_state(model, False, cuda)
    host_ids = torch.cat([b.ids for b in batches]).numpy()
    for idxs in device_cache.epoch_index_chunks(16, 8, cuda):
        st, _ = scan(st, idxs)
        bitmap = torch.zeros(4099, dtype=torch.bool, device=cuda)
        bitmap.index_fill_(0, device_cache.call_ids(data, idxs, shuffled).reshape(-1).long(), True)
        rows = (idxs.cpu().numpy()[:, None] * 64 + np.arange(64)).reshape(-1)
        want = np.unique(host_ids[perm[rows] if shuffled else rows])
        assert np.array_equal(torch.nonzero(bitmap).reshape(-1).cpu().numpy(), want)
    streamed = make_scanned_train_step(model, 0.05)
    group = batches[:8]
    st, _ = streamed(st, Batch(*(torch.stack([getattr(b, f) for b in group])
                                 for f in ("labels", "ids", "vals", "fields", "weights"))))
    bitmap = torch.zeros(4099, dtype=torch.bool, device=cuda)
    bitmap.index_fill_(0, streamed.last_batch().ids.reshape(-1).long(), True)
    assert streamed.last_batch().ids.device.type == "cuda"
    want = np.unique(torch.stack([b.ids for b in group]).numpy())
    assert np.array_equal(torch.nonzero(bitmap).reshape(-1).cpu().numpy(), want)


def test_device_live_bytes_makes_no_sync(cuda):
    from fast_tffm_tpu_torch.telemetry import device_live_bytes

    table = torch.zeros((1 << 20, 9), device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # keeps the stream busy for about a second
    live, peak = device_live_bytes(cuda)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "device_live_bytes waited for the device"
    assert peak >= live >= table.numel() * 4


@pytest.mark.parametrize("k", [1, 8])
def test_a_k_step_delta_chain_replays_bitwise_on_the_card(cuda, tmp_path, k):
    """delta_every_steps = 8 on the card (K = 8: device-cached, a graph per
    8 steps), aborted at step 16: base@8 + delta@16 restores bitwise the
    full save of a run stopped at 16, and async + delta runs end bitwise
    their synchronous run."""
    import shutil
    import signal

    from fast_tffm_tpu_torch.checkpoint import delta_paths, restore_checkpoint, save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState
    from fast_tffm_tpu_torch.training import train

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    rng = np.random.default_rng(41)
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, 9), 0.1)))
    mode = dict(device_cache=True, binary_cache=True, shuffle=True, steps_per_call=8) \
        if k > 1 else {}
    runs = {}
    for name, kw in (("delta", dict(delta_every_steps=8)), ("stop", {}),
                     ("fast", dict(delta_every_steps=8, async_save=True)), ("sync", {})):
        runs[name] = _resume_cfg(tmp_path, f"{name}.ckpt", **mode, **kw)
        shutil.copy(tmp_path / "init.ckpt", runs[name].model_file)
    quiet = lambda *_: None  # noqa: E731

    class Abort(Exception):
        pass

    def abort(step):
        if step >= 16:
            raise Abort()

    with pytest.raises(Abort):
        train(runs["delta"], resume=True, log=quiet, device="cuda", step_hook=abort)
    assert len(delta_paths(runs["delta"].model_file)) == 1
    fired = []

    def stop(step):
        if step >= 16 and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    train(runs["stop"], resume=True, log=quiet, device="cuda", step_hook=stop)
    cpu = torch.device("cpu")
    a = restore_checkpoint(runs["delta"].model_file, cpu, accum_width=9)
    b = restore_checkpoint(runs["stop"].model_file, cpu, accum_width=9)
    assert a.step == b.step == 16
    assert torch.equal(a.table, b.table) and torch.equal(a.table_accum, b.table_accum)
    got = train(runs["fast"], resume=True, log=quiet, device="cuda")
    want = train(runs["sync"], resume=True, log=quiet, device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got.table, want.table) and torch.equal(got.table_accum, want.table_accum)


def _serving_chain(tmp_path, v, rows):
    """A seeded order-3 FM (k 8) base at step 1 and one delta at step 2
    rewriting ``rows`` random rows; returns the config and the delta's
    path, parked beside the chain until the test lands it."""
    from fast_tffm_tpu_torch.checkpoint import checkpoint_save_id, save_checkpoint, save_delta
    from fast_tffm_tpu_torch.config import Config
    from fast_tffm_tpu_torch.trainer import TrainState

    rng = np.random.default_rng(43)
    path = str(tmp_path / "serve.ckpt")
    save_checkpoint(path, TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (v, 9)).astype(np.float32)), dense=[],
        step=1, table_accum=torch.full((v, 1), 0.1)))
    idx = np.sort(rng.choice(v, size=rows, replace=False))
    out, _, _ = save_delta(
        path, 1, idx=idx, table_rows=rng.uniform(-0.3, 0.3, (rows, 9)).astype(np.float32),
        accum_rows=np.full((rows, 1), 0.2, np.float32), dense_leaves=[], dense_accum_leaves=[],
        step=2, parent_sig=checkpoint_save_id(path))
    parked = str(tmp_path / "parked.npz")
    os.replace(out, parked)
    cfg = Config(model="fm", order=3, factor_num=8, vocabulary_size=v, max_nnz=11,
                 model_file=path, serve_flush_deadline_ms=0.0).validate()
    return cfg, parked, out


@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_a_flush_racing_a_delta_apply_scores_one_whole_checkpoint(cuda, tmp_path, layout):
    """A flush loop on the card while reload_once applies a 400K-row delta
    to a 2^20-row table: every flush's scores equal, bitwise, the base's or
    the delta head's (never a mix), both are seen, and the table served
    before the swap is unchanged."""
    import dataclasses
    import threading
    import time

    from fast_tffm_tpu_torch.serving import ServingEngine

    cfg, parked, landed = _serving_chain(tmp_path, 1 << 20, 400_000)
    cfg = dataclasses.replace(cfg, table_layout=layout).validate()
    rng = np.random.default_rng(44)
    ids = rng.integers(0, 1 << 20, size=(64, 11)).astype(np.int32)
    vals = rng.uniform(0.05, 1.0, size=(64, 11)).astype(np.float32)
    quiet = lambda *_: None  # noqa: E731

    def scores(eng):
        st, sc = eng.submit_block(ids, vals).result(timeout=60)
        assert not st.any()
        return np.asarray(sc)

    with ServingEngine(cfg, log=quiet, device="cuda") as eng:
        base = scores(eng)
        live = eng._state.table
        live_copy = live.clone()
        seen, stop = [], threading.Event()

        def loop():
            while not stop.is_set():
                seen.append(scores(eng))

        t = threading.Thread(target=loop)
        t.start()
        try:
            os.replace(parked, landed)
            assert eng.reload_once()["status"] == "staged_delta"
            deadline = time.monotonic() + 60
            while eng.step != 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            n = len(seen)
            while len(seen) < n + 5 and time.monotonic() < deadline:
                time.sleep(0.001)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive() and eng.step == 2
        assert torch.equal(live, live_copy)
    with ServingEngine(cfg, log=quiet, device="cuda") as fresh:
        head = scores(fresh)
    assert not np.array_equal(base, head)
    kinds = [0 if np.array_equal(s, base) else 1 if np.array_equal(s, head) else -1
             for s in seen]
    assert -1 not in kinds, "a flush scored a mix of two checkpoints"
    assert 0 in kinds and 1 in kinds
    assert kinds == sorted(kinds)  # once swapped, never back


def test_a_replica_without_a_card_refuses_to_start(tmp_path, monkeypatch):
    """With no CUDA device visible, a replica started without --device cpu
    raises before REPLICA_READY, and a router over such replicas fails its
    bring-up typed (Unavailable); --device cpu starts and announces."""
    import subprocess
    import sys

    from fast_tffm_tpu_torch.serving.protocol import REPLICA_READY_PREFIX, Unavailable
    from fast_tffm_tpu_torch.serving.router import Router, spawn_replica

    cfg, _, _ = _serving_chain(tmp_path, 1024, 10)
    cfg_path = tmp_path / "run.cfg"
    cfg_path.write_text(
        f"[General]\nmodel = fm\norder = 3\nfactor_num = 8\nvocabulary_size = 1024\n"
        f"model_file = {cfg.model_file}\n[Train]\nmax_nnz = 11\n"
        "[Serving]\nbuckets = 1 8\nreplicas = 2\n[Resilience]\nrestart_max = 0\n"
    )
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "fast_tffm_tpu_torch.serving.replica", str(cfg_path),
           "--port", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and REPLICA_READY_PREFIX not in out.stdout
    assert "no CUDA device" in out.stderr
    with pytest.raises(Unavailable):
        Router(cfg, config_path=str(cfg_path), log=lambda *a: None)
    handle = spawn_replica(str(cfg_path), 0, device="cpu", log=lambda *a: None,
                           ready_timeout_s=120)
    try:
        assert handle.port > 0 and handle.alive()
    finally:
        handle.kill()
        handle.wait(timeout=30)


def _rollback_cfg(tmp_path, name, **kw):
    """The resume tests' model on data/train.libsvm's FMB cache at 25 rows a
    batch (16 batches an epoch, two K = 8 calls), 2 epochs, a save every
    epoch, the device cache at K = 8."""
    from fast_tffm_tpu_torch.config import Config

    base = dict(
        model="fm", order=3, factor_num=8, vocabulary_size=256, max_nnz=8, batch_size=25,
        epoch_num=2, learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=8,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        binary_cache=True, device_cache=True, steps_per_call=8, save_every_epochs=1,
        metrics_path=str(tmp_path / (name + ".jsonl")),
    )
    base.update(kw)
    return Config(**base).validate()


def _seeded_npz(tmp_path):
    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState

    rng = np.random.default_rng(29)
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, 9), 0.1)))


def test_a_k8_rollback_keeps_one_capture_and_is_bitwise_its_reference(cuda, tmp_path,
                                                                      monkeypatch):
    """on_nan = rollback at K = 8 on the device cache: nan@20:25 poisons the
    call that ends at step 24; the log point raises with the cursor (1, 8),
    the step-16 save is copied into the live tensors and the run trains
    batches 8-15 of epoch 1.  The rollback makes no second CUDA-graph
    capture, and the run ends bitwise the run that resumes the step-16
    save at (1, 8)."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, save_checkpoint
    from fast_tffm_tpu_torch.resilience import FaultPlan, clear_faults, install_faults
    from fast_tffm_tpu_torch.training import train
    from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    _seeded_npz(tmp_path)
    captures = []
    real = StepGraphs._capture
    monkeypatch.setattr(StepGraphs, "_capture",
                        lambda self, *a: captures.append(1) or real(self, *a))
    cfg = _rollback_cfg(tmp_path, "rb.ckpt", on_nan="rollback")
    shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    inj = install_faults(FaultPlan.parse("nan@20:25"))
    kept = []

    def hook(step):
        if step > 16 and not kept:
            kept.append(shutil.copy(cfg.model_file, str(tmp_path / "epoch0.ckpt")))
        inj.step_hook(step)

    quiet = lambda *_: None  # noqa: E731
    try:
        got = train(cfg, resume=True, log=quiet, device="cuda", step_hook=hook)
    finally:
        clear_faults()
    assert len(captures) == 1
    (rec,) = [r for r in map(__import__("json").loads, open(cfg.metrics_path))
              if r["kind"] == "anomaly" and r["event"] == "rollback"]
    assert (rec["restored_step"], rec["skip_to_epoch"], rec["skip_to_batch"]) == (16, 1, 8)
    ref_cfg = _rollback_cfg(tmp_path, "ref.ckpt")
    cursor = dict(read_input_cursor(kept[0]), epoch=1, batch_in_epoch=8)
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    save_checkpoint(ref_cfg.model_file, restore_checkpoint(kept[0], torch.device("cpu"),
                                                           accum_width=9), cursor=cursor)
    want = train(ref_cfg, resume=True, log=quiet, device="cuda")
    torch.cuda.synchronize()
    assert got.step == want.step == 24
    assert torch.equal(got.table, want.table) and torch.equal(got.table_accum, want.table_accum)


def test_accum_restart_in_a_k8_graph_is_bitwise_the_eager_run(cuda, tmp_path, monkeypatch):
    """accum_restart_steps = 8 on the device cache, 2 epochs of 16 steps: the
    K = 8 run (the fill writes the graph's own state tensors between
    replays) ends bitwise the eager K = 1 run, and each reset leaves every
    accumulator at the init value."""
    import shutil

    from fast_tffm_tpu_torch import training

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    _seeded_npz(tmp_path)
    resets = []
    real = training.make_accum_restart

    def checked(value):
        reset = real(value)

        def run(state):
            state = reset(state)
            resets.append((state.step, bool((state.table_accum == value).all())))
            return state

        return run

    monkeypatch.setattr(training, "make_accum_restart", checked)
    states = {}
    for k in (1, 8):
        cfg = _rollback_cfg(tmp_path, f"k{k}.ckpt", online_accum_restart_steps=8,
                            steps_per_call=k)
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
        resets.clear()
        states[k] = training.train(cfg, resume=True, log=lambda *_: None, device="cuda")
        assert resets == [(8, True), (16, True), (24, True), (32, True)]
    torch.cuda.synchronize()
    assert torch.equal(states[1].table, states[8].table)
    assert torch.equal(states[1].table_accum, states[8].table_accum)


def _logged_losses(lines):
    return [x.split(" loss ")[1].split()[0] for x in lines if " loss " in x]


@pytest.mark.parametrize("k", [1, 8])
def test_tiered_card_run_is_bitwise_the_resident_run(cuda, tmp_path, k):
    """``[ParamStore]`` on the card (hot 48 of 256 rows, the store holding
    ``init_state``'s host draw): losses, validation AUC and the logical table
    and accumulator rebuilt from both tiers are bitwise those of the
    resident card run from the same init; K = 8 on FMB input in a CUDA graph
    over the compact table."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.paramstore import ColdStore
    from fast_tffm_tpu_torch.training import train

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    mode = dict(steps_per_call=8, binary_cache=True) if k > 1 else {}
    logs = {"res": [], "tier": []}
    res_cfg = _resume_cfg(tmp_path, "res.ckpt", **mode)
    save_checkpoint(res_cfg.model_file,
                    init_state(build_model(res_cfg), torch.Generator().manual_seed(0)))
    res = train(res_cfg, resume=True, log=logs["res"].append, device="cuda")
    tier_cfg = _resume_cfg(tmp_path, "tier.ckpt", paramstore=True, paramstore_hot_rows=48,
                           delta_every_steps=5, **mode)
    train(tier_cfg, log=logs["tier"].append, device="cuda")
    torch.cuda.synchronize()
    assert _logged_losses(logs["res"]) == _logged_losses(logs["tier"])
    auc = [[x for x in logs[r] if "validation auc" in x] for r in ("res", "tier")]
    assert auc[0] == auc[1] and auc[0]
    z = np.load(tier_cfg.model_file)
    t, a = ColdStore.open(tier_cfg.model_file + ".store").read_rows(np.arange(256))
    ci = z["tier_cold_idx"]
    t[ci], a[ci] = z["tier_cold_rows"], z["tier_cold_accum"]
    t[z["tier_hot_ids"]], a[z["tier_hot_ids"]] = z["table"], z["table_accum"]
    assert np.array_equal(t, res.table.cpu().numpy())
    assert np.array_equal(a, res.table_accum.cpu().numpy())


def _wire_case(rng, k: int):
    from fast_tffm_tpu_torch.data import wire
    from fast_tffm_tpu_torch.data.libsvm import ParsedBatch

    b, n = 64, 11
    spec = wire.make_spec(1 << 20, n, with_vals=True, with_fields=False, with_weights=False)
    seq = []
    for _ in range(k):
        nnz = rng.integers(1, n + 1, size=b).astype(np.int32)
        mask = np.arange(n) < nnz[:, None]
        seq.append(ParsedBatch(
            labels=rng.integers(0, 2, size=b).astype(np.float32),
            ids=np.where(mask, rng.integers(0, 1 << 20, size=(b, n)), 0).astype(np.int32),
            vals=np.where(mask, rng.uniform(0.1, 2, size=(b, n)), 0).astype(np.float32),
            fields=np.zeros((b, n), np.int32), nnz=nnz))
    ws = [(np.arange(b) < b - 3).astype(np.float32) for _ in range(k)]
    return spec, (seq if k > 1 else seq[0]), (ws if k > 1 else ws[0])


@pytest.mark.parametrize("k", [1, 8])
def test_side_stream_h2d_and_unpack_equal_the_loop_thread_path(cuda, k):
    """The WireConverter's pinned copy and unpack on its side stream, made
    in another thread, give the batch the arrays path puts on the card, bit
    for bit, once the loop's stream waited on it."""
    import dataclasses
    import threading

    from fast_tffm_tpu_torch.data import wire
    from fast_tffm_tpu_torch.models.base import Batch

    spec, parsed, w = _wire_case(np.random.default_rng(k), k)
    conv = wire.WireConverter(spec, cuda, slots=2)
    out = []
    t = threading.Thread(target=lambda: out.append(conv(parsed, w)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    got = out[0].ready()
    want = (Batch.stack_parsed(parsed, w) if k > 1 else Batch.from_parsed(parsed, w)).to(cuda)
    for f in dataclasses.fields(got):
        g, e = getattr(got, f.name), getattr(want, f.name)
        assert g.device.type == "cuda" and g.dtype == e.dtype and torch.equal(g, e), f.name
    assert conv.last_nbytes == k * spec.batch_nbytes(64)


def test_a_full_queue_never_refills_a_pinned_buffer_under_its_copy(cuda):
    """Twelve batches converted ahead of the loop through a ring of two
    pinned buffers (a queue far deeper than the ring): every batch, read
    only after all were converted, is its own, not a later one packed into
    the same buffer while its copy was in flight."""
    import dataclasses

    from fast_tffm_tpu_torch.data import wire
    from fast_tffm_tpu_torch.models.base import Batch

    rng = np.random.default_rng(12)
    cases = [_wire_case(rng, 1) for _ in range(12)]
    conv = wire.WireConverter(cases[0][0], cuda, slots=2)
    with torch.cuda.stream(conv._stager.stream):
        torch.cuda._sleep(50_000_000)  # the first copies queue behind ~tens of ms
    staged = [conv(p, w) for _, p, w in cases]
    for s, (_, p, w) in zip(staged, cases):
        got, want = s.ready(), Batch.from_parsed(p, w).to(cuda)
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("k", [1, 8])
def test_packed_wire_card_run_is_bitwise_the_arrays_run(cuda, tmp_path, k):
    """FMB input on the card: ``wire_format = packed`` (at K = 8 one pinned
    H2D a call, the unpack on a side stream; at K = 1 the loop converts)
    trains bitwise as ``arrays``."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState
    from fast_tffm_tpu_torch.training import train

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    rng = np.random.default_rng(5)
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, 9), 0.1)))
    out, logs = {}, {}
    for fmt in ("packed", "arrays"):
        cfg = _resume_cfg(tmp_path, f"{fmt}.ckpt", binary_cache=True, steps_per_call=k,
                          wire_format=fmt)
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
        logs[fmt] = []
        out[fmt] = train(cfg, resume=True, log=logs[fmt].append, device="cuda")
    torch.cuda.synchronize()
    assert _logged_losses(logs["packed"]) == _logged_losses(logs["arrays"])
    assert torch.equal(out["packed"].table, out["arrays"].table)
    assert torch.equal(out["packed"].table_accum, out["arrays"].table_accum)


def test_side_streams_are_never_the_graph_capture_stream(cuda):
    """The wire's copy stream and the checkpoint writer's stream are drawn
    from the high-priority pool: however many are made, none is the stream
    a K-step CUDA graph captures on (PyTorch's pooled default capture
    stream), whose capture would otherwise take in their work."""
    from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer
    from fast_tffm_tpu_torch.data import wire

    g = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device=cuda)
    with torch.cuda.graph(g):
        x.add_(1)
    capture = torch.cuda.graph.default_capture_stream.cuda_stream
    spec = wire.make_spec(256, 4, with_vals=True, with_fields=False)
    for _ in range(80):  # more than a stream pool holds
        assert wire.WireConverter(spec, cuda)._stager.stream.cuda_stream != capture
        writer = AsyncCheckpointer("unused.ckpt", device=cuda, chunk_bytes=4096)
        assert writer._side.cuda_stream != capture


@pytest.mark.parametrize("ranks", [2, 4])
def test_shard_apply_at_base_above_zero_is_its_twin_and_the_whole_update(cuda, ranks):
    """The sharded update's apply (B4 on the world-gathered ids mapped to one
    shard's local rows, ``base`` > 0 for every shard but the first) is
    bitwise its plain twin on the CPU and the rows of the R = 1 update."""
    from fast_tffm_tpu_torch.parallel.embedding import apply_shard_adagrad, dedup_rows_padded

    rng = np.random.default_rng(ranks)
    v, d = 4096, 9
    table = torch.from_numpy(rng.uniform(-0.3, 0.3, (v, d)).astype(np.float32))
    parts = [dedup_rows_padded(torch.from_numpy(rng.integers(0, v, 600).astype(np.int32)),
                               torch.from_numpy(rng.normal(size=(600, d)).astype(np.float32)),
                               v) for _ in range(ranks)]
    uids = torch.cat([u for u, _ in parts])
    gsum = torch.cat([g for _, g in parts])
    whole_t, whole_a = table.clone().to(cuda), torch.full((v, d), 0.1, device=cuda)
    apply_shard_adagrad(whole_t, whole_a, uids.to(cuda), gsum.to(cuda), 0.05, 0)
    shard = v // ranks
    for r in range(ranks):
        lo = r * shard
        t, a = table[lo:lo + shard].clone(), torch.full((shard, d), 0.1)
        ct, ca = t.to(cuda), a.to(cuda)
        apply_shard_adagrad(ct, ca, uids.to(cuda), gsum.to(cuda), 0.05, lo)
        apply_shard_adagrad(t, a, uids, gsum, 0.05, lo)
        assert torch.equal(ct.cpu(), t) and torch.equal(ca.cpu(), a)
        assert torch.equal(ct, whole_t[lo:lo + shard]) and torch.equal(ca, whole_a[lo:lo + shard])


@pytest.mark.parametrize("over", [{}, {"table_layout": "packed"},
                                  {"table_layout": "packed", "adagrad_accumulator": "fused"},
                                  {"steps_per_call": 8}, {"lookup": "alltoall"}],
                         ids=["rows", "packed", "fused", "k8", "alltoall"])
def test_world_size_one_dist_train_is_train_on_the_card(cuda, tmp_path, over):
    """``dist_train`` with no process group (a 1 x 1 mesh) is ``train`` on
    the card: the same losses and the same logical table and accumulator,
    bit for bit (the saved arrays; a packed run's padding rows beyond the
    vocabulary aside)."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.trainer import TrainState
    from fast_tffm_tpu_torch.training import dist_train, train

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    rng = np.random.default_rng(9)
    width = 1 if over.get("adagrad_accumulator") == "fused" else 9
    save_checkpoint(str(tmp_path / "init.ckpt"), TrainState(
        table=torch.from_numpy(rng.uniform(-0.3, 0.3, (256, 9)).astype(np.float32)), dense=[],
        step=0, table_accum=torch.full((256, width), 0.1)))
    logs, files = {}, {}
    for name, run in (("train", train), ("dist", dist_train)):
        cfg = _resume_cfg(tmp_path, f"{name}.ckpt", **over)
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
        logs[name] = []
        run(cfg, resume=True, log=logs[name].append, device="cuda")
        files[name] = np.load(cfg.model_file)
    assert _logged_losses(logs["train"]) == _logged_losses(logs["dist"])
    for key in ("table", "table_accum"):
        a, b = files["train"][key], files["dist"][key]
        assert np.array_equal(a, b[: a.shape[0]]), key


@pytest.mark.parametrize("k", [1, 8])
def test_cached_sharded_step_at_world_size_one_is_the_cached_train_step(cuda, tmp_path, k):
    """The resident epoch under ``dist_train`` at world size 1 on the card:
    ``make_cached_sharded_train_step`` over ``load_sharded_device_dataset``
    (K = 8: one CUDA graph with the gathers inside) against the single-device
    cached step over ``load_device_dataset``, from one state: every loss and
    the table and accumulator bit for bit; ``dist_train`` with
    ``device_cache`` and a delta every 4 steps against ``train`` likewise."""
    import shutil

    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
    from fast_tffm_tpu_torch.parallel import make_mesh
    from fast_tffm_tpu_torch.training import dist_train, train

    for f in ("train.libsvm", "test.libsvm"):
        shutil.copy(os.path.join(REPO, "data", f), tmp_path)
    cfg = _resume_cfg(tmp_path, "x.ckpt", device_cache=True, binary_cache=True,
                      steps_per_call=k, delta_every_steps=4)
    model = build_model(cfg)
    files = ensure_fmb_cache(cfg.train_files, vocabulary_size=256, max_nnz=8, log=lambda *a: None)
    one = device_cache.load_device_dataset(files, batch_size=20, vocabulary_size=256, max_nnz=8,
                                           device="cuda")
    mesh = make_mesh()
    sharded = device_cache.load_sharded_device_dataset(files, mesh=mesh, batch_size=20,
                                                       vocabulary_size=256, max_nnz=8,
                                                       device="cuda")
    for a, b in zip(one.arrays, sharded.arrays):
        assert torch.equal(a, b)
    make = device_cache.make_cached_scan_train_step if k > 1 else \
        device_cache.make_cached_train_step
    plain, _ = make(model, cfg.learning_rate, one, train_step_body)
    cached = device_cache.make_cached_sharded_train_step(model, cfg.learning_rate, mesh, sharded,
                                                         steps_per_call=k)
    gen = torch.Generator(device="cuda").manual_seed(3)
    states = [init_state(model, gen, 0.1, "element") for _ in range(2)]
    states[1].table.copy_(states[0].table)
    items = (device_cache.epoch_index_chunks(one.batches, k, "cuda") if k > 1 else
             [torch.tensor(i, device="cuda") for i in range(one.batches)])
    for i in items:
        states[0], la = plain(states[0], i)
        states[1], lb = cached(states[1], i)
        assert torch.equal(la, lb)
    assert states[0].step == states[1].step
    assert torch.equal(states[0].table, states[1].table)
    assert torch.equal(states[0].table_accum, states[1].table_accum)
    logs, saved = {}, {}
    for name, run in (("train", train), ("dist", dist_train)):
        c = _resume_cfg(tmp_path, f"{name}.ckpt", device_cache=True, binary_cache=True,
                        steps_per_call=k, delta_every_steps=4)
        logs[name] = []
        run(c, log=logs[name].append, device="cuda")
        saved[name] = np.load(c.model_file)
    assert _logged_losses(logs["train"]) == _logged_losses(logs["dist"])
    for key in ("table", "table_accum"):
        assert np.array_equal(saved["train"][key], saved["dist"][key]), key


def _bits_sum(t: torch.Tensor, chunk_rows: int = 1 << 22) -> int:
    """The int64 sum of a float32 tensor's bit patterns, row chunk by chunk."""
    return sum(int(t[lo : lo + chunk_rows].view(torch.int32).to(torch.int64).sum())
               for lo in range(0, t.shape[0], chunk_rows))


def test_k_step_capture_over_half_the_card_needs_no_second_state(cuda):
    """A K = 8 graph captured on a rows state larger than half the card's free
    memory: the capture's warm-up restores the rows it touches instead of
    cloning the state, so the peak allocation above the live state stays
    under the step's temporaries (bounded here by 2 GiB, far below the
    state); the rows outside the batches' ids are untouched, and the graphed
    K steps are bitwise the plain loop from the same state."""
    from fast_tffm_tpu_torch.trainer import (
        TrainState,
        k_step_loop,
        make_scanned_train_step,
        train_step_body,
    )

    k, b, n, d = 8, 4096, 39, 9
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(cuda)[0]
    vocab = int(0.55 * free) // ((d + 1) * 4)
    model = FMModel(vocabulary_size=vocab, factor_num=d - 1, order=2)
    g = torch.Generator(device=cuda).manual_seed(5)
    table = torch.empty((vocab, d), device=cuda)
    for lo in range(0, vocab, 1 << 24):
        table[lo : lo + (1 << 24)].uniform_(-0.01, 0.01, generator=g)
    state = TrainState(table=table, dense=[], step=0,
                       table_accum=torch.full((vocab, 1), 0.1, device=cuda))
    state_bytes = vocab * (d + 1) * 4
    assert state_bytes > free / 2
    ids = torch.randint(0, vocab, (k, b, n), generator=g, device=cuda, dtype=torch.int64)
    ids[..., : n // 2] %= 1 << 16  # a hot head, as CTR ids have
    batch = Batch(labels=(torch.rand((k, b), generator=g, device=cuda) < 0.3).float(),
                  ids=ids.to(torch.int32),
                  vals=torch.rand((k, b, n), generator=g, device=cuda) + 0.1,
                  fields=torch.zeros((k, b, 0), dtype=torch.int32, device=cuda),
                  weights=torch.ones((k, b), device=cuda))
    touched = torch.unique(ids)
    before = (state.table[touched].clone(), state.table_accum[touched].clone())
    rest = (_bits_sum(state.table) - _bits_sum(before[0]),
            _bits_sum(state.table_accum) - _bits_sum(before[1]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    step = make_scanned_train_step(model, 0.05, body=train_step_body)
    state, graphed_losses = step(state, batch)
    torch.cuda.synchronize()
    peak_extra = torch.cuda.max_memory_allocated(cuda) - base
    assert step.graphs.captures == 1 and step.graphs.replays == 1
    assert peak_extra < min(2 << 30, state_bytes // 4), (peak_extra, state_bytes)
    after = (state.table[touched].clone(), state.table_accum[touched].clone())
    assert (_bits_sum(state.table) - _bits_sum(after[0]),
            _bits_sum(state.table_accum) - _bits_sum(after[1])) == rest
    # The plain loop from the same state: the touched rows put back.
    state.table[touched], state.table_accum[touched] = before
    plain = k_step_loop(model, 0.05, train_step_body,
                        lambda i, *f: Batch(*(x[i] for x in f)))
    view = TrainState(table=state.table, dense=[], step=0, table_accum=state.table_accum)
    _, plain_losses = plain(view, *(getattr(batch, f) for f in
                                    ("labels", "ids", "vals", "fields", "weights")))
    torch.cuda.synchronize()
    assert torch.equal(graphed_losses, plain_losses)
    assert torch.equal(state.table[touched], after[0])
    assert torch.equal(state.table_accum[touched], after[1])


# --- DCN-V2: the cross combine pair (csrc/dcn_cross.cu) ---------------------


def _dcn_case(rng, b, d, cuda, offset=0):
    """x0, h, xl [B, d] and c [d] on the card (``offset`` floats into their
    storage: not 16-byte aligned when it is not a multiple of 4)."""
    def t(*shape):
        flat = rng.normal(size=offset + int(np.prod(shape))).astype(np.float32)
        return torch.from_numpy(flat).to(cuda)[offset:].view(*shape)

    return t(b, d), t(b, d), t(d), t(b, d)


def _dcn_plain_grads(x0, h, c, xl, g):
    """y and (d_x0, d_h, d_c, d_xl) of the plain twin under autograd."""
    leaves = [a.detach().clone().requires_grad_(True) for a in (x0, h, c, xl)]
    y = cross_fwd_plain(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, g)


@pytest.mark.parametrize(
    "b,d,offset",
    [
        (8192, 4992, 0),  # dcnv2_criteo1tb's cross layer: B 8,192, d 39·128
        (130, 5, 0),  # d 5: one column a thread; B off a 32-row chunk
        (97, 4991, 0),  # d 4,991: not a multiple of 4
        (33, 64, 1),  # 16-byte misaligned pointers: the scalar path
    ],
)
def test_dcn_cross_pair_matches_the_plain_twin(cuda, b, d, offset):
    """y, ∂L/∂h and ∂L/∂x₀ bitwise the twin's on the card (each product and
    sum rounded on its own, as ATen's separate kernels round them); ∂L/∂c,
    a sum over B in another order (per-chunk partials, then one
    ``torch.sum``), within 1e-5 of its largest magnitude; ∂L/∂x_l is g.
    One forward and one backward launch."""
    rng = np.random.default_rng(b + d + offset)
    x0, h, c, xl = _dcn_case(rng, b, d, cuda, offset)
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(cuda)
    before = (dcn_cross_fwd.launches, dcn_cross_bwd.launches)
    leaves = [a.detach().clone().requires_grad_(True) for a in (x0, h, c, xl)]
    y = cross_combine(*leaves)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert (dcn_cross_fwd.launches - before[0], dcn_cross_bwd.launches - before[1]) == (1, 1)
    want_y, want = _dcn_plain_grads(x0, h, c, xl, g)
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5 * float(want[2].abs().max()))
    assert torch.equal(got[3], g)


def test_dcn_cross_pair_is_bitwise_reproducible_and_sums_x0_in_place(cuda):
    """Two calls give the same bits (the bias sum too: no atomics); three
    layers sharing one ``X0Grad`` give x₀ the sum of their parts, added in
    place in the order the backward runs (the last layer's part first),
    and the same bits in a second run."""
    rng = np.random.default_rng(47)
    b, d, layers = 1031, 388, 3
    x0, _, c, _ = _dcn_case(rng, b, d, cuda)
    hs = [_dcn_case(rng, b, d, cuda)[1] for _ in range(layers)]
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(cuda)

    def run():
        leaves = [x0.clone().requires_grad_(True), c.clone().requires_grad_(True),
                  *(h.clone().requires_grad_(True) for h in hs)]
        acc, x = X0Grad(layers), leaves[0]
        for h in leaves[2:]:
            x = cross_combine(leaves[0], h, leaves[1], x, acc)
        return torch.autograd.grad(x, leaves, g)

    one, two = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two, strict=True))
    # Each layer's output takes the cotangent g (the h here are leaves, so
    # x_{l+1} reaches the loss through the residual path alone): its part of
    # x₀'s gradient is g ⊙ (h_l + c), summed from the last layer back, and
    # layer 0's x_l is x₀ itself, whose g autograd adds.
    parts = [g * (h + c) for h in hs]
    assert torch.equal(one[0], parts[2] + parts[1] + parts[0] + g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcnv2_graph_replay_is_bitwise_the_eager_steps(cuda, dtype):
    """K = 8 over 16 batches of a small DCN-V2 (cuBLAS products, the cross
    pair, the top MLP, the dense update inside one captured graph): the
    losses and the whole state bitwise 16 eager steps; the eager steps
    launch the pair three times a step each way."""
    model = DCNv2Model(vocabulary_size=4099, num_fields=11, factor_num=8, cross_layers=3,
                       cross_rank=16, hidden_dims=(32, 16), compute_dtype=dtype)
    batches = _zoo_batches(np.random.default_rng(31), model, 16)
    eager_step, eager, want = make_train_step(model, 0.05), _zoo_state(model, cuda), []
    before = (dcn_cross_fwd.launches, dcn_cross_bwd.launches)
    for b in batches:
        eager, loss = eager_step(eager, b.to(cuda))
        want.append(loss)
    torch.cuda.synchronize()
    assert (dcn_cross_fwd.launches - before[0], dcn_cross_bwd.launches - before[1]) == (48, 48)
    step = make_scanned_train_step(model, 0.05)
    st, got = _zoo_state(model, cuda), []
    for lo in (0, 8):
        group = batches[lo : lo + 8]
        sb = Batch(*(torch.stack([getattr(b, f) for b in group])
                     for f in ("labels", "ids", "vals", "fields", "weights")))
        st, losses = step(st, sb)
        got.append(losses)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert (step.graphs.captures, step.graphs.replays) == (1, 2)
    pairs = [(st.table, eager.table), (st.table_accum, eager.table_accum),
             *zip(st.dense, eager.dense), *zip(st.dense_accum, eager.dense_accum)]
    assert len(st.dense) == 3 * 3 + 2 * 3
    assert all(torch.equal(a, b) for a, b in pairs)


def test_dcnv2_spans_in_an_instrumented_replay_and_none_with_spans_off(cuda, tmp_path):
    """With spans on, a K = 8 replay of DCN-V2 carries the ``cross`` span
    (the cross network's forward, and each layer's backward kernel) and the
    ``mlp`` span (the top MLP's forward), each nested as the step body opens
    them; with spans off the replayed graph has no marker."""
    import json

    from fast_tffm_tpu_torch.utils import tracing

    model = DCNv2Model(vocabulary_size=4099, num_fields=11, factor_num=8, cross_layers=3,
                       cross_rank=16, hidden_dims=(32, 16), compute_dtype="bfloat16")
    batches = _zoo_batches(np.random.default_rng(37), model, 8)
    sb = Batch(*(torch.stack([getattr(b, f) for b in batches]).to(cuda)
                 for f in ("labels", "ids", "vals", "fields", "weights")))
    step, st = make_scanned_train_step(model, 0.05), _zoo_state(model, cuda)

    def traced():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(st, sb)
            torch.cuda.synchronize()
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
                if e.get("ph") == "X" and e.get("cat") == "kernel"]

    try:
        step(st, sb)  # the plain capture
        off = traced()
        tracing.spans_on(True)
        step(st, sb)  # the instrumented capture
        on = traced()
    finally:
        tracing.spans_on(False)
    assert not [n for n in off if "span_mark" in n]
    marks = [tracing._marker_of(n) for n in on if "span_mark" in n]
    k, layers = 8, 3
    # step, gather, forward, cross, mlp, backward, cross a layer, sort, tail, dense
    assert len(marks) == k * 2 * (9 + layers)
    assert marks.count(("cross", True)) == k * (1 + layers)
    assert marks.count(("mlp", True)) == k
    spans = tracing.read_spans([
        {"ph": "X", "cat": "kernel", "name": n, "ts": float(i), "dur": 0.5, "tid": 1, "pid": 0}
        for i, n in enumerate(on)])["spans"]
    names = [n for n in on if "span_mark" not in n]
    assert spans["cross"]["n"] == k * (1 + layers) and spans["mlp"]["n"] == k
    # every launch of the pair ran inside a cross span
    pair = sum(("dcn_cross_fwd_kernel" in n) + ("dcn_cross_bwd_kernel" in n) for n in names)
    assert pair == 2 * layers * k
