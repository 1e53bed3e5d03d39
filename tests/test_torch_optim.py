"""Port: the sparse Adagrad tail against the JAX package on the CPU.

``dedup_rows`` and ``sparse_adagrad_update`` (the plain twin of the rows
Adagrad kernel csrc/rows_tail_adagrad.cu) and the kernel's CPU wrapper
``rows_tail_adagrad_update`` against the JAX ``optim.sparse_adagrad_update``
and the JAX ``rows_tail_adagrad_update`` with its Pallas kernel in
interpret mode.  One parametrised case per accumulator granularity
(element [V, D], row [V, 1]), decay γ ∈ {1, 0.9} and id pattern
(duplicate-heavy Zipf ids, a single id).  Inputs come from numpy seeds.

Tolerance rtol 1e-6 / atol 1e-7: both sides sum each id's occurrences in
input order; they differ only where float32 rounding of the row-mode
‖g‖² sum does.  The remainder-block case (``block_rows = 8``, K not a
multiple of 8) is pinned against ``optim`` only: the JAX suite's own
test of the Pallas kernel there fails (ROADMAP §C caveat 1).

The tail kernels take the stable sort's output (sorted ids, the sort's
permutation, gradients in occurrence order); their twin on that input
(``ops.tail.rows_tail_sorted_plain``) is held bitwise to
``sparse_adagrad_update`` and to the JAX tail at the same tolerance, over
unsorted duplicates, a hot id 0 with 10,000+ occurrences, ids out of range
and K = 1, and ``sorted_segment_sum``'s order is pinned against a plain
left-to-right float32 sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.ops.pallas_tail import rows_tail_adagrad_update as jax_rows_tail
from fast_tffm_tpu.optim import AdagradState
from fast_tffm_tpu.optim import dedup_rows as jax_dedup_rows
from fast_tffm_tpu.optim import sparse_adagrad_update as jax_sparse_adagrad_update
from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update, rows_tail_sorted_plain
from fast_tffm_tpu_torch.optim import (
    accum_sq,
    dedup_rows,
    dense_adagrad_update,
    init_table_adagrad,
    sorted_segment_sum,
    sparse_adagrad_update,
    sqrt_rn,
)

V, D = 512, 9
LR = 0.05
RTOL, ATOL = 1e-6, 1e-7


def _case(seed, accum_width, pattern):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, size=(V, D)).astype(np.float32)
    accum = rng.uniform(0.1, 0.4, size=(V, accum_width)).astype(np.float32)
    if pattern == "zipf":  # duplicate-heavy: a few ids take most occurrences
        ids = (rng.zipf(1.3, size=(16, 11)) % V).astype(np.int32)
    else:  # one id, one occurrence
        ids = np.array([[37]], np.int32)
    grads = rng.normal(size=ids.shape + (D,)).astype(np.float32)
    return table, accum, ids, grads


def _torch_update(fn, table, accum, ids, grads, decay):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    out = fn(t, a, torch.from_numpy(ids), torch.from_numpy(grads), LR, decay=decay)
    assert out[0] is t and out[1] is a  # in place
    return t.numpy(), a.numpy()


@pytest.mark.parametrize("pattern", ["zipf", "single"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("accum_width", [D, 1], ids=["element", "row"])
def test_sparse_adagrad_matches_jax(accum_width, decay, pattern):
    table, accum, ids, grads = _case(accum_width * 10 + int(decay * 10), accum_width, pattern)
    want_t, want_opt = jax_sparse_adagrad_update(
        jnp.asarray(table), AdagradState(jnp.asarray(accum)), jnp.asarray(ids),
        jnp.asarray(grads), LR, decay=decay,
    )
    want_pallas = jax_rows_tail(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids), jnp.asarray(grads), LR,
        decay=decay, interpret=True,
    )
    for fn in (sparse_adagrad_update, rows_tail_adagrad_update):
        before = rows_tail_adagrad_update.launches
        got_t, got_a = _torch_update(fn, table, accum, ids, grads, decay)
        assert rows_tail_adagrad_update.launches == before  # CPU: the twin, uncounted
        for want in ((want_t, want_opt.accum), want_pallas):
            np.testing.assert_allclose(got_t, np.asarray(want[0]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got_a, np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    # Untouched rows are bitwise untouched.
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(got_t[untouched], table[untouched])
    np.testing.assert_array_equal(got_a[untouched], accum[untouched])


def test_dedup_rows_matches_jax():
    rng = np.random.default_rng(4)
    ids = (rng.zipf(1.2, size=700) % 300).astype(np.int32)
    grads = rng.normal(size=(700, D)).astype(np.float32)
    uids, gsum = dedup_rows(torch.from_numpy(ids), torch.from_numpy(grads))
    j_uids, j_gsum = jax_dedup_rows(jnp.asarray(ids), jnp.asarray(grads), V)
    k = int(np.unique(ids).size)
    assert uids.dtype == torch.int32 and tuple(gsum.shape) == (k, D)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(j_uids)[:k])
    assert np.all(np.asarray(j_uids)[k:] == V)  # the JAX sentinel tail the port omits
    np.testing.assert_allclose(gsum.numpy(), np.asarray(j_gsum)[:k], rtol=RTOL, atol=ATOL)
    # The same inputs give bit-identical sums (fixed summation order).
    u2, g2 = dedup_rows(torch.from_numpy(ids), torch.from_numpy(grads))
    assert torch.equal(uids, u2) and torch.equal(gsum, g2)


def test_remainder_block_is_pinned_against_optim():
    """K = 13 unique rows: not a multiple of the TPU kernel's 8-row block.
    The port's tail has no blocks; it is pinned against JAX ``optim``."""
    rng = np.random.default_rng(13)
    table = rng.uniform(-0.1, 0.1, size=(V, D)).astype(np.float32)
    accum = np.full((V, D), 0.1, np.float32)
    ids = rng.choice(V, size=13, replace=False).astype(np.int32)
    grads = rng.normal(size=(13, D)).astype(np.float32)
    want_t, want_opt = jax_sparse_adagrad_update(
        jnp.asarray(table), AdagradState(jnp.asarray(accum)), jnp.asarray(ids),
        jnp.asarray(grads), LR,
    )
    got_t, got_a = _torch_update(rows_tail_adagrad_update, table, accum, ids, grads, 1.0)
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_a, np.asarray(want_opt.accum), rtol=RTOL, atol=ATOL)


def test_accumulator_init_and_granularity():
    table = torch.zeros((6, D))
    assert tuple(init_table_adagrad(table, 0.1, "element").shape) == (6, D)
    assert tuple(init_table_adagrad(table, 0.1, "row").shape) == (6, 1)
    with pytest.raises(ValueError, match="accumulator"):
        init_table_adagrad(table, 0.1, "fused")
    g = torch.arange(18, dtype=torch.float32).reshape(2, D)
    torch.testing.assert_close(accum_sq(torch.zeros(6, 1), g), torch.sum(g * g, -1, keepdim=True))
    torch.testing.assert_close(accum_sq(torch.zeros(6, D), g), g * g)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_dense_adagrad_matches_jax(decay):
    from fast_tffm_tpu.optim import dense_adagrad_update as jax_dense

    rng = np.random.default_rng(7)
    p = rng.normal(size=(4, 3)).astype(np.float32)
    a = np.full((4, 3), 0.1, np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    want_p, want_opt = jax_dense(
        {"w": jnp.asarray(p)}, AdagradState({"w": jnp.asarray(a)}), {"w": jnp.asarray(g)},
        LR, decay=decay,
    )
    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    dense_adagrad_update([tp], [ta], [torch.from_numpy(g)], LR, decay)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want_p["w"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(want_opt.accum["w"]), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the tail kernels' contract: sorted occurrences in, updated rows out
# ---------------------------------------------------------------------------


def _occurrences(seed, pattern, accum_width):
    """Flat ids, gradients and a state for the sorted-occurrence contract.
    "hot": id 0 10,000+ times (a padded batch), among unsorted duplicates;
    "out of range": ids at V and beyond, which every tail skips."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, size=(V, D)).astype(np.float32)
    accum = rng.uniform(0.1, 0.4, size=(V, accum_width)).astype(np.float32)
    if pattern == "dups":  # unsorted, duplicate-heavy
        ids = (rng.zipf(1.3, size=400) % V).astype(np.int32)
    elif pattern == "hot":
        ids = np.zeros(10_400, np.int32)
        ids[rng.choice(10_400, 400, replace=False)] = rng.integers(1, V, 400)
    elif pattern == "out of range":
        ids = (rng.zipf(1.3, size=400) % (V + 40)).astype(np.int32)
    else:  # one id, one occurrence: K = 1
        ids = np.array([37], np.int32)
    grads = rng.normal(size=(ids.size, D)).astype(np.float32)
    return table, accum, ids, grads


@pytest.mark.parametrize("pattern", ["dups", "hot", "out of range", "K=1"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("accum_width", [D, 1], ids=["element", "row"])
def test_sorted_twin_is_bitwise_sparse_adagrad_and_matches_jax(accum_width, decay, pattern):
    """The rows kernel's twin on its own input — the stable sort's output
    through ``sorted_segment_sum``, then ``adagrad_rows_plain`` — is
    bitwise ``optim.sparse_adagrad_update``, and within the existing
    tolerance of the JAX rows tail (Pallas, interpret mode)."""
    table, accum, ids, grads = _occurrences(len(pattern) + accum_width, pattern, accum_width)
    sid, order = torch.sort(torch.from_numpy(ids), stable=True)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    out = rows_tail_sorted_plain(t, a, sid, order, torch.from_numpy(grads), LR, decay)
    assert out[0] is t and out[1] is a  # in place
    want_t, want_a = _torch_update(sparse_adagrad_update, table, accum, ids, grads, decay)
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(a.numpy(), want_a)
    j_t, j_a = jax_rows_tail(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids), jnp.asarray(grads), LR,
        decay=decay, interpret=True, block_rows=4096,
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(j_a), rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    assert not np.array_equal(a.numpy(), accum)


def test_sorted_segment_sum_adds_left_to_right_from_zero():
    """The order the tail kernels sum in, pinned: each id's occurrences in
    input order, added one at a time to a float32 0.0 — so a segment of
    -0.0s sums to +0.0, and a 10,000-long segment is one serial sum."""
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 50, size=12_000).astype(np.int32)
    ids[rng.choice(12_000, 10_000, replace=False)] = 7
    ids[:3] = 99  # one id whose occurrences are all -0.0
    grads = (rng.normal(size=(12_000, D)) * 10.0 ** rng.integers(-3, 4, size=(12_000, 1)))
    grads = grads.astype(np.float32)
    grads[:3] = -0.0
    sid, order = torch.sort(torch.from_numpy(ids), stable=True)
    uids, gsum = sorted_segment_sum(sid, order, torch.from_numpy(grads))
    for u, got in zip(uids.tolist(), gsum.numpy()):
        want = np.zeros(D, np.float32)
        for row in grads[ids == u]:
            want = want + row  # float32 + float32, one occurrence at a time
        np.testing.assert_array_equal(got, want)
        assert not np.signbit(got).any() or u != 99
    assert torch.equal(uids, dedup_rows(torch.from_numpy(ids), torch.from_numpy(grads))[0])


def test_negative_ids_are_skipped_as_the_kernel_skips_them():
    table, accum, ids, grads = _occurrences(3, "dups", D)
    ids[::7] = -1 - ids[::7]
    t, a = _torch_update(sparse_adagrad_update, table, accum, ids, grads, 1.0)
    keep = ids >= 0
    want_t, want_a = _torch_update(sparse_adagrad_update, table, accum, ids[keep], grads[keep], 1.0)
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(a, want_a)


def test_cpu_sqrt_is_correctly_rounded():
    """The twins' sqrt on a CPU tensor is IEEE float32's (numpy's), the
    kernels' ``__fsqrt_rn``, on 9000 values in [0.1, 40.1] and on a
    64-element tensor; the float32 product w − lr·g/√acc of the rows twin
    follows it."""
    rng = np.random.default_rng(12)
    for n in (64, 9000):
        x = rng.uniform(0.1, 40.1, size=n).astype(np.float32)
        assert np.array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))
    table = rng.uniform(-0.1, 0.1, size=(300, D)).astype(np.float32)
    accum = rng.uniform(0.1, 40.0, size=(300, D)).astype(np.float32)
    g = rng.normal(size=(300, D)).astype(np.float32)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    ids = torch.arange(300, dtype=torch.int32)
    sparse_adagrad_update(t, a, ids, torch.from_numpy(g), LR)
    acc2 = accum + g * g
    assert np.array_equal(a.numpy(), acc2)
    assert np.array_equal(t.numpy(), table - np.float32(LR) * g / np.sqrt(acc2))

