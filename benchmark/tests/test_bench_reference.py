"""The plain reference against one training step worked by hand (loops
over examples, slots and factors, float64) on tiny shapes, and the
starting weights it draws again."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.reference import common as ref

LR = 0.05
LB, LF = 1e-3, 2e-3  # L2 large enough to show in the gradients


def fm_cfg(**kw):
    cfg = dict(model="fm", order=2, factor_num=2, vocabulary_size=16, learning_rate=LR,
               bias_lambda=LB, factor_lambda=LF, init_value_range=0.3,
               init_accumulator_value=0.1, adagrad_accumulator="element")
    cfg.update(kw)
    return cfg


def batch():
    return {"ids": torch.tensor([[1, 4, 7], [4, 2, 9]], dtype=torch.int32),
            "vals": torch.tensor([[1.0, 0.5, 2.0], [1.5, 1.0, 0.0]]),
            "labels": torch.tensor([1.0, 0.0]),
            "weights": torch.tensor([1.0, 2.0])}


def sigmoid(s):
    return 1.0 / (1.0 + math.exp(-s))


def hand_fm(theta: dict, b: dict, deep=None):
    """Scores, loss and per-id gradients by loops.  ``deep``: (score
    offsets [B], d score / d v [B][N][k]) of an MLP half."""
    ids, x = b["ids"].tolist(), b["vals"].double().tolist()
    y, wt = b["labels"].tolist(), b["weights"].tolist()
    sw = sum(wt)
    k = len(next(iter(theta.values()))) - 1
    scores, loss = [], 0.0
    grads: dict[int, np.ndarray] = {}
    for e in range(len(ids)):
        s = sum(theta[i][0] * xi for i, xi in zip(ids[e], x[e]))
        for a in range(len(ids[e])):
            for c in range(a + 1, len(ids[e])):
                s += sum(theta[ids[e][a]][1 + f] * theta[ids[e][c]][1 + f] for f in range(k)) * \
                    x[e][a] * x[e][c]
        if deep is not None:
            s += deep[0][e]
        scores.append(s)
        loss += wt[e] * (math.log1p(math.exp(s)) - y[e] * s) / sw
        d = (sigmoid(s) - y[e]) * wt[e] / sw
        for a, i in enumerate(ids[e]):
            g = grads.setdefault(i, np.zeros(k + 1))
            m = 1.0 if x[e][a] != 0 else 0.0
            g[0] += d * x[e][a] + 2 * LB * theta[i][0] * m
            for f in range(k):
                rest = sum(theta[ids[e][c]][1 + f] * x[e][c] for c in range(len(ids[e])) if c != a)
                g[1 + f] += d * x[e][a] * rest + 2 * LF * theta[i][1 + f] * m
                if deep is not None:
                    g[1 + f] += d * deep[1][e][a][f]
    return scores, loss, grads


def adagrad(theta, g):
    acc = 0.1 + g * g
    return theta - LR * g / np.sqrt(acc), acc


def start(cfg, b, seed=7):
    ck = torch.unique(b["ids"].long())
    rows = ref.initial_rows(cfg, seed, ck, "cpu").double().numpy()
    return ck, {int(i): rows[j] for j, i in enumerate(ck.tolist())}


def test_initial_rows_are_the_drawn_table(monkeypatch):
    monkeypatch.setattr(ref, "TABLE_CHUNK_ROWS", 1000)
    cfg = fm_cfg(vocabulary_size=2500)
    full = ref.draw_table(cfg, 11, "cpu")
    rows = torch.tensor([0, 5, 999, 1000, 1077, 2499])
    assert torch.equal(ref.initial_rows(cfg, 11, rows, "cpu"), full[rows])
    assert (full[:, 0] == 0).all() and float(full[:, 1:].abs().max()) <= 0.3 + 1e-7
    assert not torch.equal(ref.draw_table(cfg, 12, "cpu")[:8], full[:8])


def test_fm_step_matches_the_hand():
    cfg, b = fm_cfg(), batch()
    ck, theta = start(cfg, b)
    scores, loss, grads = hand_fm(theta, b)
    out = ref.reference_steps(cfg, [b], 7, "cpu", ref.config_precision(cfg), [1])
    assert out["losses"][0] == pytest.approx(loss, rel=1e-6)
    for j, i in enumerate(ck.tolist()):
        np.testing.assert_allclose(out["grad1"]["table"][j].double().numpy(), grads[i],
                                   rtol=1e-5, atol=1e-8)
        new, acc = adagrad(theta[i], grads[i])
        np.testing.assert_allclose(out["snaps"][1]["table"][j].double().numpy(), new,
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(out["snaps"][1]["accum"][j].double().numpy(), acc, rtol=1e-6)


def deepfm_cfg(compute_dtype="float32"):
    return fm_cfg(model="deepfm", num_fields=3, hidden_dims=[3], compute_dtype=compute_dtype)


def test_deepfm_step_matches_the_hand():
    cfg, b = deepfm_cfg(), batch()
    ck, theta = start(cfg, b)
    dense = {k: v.double().numpy() for k, v in ref.draw_dense(cfg, 7, "cpu").items()}
    dense["b0"] = np.array([0.05, -0.1, 0.2])  # the drawn biases are 0; the hand takes any
    ids, x = b["ids"].tolist(), b["vals"].double().numpy()
    emb = np.stack([np.concatenate([theta[i][1:] * x[e][a] for a, i in enumerate(ids[e])])
                    for e in range(2)])  # [B, N·k]
    pre = emb @ dense["w0"] + dense["b0"]
    h = np.maximum(pre, 0.0)
    out_mlp = (h @ dense["w1"] + dense["b1"])[:, 0]
    # d out / d emb = w0 · relu' · w1, then per slot and factor times the slot's value
    d_emb = ((pre > 0) * dense["w1"][:, 0]) @ dense["w0"].T  # [B, N·k]
    d_v = [[[d_emb[e][a * 2 + f] * x[e][a] for f in range(2)] for a in range(3)] for e in range(2)]
    scores, loss, grads = hand_fm(theta, b, deep=(out_mlp, d_v))
    d = np.array([(sigmoid(s) - yv) * w / 3.0 for s, yv, w in zip(scores, [1.0, 0.0], [1.0, 2.0])])
    g_w1 = h.T @ d[:, None]
    g_b1 = np.array([d.sum()])
    g_pre = (d[:, None] * dense["w1"][:, 0]) * (pre > 0)
    g_w0, g_b0 = emb.T @ g_pre, g_pre.sum(0)

    got_dense = ref.draw_dense(cfg, 7, "cpu")
    got_dense["b0"] = torch.tensor(dense["b0"], dtype=torch.float32)
    orig = ref.draw_dense
    try:
        ref.draw_dense = lambda *a: {k: v.clone() for k, v in got_dense.items()}
        out = ref.reference_steps(cfg, [b], 7, "cpu", ref.config_precision(cfg), [1])
    finally:
        ref.draw_dense = orig
    assert out["losses"][0] == pytest.approx(loss, rel=1e-6)
    for j, i in enumerate(ck.tolist()):
        np.testing.assert_allclose(out["grad1"]["table"][j].double().numpy(), grads[i],
                                   rtol=1e-5, atol=1e-8)
    for name, g in (("w0", g_w0), ("b0", g_b0), ("w1", g_w1), ("b1", g_b1)):
        np.testing.assert_allclose(out["grad1"][name].double().numpy(), g, rtol=1e-5, atol=1e-8)
        new, _ = adagrad(dense[name], g)
        np.testing.assert_allclose(out["snaps"][1]["dense"][name].double().numpy(), new,
                                   rtol=1e-6, atol=1e-8)


def test_bf16_operands_round_the_mlp_and_nothing_else():
    """compute_dtype bfloat16: the MLP's products take bfloat16-rounded
    operands with float32 sums; the FM half stays float32."""
    cfg32, cfg16 = deepfm_cfg(), deepfm_cfg("bfloat16")
    b = batch()
    dense = ref.draw_dense(cfg32, 3, "cpu")
    rows = torch.randn(2, 3, 3) * 0.3
    from benchmark.reference import deepfm, fm

    s32 = deepfm.score(rows, b["vals"], dense, cfg32, ref.config_precision(cfg32))
    s16 = deepfm.score(rows, b["vals"], dense, cfg16, ref.config_precision(cfg16))
    r16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    emb = (rows[..., 1:] * b["vals"][..., None]).reshape(2, -1)
    h = torch.relu(r16(emb) @ r16(dense["w0"]) + dense["b0"])
    want = fm.fm2(rows, b["vals"]) + (r16(h) @ r16(dense["w1"]) + dense["b1"])[:, 0]
    torch.testing.assert_close(s16, want, rtol=1e-6, atol=1e-7)
    assert not torch.equal(s16, s32)


def test_lower_precision_is_one_step_below():
    assert ref.lower_precision(fm_cfg()) == ref.Precision(torch.bfloat16, "bf16")
    assert ref.lower_precision(deepfm_cfg("bfloat16")) == ref.Precision(torch.bfloat16, "fp8")
    assert ref.lower_mlp_precision(deepfm_cfg("bfloat16")) == ref.Precision(torch.float32, "fp8")
    assert ref.lower_mlp_precision(fm_cfg()) is None
    x = torch.linspace(-1, 1, 101)
    q = ref.round_operand(x, "fp8")
    assert 0 < float((q - x).abs().max()) <= 1.0 / 16  # e4m3: 3 mantissa bits
