"""Port: DCN-V2 (``models/dcnv2.py``, the port's first model with no JAX
twin) against the plain reference ``benchmark/reference/dcnv2.py`` on the
CPU, at a small size on seeded random weights (B 16, N 5, k 4, two cross
layers of rank 3, MLP 8-4).  Tolerances, and why:

* scores: bitwise, at float32 and at bfloat16: the same operations in the
  same order (the same operand roundings, the same float32 sums);
* the loss: rtol 1e-6: the port's stable log-sum-exp form and the
  reference's softplus differ in their last ulps;
* every gradient (the rows' and each dense leaf's): within 1e-5 of the
  tensor's largest magnitude.  The loss's gradient σ(s) − y differs in its
  last ulps between the two forms and every backward product carries that
  (measured: up to 1.4e-6 at float32 over seeds 3-8); x₀'s gradient sums
  the layers in another order (``ops/dcn.X0Grad`` in place, autograd in
  its own); at bfloat16 the gradients are rounded to bfloat16 at the same
  casts, which absorbs most of it (up to 7.7e-7), and a cast that lands
  across a rounding boundary would move that element by 2^-8 of itself
  (none does on these seeds).

Beside them: a float64 gradcheck of ``cross_combine``'s twin (alone and
two layers sharing one ``X0Grad``), the configuration's refusals,
``cli train`` → ``predict`` → ``serve`` of a tiny cfg, DeepFM bitwise what
its MLP computed before it shared the helper, and the comparison that
decides the benchmark cell's ``correct`` failing a reference whose last
cross layer leaves out x₀ ⊙ (h + c).
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import common as ref
from benchmark.reference import dcnv2 as plain
from benchmark.tests.conftest import tiny_spec
from benchmark.tests.test_bench_dcnv2 import fault_readings
from fast_tffm_tpu_torch import cli
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import PORT_ONLY_KEYS, Config, build_model, jax_fields, load_config
from fast_tffm_tpu_torch.models import Batch, DCNv2Model, DeepFMModel, logistic_loss
from fast_tffm_tpu_torch.models.base import compute_round
from fast_tffm_tpu_torch.ops.dcn import X0Grad, cross_combine

B, N, K, L, R, HIDDEN = 16, 5, 4, 2, 3, (8, 4)
CELL = "dcnv2_criteo1tb.fields_shard8"


def _model(dtype="float32", **kw):
    return DCNv2Model(vocabulary_size=97, num_fields=N, factor_num=K, cross_layers=L,
                      cross_rank=R, hidden_dims=HIDDEN, compute_dtype=dtype, **kw)


def _cfg(dtype):
    return dict(num_fields=N, factor_num=K, cross_layers=L, cross_rank=R,
                hidden_dims=list(HIDDEN), compute_dtype=dtype)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.1, 1.2, size=(B, N)).astype(np.float32)
    vals[:3, -1] = 0.0  # padding slots
    batch = Batch(labels=torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)),
                  ids=torch.zeros((B, N), dtype=torch.int32), vals=torch.from_numpy(vals),
                  fields=torch.zeros((B, 0), dtype=torch.int32),
                  weights=torch.from_numpy(rng.uniform(0.5, 1.0, B).astype(np.float32)))
    rows = torch.from_numpy(rng.uniform(-0.3, 0.3, size=(B, N, 1 + K)).astype(np.float32))
    return rows, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_loss_and_gradients_match_the_plain_reference(dtype):
    model = _model(dtype)
    rows, batch = _inputs(3)
    dense = model.init_dense(torch.Generator().manual_seed(5))
    # non-zero biases, so every term of the combine and the MLP shows
    dense = [p + 0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(dense)]
    r = rows.clone().requires_grad_(True)
    d = [p.clone().requires_grad_(True) for p in dense]
    scores = model.score(r, d, batch)
    loss = logistic_loss(scores, batch.labels, batch.weights)
    grads = torch.autograd.grad(loss, [r, *d])

    r2 = rows.clone().requires_grad_(True)
    d2 = {n: p.clone().requires_grad_(True) for n, p in zip(model.dense_names, dense)}
    prec = ref.config_precision(_cfg(dtype))
    want = plain.score(r2, batch.vals, d2, _cfg(dtype), prec)
    want_loss = ref.logistic_loss(want, batch.labels, batch.weights)
    want_grads = torch.autograd.grad(want_loss, [r2, *d2.values()])

    assert sorted(plain.dense_shapes(_cfg(dtype))) == model.dense_names
    assert torch.equal(scores, want)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    assert float(grads[0][:3, -1].abs().max()) == 0.0  # padding slots take no gradient
    for name, got, exp in zip(["rows", *model.dense_names], grads, want_grads, strict=True):
        scale = float(exp.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got, exp, rtol=0, atol=1e-5 * scale, msg=name)


def test_cross_combine_twin_passes_gradcheck():
    rng = torch.Generator().manual_seed(11)
    x0, h, xl = (torch.randn(6, 7, generator=rng, dtype=torch.float64, requires_grad=True)
                 for _ in range(3))
    c = torch.randn(7, generator=rng, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: cross_combine(*a), (x0, h, c, xl))
    u, w = (torch.randn(7, 7, generator=rng, dtype=torch.float64, requires_grad=True)
            for _ in range(2))

    def two_layers(x0, c, u, w):
        acc = X0Grad(2)
        x1 = cross_combine(x0, x0 @ u, c, x0, acc)
        return cross_combine(x0, x1 @ w, c, x1, acc)

    # gradcheck runs the retained graph's backward many times: the shared
    # sum resets after each
    assert torch.autograd.gradcheck(two_layers, (x0, c, u, w))


@pytest.mark.parametrize("kw,needle", [
    (dict(cross_rank=0), "cross_rank >= 1"),
    (dict(cross_layers=0), "cross_layers >= 1"),
    (dict(max_nnz=N + 1), "dcnv2 needs max_nnz = num_fields"),
    (dict(num_fields=0, max_nnz=0), "dcnv2 requires num_fields > 0"),
])
def test_config_refuses(kw, needle):
    base = dict(model="dcnv2", num_fields=N, max_nnz=N, factor_num=K)
    with pytest.raises(ValueError, match=needle):
        Config(**dict(base, **kw)).validate()


def test_build_model_refuses_an_unknown_model_unvalidated():
    """A Config built without ``validate`` (as the benchmark's program
    builds it) of an unknown model raises instead of training a DeepFM."""
    with pytest.raises(ValueError, match="unknown model 'dcnv3'"):
        build_model(Config(model="dcnv3", num_fields=N))


def test_deepfm_is_bitwise_its_mlp_before_the_shared_helper():
    """DeepFM's deep half through ``value_weighted`` and ``relu_mlp`` is the
    composition it computed inline, bit for bit, at both precisions."""
    rows, batch = _inputs(7)
    for dtype in ("float32", "bfloat16"):
        model = DeepFMModel(97, N, K, hidden_dims=HIDDEN, compute_dtype=dtype)
        dense = model.init_dense(torch.Generator().manual_seed(1))
        leaf = dict(zip(model.dense_names, dense))
        x = (rows[..., 1:] * batch.vals[..., None]).reshape(B, N * K)
        for li in range(model.n_layers):
            x = compute_round(x, dtype) @ compute_round(leaf[f"w{li}"], dtype) + leaf[f"b{li}"]
            if li < model.n_layers - 1:
                x = torch.relu(x)
        assert torch.equal(model._deep(rows, dense, batch), x[..., 0])


def _libsvm(path, rng, n):
    lines = []
    for _ in range(n):
        toks = [f"{i}:{rng.uniform(0.1, 1.5):.4f}" for i in rng.choice(97, N, replace=False)]
        lines.append(f"{rng.integers(0, 2)} " + " ".join(toks))
    path.write_text("\n".join(lines) + "\n")
    return lines


def test_cli_train_predict_and_serve(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(13)
    _libsvm(tmp_path / "tr.libsvm", rng, 96)
    lines = _libsvm(tmp_path / "va.libsvm", rng, 40)
    cfg_path = tmp_path / "dcn.cfg"
    cfg_path.write_text(f"""[General]
model = dcnv2
factor_num = {K}
num_fields = {N}
cross_layers = {L}
cross_rank = {R}
hidden_dims = {' '.join(map(str, HIDDEN))}
compute_dtype = bfloat16
vocabulary_size = 97
model_file = {tmp_path / 'dcn.ckpt'}

[Train]
train_files = {tmp_path / 'tr.libsvm'}
validation_files = {tmp_path / 'va.libsvm'}
epoch_num = 2
batch_size = 16
max_nnz = {N}
learning_rate = 0.05
factor_lambda = 0
bias_lambda = 0
adagrad_accumulator = row

[Predict]
predict_files = {tmp_path / 'va.libsvm'}
score_path = {tmp_path / 'scores.txt'}
""")
    cfg = load_config(str(cfg_path))
    assert (cfg.model, cfg.cross_layers, cfg.cross_rank) == ("dcnv2", L, R)
    assert cli.main(["train", str(cfg_path), "--device", "cpu"]) == 0
    assert cli.main(["predict", str(cfg_path), "--device", "cpu"]) == 0
    scores = np.loadtxt(tmp_path / "scores.txt")
    assert scores.shape == (40,) and np.all((scores > 0) & (scores < 1))
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    assert cli.main(["serve", str(cfg_path), "--device", "cpu"]) == 0
    served = np.array(capsys.readouterr().out.split(), np.float64)
    np.testing.assert_allclose(served, scores, atol=1e-6 + 1e-9)

    # the trained checkpoint scores as the plain reference scores it
    model = build_model(cfg)
    state = restore_checkpoint(cfg.model_file, torch.device("cpu"), n_dense=len(model.dense_names))
    assert state.step == 12 and len(state.dense) == 3 * L + 2 * len(HIDDEN) + 2
    assert float(state.table[:, 0].abs().max()) == 0.0  # the unused bias column never moves
    ids = torch.tensor([[int(t.split(":")[0]) for t in s.split()[1:]] for s in lines])
    vals = torch.tensor([[float(t.split(":")[1]) for t in s.split()[1:]] for s in lines])
    want = torch.sigmoid(plain.score(state.table[ids], vals, dict(zip(model.dense_names, state.dense)),
                                     _cfg("bfloat16"), ref.config_precision(_cfg("bfloat16"))))
    np.testing.assert_allclose(scores, want.numpy(), atol=1e-6 + 1e-9)


def test_port_only_keys_are_the_dcnv2_keys():
    assert set(PORT_ONLY_KEYS) == {"cross_layers", "cross_rank"}
    fields = jax_fields(Config(model="deepfm", num_fields=N))
    assert not set(PORT_ONLY_KEYS) & set(fields) and fields["model"] == "deepfm"
    with pytest.raises(ValueError, match="cross_rank = 8 has no JAX counterpart"):
        jax_fields(Config(model="dcnv2", num_fields=N, cross_rank=8))
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "torch", "dcnv2_criteo1tb.cfg"))
    model = build_model(cfg)
    assert (model.factor_num, model.cross_layers, model.cross_rank, model.hidden_dims,
            model.width, model.row_dim) == (128, 3, 512, (1024, 1024, 512, 256), 4992, 129)


def test_a_reference_without_the_last_cross_term_fails_the_cell_s_limits():
    """The benchmark's comparison (``check.readings``) of the reference whose
    last cross layer returns x_l, in the port's place, reads above the
    cell's limits at a small size."""
    spec = tiny_spec(CELL, batch=64)
    spec["config"].update(factor_num=K, cross_rank=R, hidden_dims=list(HIDDEN))
    limits = check.load_limits(CELL, harness.HERE)
    for seed in (1, 2):
        numbers = fault_readings(spec, seed, torch.device("cpu"))
        assert not check.judge(numbers, limits)[0], numbers


def test_spans_mark_the_cross_network_and_the_mlp(tmp_path):
    """With spans on, a train step opens ``cross`` (the cross network) and
    ``mlp`` (the top MLP) inside ``forward``, and ``cross`` once a layer
    inside ``backward`` (the pair's backward); with spans off, none."""
    import json

    from fast_tffm_tpu_torch.trainer import init_state, make_train_step
    from fast_tffm_tpu_torch.utils import tracing

    model = _model("bfloat16")
    state = init_state(model, torch.Generator().manual_seed(0))
    _, batch = _inputs(9)
    batch = Batch(batch.labels, torch.arange(B * N, dtype=torch.int32).view(B, N) % 97,
                  batch.vals, batch.fields, batch.weights)
    step = make_train_step(model, 0.05)

    def spans(on):
        tracing.spans_on(on)
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                step(state, batch)
        finally:
            tracing.spans_on(False)
        path = str(tmp_path / "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in tracing.DEVICE_SPANS]

    assert spans(False) == []
    got = spans(True)

    def inside(name, outer):
        return [s for s in got if s[0] == name
                and any(o[0] == outer and o[1] <= s[1] and s[2] <= o[2] for o in got)]

    assert len(inside("cross", "forward")) == 1 and len(inside("mlp", "forward")) == 1
    assert len(inside("cross", "backward")) == L
    assert tracing.DEVICE_SPANS[-2:] == ("cross", "mlp")  # the earlier markers keep their ids
