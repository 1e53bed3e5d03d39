"""The DCN-V2 cell's benchmark files: the plain reference's shapes and
operation count, the traffic mix's reach, the two readers on a synthetic
trace, and (on the card) the fault with the last cross term left out
failing the cell's limits at its own size.

Fault a DCN-V2 program can have that the comparison must see: a cross
layer that leaves out its cross term x₀ ⊙ (h + c) (``fault_readings``)."""

from __future__ import annotations

import importlib.util
import math
import os
from unittest import mock

import pytest
import torch

from benchmark import check, devtrace, harness, roofline, traffic
from benchmark.readings import LayerReading
from benchmark.reference import common as ref
from benchmark.reference import dcnv2

CELL = "dcnv2_criteo1tb.fields_shard8"


def fault_readings(spec: dict, seed: int, dev) -> dict:
    """The comparison's three numbers of the reference whose last cross
    layer returns x_l (x₀ ⊙ (h + c) left out), in the port's place, against
    the sound reference, on the cell's checked batches of ``seed``."""
    cfg = spec["config"]
    prog, epoch, checked, _ = harness.prepare(spec, seed, dev)
    del prog, epoch
    harness.release(dev)
    keep = check.snapshot_steps(harness.cell_shape(spec)[2])
    followed = ref.reference_steps(cfg, checked, seed, dev, ref.config_precision(cfg), keep)
    layers, sound, calls = int(cfg["cross_layers"]), dcnv2.cross_layer, [0]

    def last_left_out(x0, x, v, u, c, prec):
        calls[0] += 1
        y = sound(x0, x, v, u, c, prec)
        # the last layer's leaves stay in the graph, with a zero gradient
        return x + 0.0 * y if calls[0] % layers == 0 else y

    with mock.patch.object(dcnv2, "cross_layer", last_left_out):
        faulted = ref.reference_steps(cfg, checked, seed, dev, ref.config_precision(cfg), keep)
    return check.readings(cfg, faulted, followed)


def _reader(name):
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_reference_has_mlperf_s_shapes_and_operations():
    cfg = harness.load_spec(CELL)["config"]
    shapes = dcnv2.dense_shapes(cfg)
    d, r = 39 * 128, 512
    for li in range(3):
        assert (shapes[f"wcv{li}"], shapes[f"wcu{li}"], shapes[f"bc{li}"]) == ((d, r), (r, d), (d,))
    mlp = (d, 1024, 1024, 512, 256, 1)
    assert [shapes[f"w{i}"] for i in range(5)] == list(zip(mlp[:-1], mlp[1:]))
    assert sum(math.prod(s) for s in shapes.values()) == 22_169_217
    flops = dcnv2.step_flops(cfg, 8192, 39)
    cross = 6 * 8192 * 3 * 2 * d * r
    top = 6 * 8192 * sum(a * b for a, b in zip(mlp[:-1], mlp[1:]))
    assert flops["bf16"] == cross + top
    assert round(cross / (cross + top), 2) == 0.69  # the cross network's share
    assert flops["fp32"] == 7 * 8192 * d * 3 + 4 * 8192 * sum(mlp[1:]) + 2 * 8192 * d
    # the step's least time: 1.10 ms of products at the card's bf16 peak,
    # 0.015 ms of float32 elementwise work at its float32 rate
    least, by = roofline.least_s(0, flops, roofline.PEAKS["NVIDIA H100 80GB HBM3"])
    assert by == "operations" and 1.11e-3 < least < 1.12e-3


def test_the_mix_is_one_card_s_share_of_the_tables():
    spec = harness.load_spec(CELL)
    mix, cfg = spec["mix"], spec["config"]
    assert traffic.rows_used(mix) == 26_503_455 <= int(cfg["vocabulary_size"]) == 2**25
    whole = traffic.load_mix("fields", harness.HERE)
    assert [(-(-c // 8) if c > 10**6 else c) for c in whole["categorical_cardinalities"]] \
        == mix["categorical_cardinalities"]
    assert round(traffic.rows_used(mix) / traffic.rows_used(whole), 3) == 0.130
    assert int(mix["rows"]) // int(cfg["batch_size"]) == 128  # 16 K = 8 chunks


def _reading(kernels: list, steps=2, b=8192, n=39, d=129):
    events = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 10_000,
               "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0,
                "tid": 7} for name, ts, dur in kernels]
    return LayerReading(
        trace=devtrace.from_events(events), kernels={}, steps=steps, batch_size=b,
        n_fields=n, unique_per_step=[1] * steps, row_dim=d, accum_width=1, dense_numel=0,
        flops_per_step={}, peaks=roofline.PEAKS["NVIDIA H100 80GB HBM3"])


def test_the_readers_on_a_synthetic_trace():
    fwd = "void (anonymous namespace)::dcn_cross_fwd_kernel<4>(float const*, int)"
    bwd = "void (anonymous namespace)::dcn_cross_bwd_kernel<4>(float const*, int, int)"
    # two steps of three layers: 200 us a forward, 300 a backward, and a GEMM
    kernels = [(fwd, 100 + 1000 * i, 200) for i in range(6)]
    kernels += [(bwd, 400 + 1000 * i, 300) for i in range(6)]
    kernels += [("sm90_xmma_gemm_f32f32", 800, 150)]
    r = _reading(kernels)
    assert _reader("cross_ms_per_step")(r) == pytest.approx(6 * 0.5 / 2)
    elements = 8192 * 39 * 128
    least = 6 * (16 + 20) * elements / 3.35e12
    assert _reader("roofline.dcn_cross")(r) == pytest.approx(100 * least / 3e-3)
    none = _reading([("sm90_xmma_gemm_f32f32", 800, 150)])
    assert _reader("cross_ms_per_step")(none) is None
    assert _reader("roofline.dcn_cross")(none) is None


def test_the_pair_s_names_fall_in_no_kernel_group():
    import json

    with open(os.path.join(harness.HERE, "kernels.json")) as f:
        groups = json.load(f)["groups"]
    for name in ("dcn_cross_fwd_kernel", "dcn_cross_bwd_kernel"):
        assert not [p for pats in groups.values() for p in pats if p in name]


@pytest.mark.cuda
def test_the_fault_fails_the_cell_s_limits_at_its_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load_spec(CELL)
    limits = check.load_limits(CELL, harness.HERE)
    numbers = fault_readings(spec, 2147483701, torch.device("cuda"))
    assert not check.judge(numbers, limits)[0], numbers
