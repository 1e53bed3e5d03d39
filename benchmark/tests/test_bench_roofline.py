"""The roofline arithmetic against counts by hand on tiny shapes, and the
per-layer readers over a made-up trace."""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark import devtrace, roofline
from benchmark.readings import LayerReading, WindowReading
from benchmark.reference import deepfm, fm

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PK = {"hbm_bytes_per_s": 1000.0, "fp32": 10.0, "bf16": 100.0}


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_step_bytes_by_hand():
    # B 2, N 3, U 4 rows of D 3 with an element accumulator (A 3), 5 dense parameters:
    # ids + values 2·3·8 = 48; labels + weights 2·8 = 16; rows 4·(3+3)·4·2 = 192;
    # dense 5·4·2·2 = 80
    assert roofline.step_bytes(2, 3, 4, 3, 3, 5) == 336
    assert roofline.step_bytes(2, 3, 4, 3, 1, 0) == 48 + 16 + 4 * 4 * 4 * 2


def test_tail_work_by_hand():
    # M 6 occurrences onto U 4 rows, D 3, A 1: ids 24 + grads 72 + rows 4·4·4·2 = 128
    nbytes, flops = roofline.tail_work(6, 4, 3, 1)
    assert nbytes == 24 + 72 + 128
    assert flops == {"fp32": 6 * 3 + 6 * 4 * 3}


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(2000, {"fp32": 10}, PK) == (2.0, "bytes")
    assert roofline.least_s(10, {"fp32": 10, "bf16": 100}, PK) == (2.0, "operations")


def test_model_flops_by_hand():
    cfg = {"factor_num": 2, "num_fields": 3, "hidden_dims": [4], "compute_dtype": "bfloat16"}
    # FM, B 1, N 3, k 2, D 3: forward 2·3 + 4·3·2 + 3·2 = 36, backward 3 + 3·3·2 = 21,
    # L2 4·3·3 = 36
    assert fm.step_flops(cfg, 1, 3) == {"fp32": 93.0}
    # the MLP 6 → 4 → 1: 6·B·(6·4 + 4·1) = 168 at bf16; value weighting 2·3·2 = 12 and
    # bias and ReLU 4·(4 + 1) = 20 at fp32
    assert deepfm.step_flops(cfg, 1, 3) == {"fp32": 93.0 + 32.0, "bf16": 168.0}
    cfg["compute_dtype"] = "float32"
    assert deepfm.step_flops(cfg, 1, 3) == {"fp32": 93.0 + 32.0 + 168.0}


def layer_reading(device):
    tr = devtrace.Trace(start=0.0, end=1e6, device=device, host=[])
    kernels = {"rows_tail": ["rows_element"], "sort": ["RadixSort"], "fused_tail": ["fused_slot"],
               "gemm": ["gemm"]}
    return LayerReading(trace=tr, kernels=kernels, steps=4, batch_size=2, n_fields=3,
                        unique_per_step=[4, 4, 4, 4], row_dim=3, accum_width=3, dense_numel=5,
                        flops_per_step={"fp32": 10.0}, peaks=PK)


def test_layer_readers_by_hand():
    r = layer_reading([("rows_element_kernel", 0.0, 0.5e6), ("DeviceRadixSortOnesweep", 0.4e6,
                                                            0.6e6), ("sgemm", 0.6e6, 0.7e6)])
    assert reader("device_idle_share")(r) == pytest.approx(30.0)  # union 0.7 of 1 s
    assert reader("tail_ms_per_step")(r) == pytest.approx(1e3 * 0.7 / 4)
    assert reader("mlp_ms_per_step")(r) == pytest.approx(1e3 * 0.1 / 4)
    # a step's least: bytes 336 / 1000 = 0.336 s against 10 / 10 = 1 s: operations
    assert reader("mfu")(r) == pytest.approx(100.0 * 4 * 1.0 / 1.0)
    # B4: M 6 onto 4 rows, D 3, A 3: bytes 24 + 72 + 4·6·8 = 288 -> 0.288 s; operations
    # 18 + 72 = 90 -> 9 s at fp32 10/s
    assert reader("roofline.rows_tail")(r) == pytest.approx(100.0 * 4 * 9.0 / 0.5)


def test_readers_that_find_nothing_return_nothing():
    r = layer_reading([])
    for name in ("device_idle_share", "tail_ms_per_step", "mlp_ms_per_step",
                 "roofline.rows_tail"):
        assert reader(name)(r) is None
    r = layer_reading([("k", 0.0, 1.0)])
    r.peaks = {}
    assert reader("mfu")(r) is None


def test_end_to_end_readers():
    w = WindowReading(setup_s=12.5, window_s=2.0, calls=10, steps=80, examples=80 * 16384)
    assert reader("examples_per_s")(w) == 80 * 16384 / 2.0
    assert reader("setup_s")(w) == 12.5
