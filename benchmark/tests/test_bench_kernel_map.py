"""The kernel-name map (``benchmark/kernels.json``) and the trace reading
it feeds: which device operation belongs to which group, the union of
busy intervals, and the idle gaps by host event."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import devtrace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(HERE), "fast_tffm_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def groups():
    with open(os.path.join(HERE, "kernels.json")) as f:
        return json.load(f)["groups"]


def test_every_port_kernel_symbol_is_a_kernel_of_csrc(groups):
    """The frozen copy of the port's kernel names still names ``__global__``
    functions of csrc/*.cu."""
    src = "".join(open(os.path.join(CSRC, f)).read() for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))
    kernels = set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                             r"(?:void\s+)?(\w+)\s*\(", src))
    for g in ("rows_tail", "fused_tail", "anova_fwd", "anova_bwd"):
        for sym in groups[g]:
            assert sym in kernels, (g, sym, sorted(kernels))


@pytest.mark.parametrize("name, group", [
    ("void rows_element_kernel<17>(float*, float*, int const*, long const*, float const*)",
     "rows_tail"),
    ("void fused_slot_kernel(float*, int const*, long const*, float const*, int, int)",
     "fused_tail"),
    ("void cub::CUB_200302_900_NS::DeviceRadixSortOnesweepKernel<cub::...>(int*, int*)", "sort"),
    ("void cub::CUB_200302_900_NS::DeviceRadixSortHistogramKernel<cub::...>(...)", "sort"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_warpgroupsize1x1x1", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(...)", "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>(...)", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(...)",
     None),
    ("void at::native::index_elementwise_kernel<128, 4, ...>(...)", None),
])
def test_names_map_to_their_group(groups, name, group):
    hits = [g for g, pats in groups.items() if devtrace.match(name, pats)]
    assert hits == ([group] if group else [])


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_busy_is_the_union_and_gaps_go_to_the_host_event():
    events = [
        ev("user_annotation", "window", 100, 100),
        ev("user_annotation", "call", 100, 40),
        ev("cuda_runtime", "cudaGraphLaunch", 105, 5),
        ev("user_annotation", "call", 150, 30),
        ev("user_annotation", "sync", 185, 15),
        ev("cuda_runtime", "cudaDeviceSynchronize", 186, 14),
        ev("user_annotation", "elsewhere", 100, 100, tid=2),  # another thread
        ev("kernel", "rows_element_kernel", 90, 20),  # clipped to [100, 110]
        ev("kernel", "k2", 120, 20),
        ev("gpu_memset", "Memset", 125, 5),  # inside k2: counted once
        ev("kernel", "k3", 170, 10),
        ev("gpu_user_annotation", "call", 100, 100),  # a device-side span, not work
    ]
    tr = devtrace.from_events(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert devtrace.busy_s(tr) == pytest.approx(40e-6)
    assert devtrace.gaps(tr) == [(110.0, 120.0), (140.0, 170.0), (180.0, 200.0)]
    causes = dict(devtrace.idle_causes(tr))
    # 110: inside the first call; 140: between calls (the window); 180: the window again
    assert causes == pytest.approx({"call": 10e-6, "window": 50e-6})
    ops = dict(devtrace.device_ops(tr))
    assert ops["k2"] == pytest.approx(20e-6) and ops["rows_element_kernel"] == pytest.approx(10e-6)
    assert devtrace.group_seconds(tr, ["rows_element"]) == pytest.approx(10e-6)


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError, match="window"):
        devtrace.from_events([ev("kernel", "k", 0, 1)])
