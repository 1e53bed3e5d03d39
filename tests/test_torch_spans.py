"""Port: the spans and counters of ``utils/tracing.py``.

On the CPU:

* spans off record no event, launch no marker and count nothing;
* spans on give the fixed names (``step`` > ``batch``, ``gather``,
  ``forward``, ``backward``, ``sort``, ``tail``, ``dense``), properly nested,
  in a ``torch.profiler`` trace of a tiny FM and a tiny DeepFM step, eager
  and through the K-step loop;
* ``tail.unique_rows`` is ``torch.unique``'s count summed over the steps,
  on the rows and the fused layouts;
* the state after several steps is bitwise the same with spans on as off;
* ``StepProfiler`` and ``WindowTracer`` turn spans on one call before their
  window and off when it closes, and their records carry the counters'
  change over the window; in a training run the call that turns spans on
  counts as warm-up (its build and capture are no steady-state compile);
* ``read_spans`` on synthetic trace events: markers become span
  intervals, operations go to the innermost span, idle gaps inside spans to
  the span and outside to ``outside``, and a trace without markers has no
  span.

On the card (marked ``cuda``, skipping without one; this file imports no
JAX, so it runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``): the K-step graph captured with spans off has
no marker, and the instrumented one only the markers and the counters'
kernels more, and is dropped when spans go off; an instrumented replay carries every span of every step;
span device time, idle time inside spans and marker time account for the
calls' device time (CUDA events) within 1%; the counter equals the
batches' distinct ids; the state is bitwise the same with spans on as off.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import pytest
import torch

from fast_tffm_tpu_torch import telemetry
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.device_cache import (
    DeviceDataset,
    epoch_index_chunks,
    make_cached_scan_train_step,
    make_cached_train_step,
)
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.profiling import StepProfiler
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.trainer import (
    init_state,
    make_scanned_train_step,
    pack_state,
    packed_train_step_body,
)
from fast_tffm_tpu_torch.training import train
from fast_tffm_tpu_torch.utils import tracing
from fast_tffm_tpu_torch.utils.tracing import WindowTracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = ["fm", "deepfm"]
PHASES = ["batch", "gather", "forward", "backward", "sort", "tail"]
OURS = set(tracing.DEVICE_SPANS) | {"step_graph.call", "step_graph.capture"}


@pytest.fixture(autouse=True)
def spans_off():
    tracing.spans_on(False)
    yield
    tracing.spans_on(False)


def _setup(kind, device="cpu", v=512, b=32, n=6, batches=8, factor=4, seed=0):
    """A model, its fresh state and a resident epoch of ``batches`` batches
    with repeated ids (each field a small slice of its own)."""
    cfg = Config(model=kind, factor_num=factor, vocabulary_size=v, max_nnz=n,
                 num_fields=n if kind == "deepfm" else 0, hidden_dims=(16, 8),
                 factor_lambda=1e-4, bias_lambda=1e-4)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_state(model, gen)
    rows = b * batches
    cap = v // n
    g = torch.Generator().manual_seed(seed + 1)
    ids = (torch.arange(n) * cap + torch.randint(0, max(2, cap // 4), (rows, n), generator=g))
    data = DeviceDataset(
        labels=(torch.rand(rows, generator=g) < 0.3).float(),
        ids=ids.to(torch.int32), vals=torch.ones(rows, n),
        fields=(torch.arange(n, dtype=torch.int32).expand(rows, n).contiguous()
                if model.uses_fields else torch.zeros((rows, 0), dtype=torch.int32)),
        weights=torch.ones(rows), batches=batches, batch_size=b, n_rows=rows,
        offsets=torch.arange(b, dtype=torch.int64),
    )
    data = dataclasses.replace(data, **{
        f.name: getattr(data, f.name).to(device) for f in dataclasses.fields(data)
        if isinstance(getattr(data, f.name), torch.Tensor)})
    return model, state, data


def _copy(state):
    return dataclasses.replace(
        state, table=state.table.clone(), table_accum=state.table_accum.clone(),
        dense=[p.clone() for p in state.dense], dense_accum=[a.clone() for a in state.dense_accum])


def _run(model, state, data, k, calls, eager=False):
    """``calls`` K-step calls (or ``calls``·K eager steps) from batch 0; the losses."""
    losses = []
    if eager:
        step = make_cached_train_step(model, 0.05, data)[0]
        for i in range(calls * k):
            state, loss = step(state, torch.tensor(i, device=data.ids.device))
            losses.append(loss.reshape(1))
    else:
        step = make_cached_scan_train_step(model, 0.05, data)[0]
        chunks = epoch_index_chunks(data.batches, k, data.ids.device)
        for i in range(calls):
            state, loss = step(state, chunks[i % len(chunks)])
            losses.append(loss)
    return state, torch.cat(losses)


def _traced(fn, tmp_path, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


def _tree(events):
    """Our host spans as nested (name, children) lists, in time order."""
    ours = sorted(((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in OURS), key=lambda x: (x[0], -x[1]))
    root = ("", [])
    stack = [(float("inf"), root)]
    for ts, dur, name in ours:
        while ts >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((ts + dur, node))
    return root[1]


def _phases(kind):
    return PHASES + (["dense"] if kind == "deepfm" else [])


def _same(a, b):
    assert a.step == b.step
    assert torch.equal(a.table, b.table) and torch.equal(a.table_accum, b.table_accum)
    assert all(torch.equal(x, y) for x, y in zip(a.dense, b.dense))
    assert all(torch.equal(x, y) for x, y in zip(a.dense_accum, b.dense_accum))


# --- the CPU --------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_spans_off_record_nothing_and_launch_nothing(kind, tmp_path, monkeypatch):
    marks = []
    monkeypatch.setattr(tracing, "_mark", lambda *a: marks.append(a))
    model, state, data = _setup(kind)
    before = tracing.counters()

    def both():
        st, _ = _run(model, state, data, k=4, calls=1)
        return _run(model, st, data, k=1, calls=2, eager=True)

    _, events = _traced(both, tmp_path)
    assert _tree(events) == []
    assert marks == [] and tracing.counters() == before
    assert tracing.span("step") is tracing.span("tail")  # one shared no-op


@pytest.mark.parametrize("eager", [False, True], ids=["k_step", "eager"])
@pytest.mark.parametrize("kind", KINDS)
def test_spans_on_give_the_fixed_names_nested(kind, eager, tmp_path, monkeypatch):
    marks = []
    monkeypatch.setattr(tracing, "_mark", lambda *a: marks.append(a))
    model, state, data = _setup(kind)
    k = 3
    tracing.spans_on(True)
    _, events = _traced(lambda: _run(model, state, data, k=k, calls=2, eager=eager), tmp_path)
    steps = [(name, [c[0] for c in kids]) for name, kids in _tree(events)]
    if eager:
        # no K-step loop: each step's phases at the top
        assert [s[0] for s in steps] == _phases(kind) * 2 * k
    else:
        want = ("step_graph.call", [("step", _phases(kind))] * k)
        got = [(name, [(c[0], [g[0] for g in c[1]]) for c in kids])
               for name, kids in _tree(events)]
        assert got == [want] * 2, steps
    assert marks == []  # no CUDA here: host spans only


@pytest.mark.parametrize("layout", ["rows", "fused"])
def test_unique_rows_counts_each_steps_distinct_ids(layout):
    model, state, data = _setup("fm")
    k, calls = 4, 2
    b = data.batch_size
    tracing.spans_on(True)
    before = tracing.counters()
    if layout == "rows":
        _run(model, state, data, k=k, calls=calls)
    else:
        step = make_scanned_train_step(model, 0.05, body=packed_train_step_body)
        # the fused layout keeps a row accumulator
        packed = pack_state(dataclasses.replace(
            state, table_accum=state.table_accum[:, :1].contiguous()), 0.1, fused=True)
        for c in range(calls):
            sl = slice(c * k * b, (c + 1) * k * b)
            sb = Batch(*(a[sl].reshape(k, b, *a.shape[1:]) for a in data.arrays))
            packed, _ = step(packed, sb)
    after = tracing.counters()
    n = k * calls
    want = sum(int(torch.unique(data.ids[i * b:(i + 1) * b]).numel()) for i in range(n))
    assert after.get("tail.unique_rows", 0) - before.get("tail.unique_rows", 0) == want
    tracing.spans_on(False)
    _run(model, state, data, k=k, calls=1)
    assert tracing.counters() == after  # counted only while spans are on


@pytest.mark.parametrize("kind", KINDS)
def test_spans_leave_the_state_bitwise(kind):
    model, state, data = _setup(kind)
    off, loss_off = _run(model, _copy(state), data, k=4, calls=2)
    tracing.spans_on(True)
    on, loss_on = _run(model, _copy(state), data, k=4, calls=2)
    _same(on, off)
    assert torch.equal(loss_on, loss_off)


def test_profiler_and_tracer_turn_spans_on_one_call_before(tmp_path):
    prof = StepProfiler("4:8", str(tmp_path / "p"))
    seen = []
    for step in range(1, 11):
        prof.on_step(step)
        seen.append(tracing.spans_enabled())
    prof.close(10)
    # on after step 3 (the next call reaches 4), the trace from step 4 to 8
    assert seen == [False, False, True, True, True, True, True, False, False, False]
    assert not tracing.spans_enabled() and prof.path

    tracer = WindowTracer(str(tmp_path / "w"), skip=2, count=2)
    seen = []
    for _ in range(6):
        tracer.on_step()  # before each call
        seen.append(tracing.spans_enabled())
    tracer.close()
    # call 1 (the second) captures with spans on; calls 2 and 3 are traced
    assert seen == [False, True, True, True, False, False] and tracer.path
    assert not tracing.spans_enabled()


def _read(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_profiler_and_tracer_record_the_windows_counters(tmp_path):
    """The ``trace_stop`` and ``window_stop`` records carry the change of
    each counter over their window, and nothing counted before it."""
    mon = RunMonitor(str(tmp_path / "m.jsonl"))
    prof = StepProfiler("3:5", str(tmp_path / "p"), monitor=mon)
    for step in range(1, 8):  # a call a step, counting its step's number
        tracing.count_on_device("tail.unique_rows", torch.tensor(step))
        prof.on_step(step)
    prof.close(7)
    tracer = WindowTracer(str(tmp_path / "w"), skip=2, count=2, monitor=mon)
    for call in range(6):
        tracer.on_step()  # before each call
        tracing.count_on_device("tail.unique_rows", torch.tensor(10 ** call))
    tracer.close()
    mon.close()
    records = {r["event"]: r for r in _read(tmp_path / "m.jsonl") if r["kind"] == "profile"}
    # counted from step 3 (spans on after step 2); the trace holds steps 4 and 5
    assert records["trace_stop"]["counters"] == {"tail.unique_rows": 4 + 5}
    # counted from call 1; the window holds calls 2 and 3
    assert records["window_stop"]["counters"] == {"tail.unique_rows": 100 + 1000}
    assert records["window_stop"]["trace_path"] == tracer.path and os.path.isfile(tracer.path)
    assert tracer.counters == {"tail.unique_rows": 1100}


def test_a_spans_switch_is_warm_up(tmp_path, monkeypatch):
    """A profile window in a later epoch: the call that turns spans on (on
    the card, the marker's build and the instrumented capture, here one
    compile noted at the first count) is warm-up, and the cost ledger stages
    no program for it."""
    original = tracing.count_on_device
    noted = []

    def count_and_compile(name, value):
        if not noted:
            noted.append(name)
            telemetry.note_compile()
        original(name, value)

    monkeypatch.setattr(tracing, "count_on_device", count_and_compile)
    src = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
    cfg = Config(order=3, vocabulary_size=256, max_nnz=8, batch_size=20, log_every=5,
                 epoch_num=2, train_files=(src,), model_file=str(tmp_path / "m.ckpt"),
                 metrics_path=str(tmp_path / "m.jsonl"), telemetry_profile_steps="26:30",
                 telemetry_profile_costs=True).validate()
    train(cfg, device="cpu", log=lambda *_: None)
    records = _read(tmp_path / "m.jsonl")
    assert noted == ["tail.unique_rows"] and not tracing.spans_enabled()
    assert [r for r in records if r["kind"] == "compile" and not r["warmup"]] == []
    (summary,) = [r for r in records if r["kind"] == "summary"]
    assert summary["steady_compiles"] == 0 and summary["total_compiles"] >= 1
    (stop,) = [r for r in records if r.get("event") == "trace_stop"]
    assert stop["counters"]["tail.unique_rows"] > 0
    programs = [r["program"] for r in records if r["kind"] == "profile"
                and r["program"] != "trace"]
    assert len(programs) == len(set(programs))


# --- read_spans on synthetic events ----------------------------------------


def ev(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def mark(span, begin, ts):
    i = tracing.DEVICE_SPANS.index(span)
    return ev("kernel", f"void (anonymous namespace)::span_mark<{i}, {int(begin)}>()", ts, 1)


def test_read_spans_puts_work_and_gaps_in_the_innermost_span():
    events = [
        ev("user_annotation", "step_graph.call", 0, 20, tid=1),
        ev("kernel", "before", 0, 5),  # in no span
        mark("step", 1, 10),
        mark("gather", 1, 11),
        ev("kernel", "index_elementwise_kernel", 12, 8),
        ev("gpu_memset", "Memset", 14, 2, tid=8),  # another stream, no span open there
        mark("gather", 0, 22),  # gap 20-22 idles inside gather
        ev("kernel", "counter", 23, 2),  # step only
        mark("sort", 1, 25),
        ev("kernel", "DeviceRadixSortOnesweepKernel", 26, 4),
        mark("sort", 0, 30),
        mark("step", 0, 40),  # gap 31-40 idles inside step
        ev("kernel", "after", 50, 5),  # gap 41-50 outside
    ]
    r = tracing.read_spans(events)
    sp = r["spans"]
    assert sp["step"] == pytest.approx({"n": 1, "device_ms": 2e-3, "idle_ms": 9e-3})
    assert sp["gather"] == pytest.approx({"n": 1, "device_ms": 8e-3, "idle_ms": 2e-3})
    assert sp["sort"] == pytest.approx({"n": 1, "device_ms": 4e-3, "idle_ms": 0.0})
    assert r["markers"] == pytest.approx({"n": 6, "device_ms": 6e-3})
    # 0-5 and 50-55 run in no span, nor the memset of another stream; the
    # gaps 5-10 and 41-50 too
    assert r["outside"] == pytest.approx({"device_ms": 12e-3, "idle_ms": 14e-3})
    assert r["host"] == {"step_graph.call": {"n": 1, "ms": pytest.approx(0.02)}}
    total = sum(s["device_ms"] + s["idle_ms"] for s in sp.values())
    # the stretch's 55 µs, plus the 2 µs the memset overlaps the gather
    assert total + r["markers"]["device_ms"] + r["outside"]["device_ms"] + \
        r["outside"]["idle_ms"] == pytest.approx(57e-3)


def test_read_spans_windows_and_skips_unmatched_closes():
    events = [
        mark("tail", 0, 0),  # the trace began inside a tail: skipped
        mark("step", 1, 2),
        ev("kernel", "k", 3, 4),
        mark("step", 0, 7),
        mark("step", 1, 100),  # past the window
    ]
    r = tracing.read_spans(events, start=1, end=50)
    assert r["spans"] == {"step": pytest.approx({"n": 1, "device_ms": 4e-3, "idle_ms": 0.0})}
    assert r["markers"]["n"] == 2


def test_read_spans_without_markers_has_no_span():
    r = tracing.read_spans([ev("kernel", "k", 0, 4), ev("kernel", "k", 10, 4)])
    assert r["spans"] == {} and r["markers"]["n"] == 0
    assert r["outside"] == pytest.approx({"device_ms": 8e-3, "idle_ms": 6e-3})


# --- the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_setup(kind, card):
    if kind == "fm":  # the fm2 cell's widths, a smaller table
        return _setup("fm", card, v=1 << 22, b=16384, n=39, batches=16, factor=16)
    return _setup("deepfm", card, v=1 << 22, b=8192, n=39, batches=16, factor=8)


def _device_ops(events):
    """Device operations' names (a graph's memset nodes run as kernels or as
    memsets, and may switch between the two from one capture to the next)."""
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_card_spans_off_graph_has_no_marker(kind, card, tmp_path):
    model, state, data = _card_setup(kind, card)
    k = 8
    step = make_cached_scan_train_step(model, 0.05, data)[0]
    chunk = epoch_index_chunks(data.batches, k, card)[0]

    def one():
        step(state, chunk)
        torch.cuda.synchronize()

    one()  # capture, spans off
    _, off = _traced(one, tmp_path, cuda=True)
    tracing.spans_on(True)
    one()  # the instrumented capture
    _, on = _traced(one, tmp_path, cuda=True)
    tracing.spans_on(False)
    _, again = _traced(one, tmp_path, cuda=True)
    assert step.captures == 2
    n_off, n_on, n_again = _device_ops(off), _device_ops(on), _device_ops(again)
    assert not [n for n in n_off if "span_mark" in n]
    markers = [n for n in n_on if "span_mark" in n]
    assert len(markers) == 2 * k * len(["step"] + _phases(kind))
    extra = len(n_on) - len(markers) - len(n_off)  # the counter's operations, per step
    assert 0 < extra <= 6 * k and extra % k == 0
    assert len(n_again) == len(n_off)  # spans off replays the plain graph again
    assert [key[0] for key in step._graphs] == [False]  # the instrumented one dropped


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_card_instrumented_replays_account_for_the_call(kind, card, tmp_path):
    model, state, data = _card_setup(kind, card)
    k, calls = 8, 4
    b = data.batch_size
    step = make_cached_scan_train_step(model, 0.05, data)[0]
    chunks = epoch_index_chunks(data.batches, k, card)
    tracing.spans_on(True)
    step(state, chunks[0])  # the instrumented capture
    torch.cuda.synchronize()
    before = tracing.counters()

    def stretch():
        # A spin on the card (~0.2 s at its ~2 GHz) holds the stream while
        # the host queues every call: under the profiler a graph launch costs
        # the host about as much as a replay costs the card, so without it
        # the card would idle between replays outside any span.  Call 0
        # then runs, and the timed calls 1..calls run back to back.
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000_000)
        step(state, chunks[0])
        ev0.record()
        for i in range(1, calls + 1):
            step(state, chunks[i % len(chunks)])
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1)

    call_ms, events = _traced(stretch, tmp_path, cuda=True)
    after = tracing.counters()
    opens = sorted(float(e["ts"]) for e in events if e.get("cat") == "kernel"
                   and tracing._marker_of(e["name"]) == ("step", True))
    assert len(opens) == (calls + 1) * k
    r = tracing.read_spans(events, start=opens[k])  # calls 1..calls
    names = ["step"] + _phases(kind)
    for name in names:
        assert r["spans"][name]["n"] == calls * k, (name, r["spans"])
    assert r["markers"]["n"] == 2 * calls * k * len(names)
    spans_ms = sum(s["device_ms"] + s["idle_ms"] for s in r["spans"].values())
    accounted = spans_ms + r["markers"]["device_ms"]
    assert abs(accounted - call_ms) <= 0.01 * call_ms, (accounted, call_ms, r)
    assert r["host"]["step_graph.call"]["n"] == calls + 1
    batches = [int(i) for c in range(calls + 1) for i in chunks[c % len(chunks)].tolist()]
    want = sum(int(torch.unique(data.ids[i * b:(i + 1) * b]).numel()) for i in batches)
    assert after["tail.unique_rows"] - before.get("tail.unique_rows", 0) == want
    assert step.replays == calls + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_card_spans_leave_the_state_bitwise(kind, card):
    model, state, data = _card_setup(kind, card)
    off, loss_off = _run(model, _copy(state), data, k=8, calls=3)
    tracing.spans_on(True)
    on, loss_on = _run(model, _copy(state), data, k=8, calls=3)
    tracing.spans_on(False)
    torch.cuda.synchronize()
    _same(on, off)
    assert torch.equal(loss_on, loss_off)


@pytest.mark.cuda
def test_card_fused_layout_counts_and_marks(card):
    model, state, data = _setup("fm", card, v=1 << 16, b=4096, n=39, batches=8, factor=8)
    k = 4
    b = data.batch_size
    step = make_scanned_train_step(model, 0.05, body=packed_train_step_body)
    packed = pack_state(dataclasses.replace(state, table_accum=state.table_accum[:, :1]
                                            .contiguous()), 0.1, fused=True)
    tracing.spans_on(True)
    before = tracing.counters()
    for c in range(2):
        sl = slice(c * k * b, (c + 1) * k * b)
        packed, _ = step(packed, Batch(*(a[sl].reshape(k, b, *a.shape[1:]) for a in data.arrays)))
    after = tracing.counters()
    # the first call's warm-up ran its K steps once before its replay
    want = sum(int(torch.unique(data.ids[i * b:(i + 1) * b]).numel())
               for i in [*range(k), *range(2 * k)])
    assert after["tail.unique_rows"] - before.get("tail.unique_rows", 0) == want


@pytest.mark.cuda
def test_card_a_profile_window_in_a_later_epoch_is_warm_up(card, tmp_path):
    """A resident K = 8 run whose profile window opens in epoch 2: the call
    before it builds the marker and captures the instrumented graph, as
    warm-up (no steady-state compile, no second ``train_graph_k8``); the
    window's trace carries the markers and its record the counter."""
    src = str(tmp_path / "train.libsvm")  # 400 rows: 2 calls of 8 x 25 (its FMB beside it)
    shutil.copy(os.path.join(REPO, "data", "train.libsvm"), src)
    cfg = Config(order=3, vocabulary_size=256, max_nnz=8, batch_size=25, log_every=8,
                 epoch_num=2, train_files=(src,), model_file=str(tmp_path / "m.ckpt"),
                 device_cache=True, binary_cache=True, steps_per_call=8,
                 metrics_path=str(tmp_path / "m.jsonl"), telemetry_profile_steps="24:32",
                 telemetry_profile_costs=True).validate()
    train(cfg, device="cuda", log=lambda *_: None)
    records = _read(tmp_path / "m.jsonl")
    assert not tracing.spans_enabled()
    assert [r for r in records if r["kind"] == "compile" and not r["warmup"]] == []
    (summary,) = [r for r in records if r["kind"] == "summary"]
    assert summary["steady_compiles"] == 0
    programs = sorted(r["program"] for r in records if r["kind"] == "profile"
                      and r["program"] != "trace")
    assert programs == ["train_graph_k8", "train_step"]
    (stop,) = [r for r in records if r.get("event") == "trace_stop"]
    assert 0 < stop["counters"]["tail.unique_rows"] <= 8 * 25 * 8
    with open(stop["trace_path"]) as f:
        names = _device_ops(json.load(f)["traceEvents"])
    marks = sum("span_mark" in n for n in names)
    assert marks > 0 and marks % (2 * 8 * (1 + len(_phases("fm")))) == 0  # whole calls
