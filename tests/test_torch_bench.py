"""Port: bench_torch.py against the JAX package's bench.py.

* The helpers, bitwise: ``zipf_ids`` and ``make_batch``'s arrays for the
  same rng and batch index, the three modeled-bytes formulas on the same
  batches, and ``ensure_scale_fmb``'s file (zipf and all-ones) byte for
  byte, each package reading the other's cache.
* The legs against the JAX bench's step, from one shared npz state on the
  same batches through each bench's own ``measure`` (1 + 3 warm-up + 2
  timed steps): the fused scale rung (the JAX fused compact step against
  the port's fused step, kernel B3's twin) and the packed headline (the
  JAX packed step against the port's packed element step, kernel B4's
  twin at the packed address): unpacked tables and accumulators within
  atol 1e-6 (summation order: a few float32 ulps over six steps).
* The line: ``bench_main`` on the CPU at small sizes set through the
  module's constants; its keys contain the JAX line's keys
  (BENCH_r18.json, bench.py's last committed line), ``tail_ab``'s too;
  tools/report.py reads and renders it and writes the delta report.
* Failures: a failed section gives ``*_error`` on the printed line and
  exit 1 (its legs' timing helpers cut to one step each);
  ``BENCH_TAIL_MODES=xla`` raises; ``--tier [args]`` runs
  tools/torch_probe_tier.py [args] and returns its exit code; without a
  card and without ``--device cpu`` it raises.
* ``--dist 2 --device cpu``: two gloo ranks of the port's dist_train over
  shard-disjoint FMB files, the pod's rate and per-host records.
* The three drivers import neither jax nor the JAX package.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from fast_tffm_tpu import trainer as jax_trainer
from fast_tffm_tpu.models import FMModel as JaxFM
from fast_tffm_tpu.ops import packed_table as jpt
from fast_tffm_tpu.optim import AdagradState
from fast_tffm_tpu_torch.models import FMModel
from fast_tffm_tpu_torch.ops import packed_table as pt
from fast_tffm_tpu_torch.trainer import (
    TrainState,
    make_packed_train_step,
    pack_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import report  # noqa: E402

CPU = torch.device("cpu")
V, K, B = 1000, 8, 32  # 1000 % 12 = 4: a partial last fused tile row


@pytest.mark.parametrize("shape,vocab,seed", [((16, 39), 1 << 24, 0), ((64, 11), 97, 5),
                                              ((1, 3), 1, 9)])
def test_zipf_ids_bitwise(shape, vocab, seed):
    a = bench.zipf_ids(np.random.default_rng(seed), shape, vocab)
    b = bt.zipf_ids(np.random.default_rng(seed), shape, vocab)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("idx", [0, 7, 400])
def test_make_batch_bitwise(idx):
    ids = bench.zipf_ids(np.random.default_rng(idx), (24, 39), 1 << 20)
    want = bench.make_batch(ids, idx)
    got = bt.batch_arrays(ids, idx)
    tensors = bt.make_batch(ids, idx, CPU)
    for name in ("labels", "ids", "vals", "fields", "weights"):
        w = np.asarray(getattr(want, name))
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w)
        np.testing.assert_array_equal(getattr(tensors, name).numpy(), w)


def test_modeled_bytes_same_formulas():
    rng = np.random.default_rng(3)
    ids = [bench.zipf_ids(rng, (256, 39), 1 << 22) for _ in range(4)]
    assert bt.modeled_step_bytes(ids, 9, 1) == bench.modeled_step_bytes(ids, 9, 1)
    for scale in (1, 4):
        assert bt.modeled_fused_step_bytes(ids, 9, 1 << 22, 1 << 20, scale) == \
            bench.modeled_fused_step_bytes(ids, 9, 1 << 22, 1 << 20, scale)
        assert bt.modeled_pallas_tail_step_bytes(ids, 9, 1 << 22, 1 << 20, scale) == \
            bench.modeled_pallas_tail_step_bytes(ids, 9, 1 << 22, 1 << 20, scale)


@pytest.mark.parametrize("all_ones", [False, True])
def test_ensure_scale_fmb_bytes(tmp_path, monkeypatch, all_ones):
    # bench.ensure_scale_fmb writes under a fixed /tmp directory: a seed of
    # this process's own gives a name that no concurrent run writes or unlinks.
    rows, seed, vocab = 301, 424242 + os.getpid(), 5000
    jax_path = bench.ensure_scale_fmb(vocab, rows=rows, seed=seed, all_ones=all_ones)
    try:
        with open(jax_path, "rb") as f:
            want = f.read()
        # The same name under /tmp: the port reads the JAX package's cache as it is.
        monkeypatch.setattr(bt.tempfile, "tempdir", os.path.dirname(os.path.dirname(jax_path)))
        mtime = os.stat(jax_path).st_mtime_ns
        assert bt.ensure_scale_fmb(vocab, rows=rows, seed=seed, all_ones=all_ones) == jax_path
        assert os.stat(jax_path).st_mtime_ns == mtime
        # Written afresh by the port elsewhere: the same bytes.
        monkeypatch.setattr(bt.tempfile, "tempdir", str(tmp_path))
        port_path = bt.ensure_scale_fmb(vocab, rows=rows, seed=seed, all_ones=all_ones)
        assert port_path.startswith(str(tmp_path))
        assert os.path.basename(port_path) == os.path.basename(jax_path)
        with open(port_path, "rb") as f:
            assert f.read() == want
    finally:
        os.unlink(jax_path)


def _shared_npz(tmp_path, accum_width):
    rng = np.random.default_rng(11)
    path = tmp_path / "shared.npz"
    np.savez(path, table=rng.uniform(-0.01, 0.01, (V, 1 + K)).astype(np.float32),
             accum=rng.uniform(0.1, 0.3, (V, accum_width)).astype(np.float32))
    return np.load(path)


def _batches(n, batch, start):
    rng = np.random.default_rng(start)
    ids = [bench.zipf_ids(rng, (batch, 39), V) for _ in range(n)]
    return ids


def _jax_state(table, accum, fused):
    st = jax_trainer.TrainState(table=jnp.asarray(table), table_opt=AdagradState(jnp.asarray(accum)),
                                dense={}, dense_opt=AdagradState({}),
                                step=jnp.zeros((), jnp.int32))
    return jax_trainer.pack_state(st, 0.1, fused=fused)


def _port_state(table, accum, fused):
    st = TrainState(table=torch.from_numpy(np.array(table)), dense=[], step=0,
                    table_accum=torch.from_numpy(np.array(accum)))
    return pack_state(st, 0.1, fused=fused)


@pytest.mark.parametrize("leg", ["fused", "packed"])
def test_leg_against_jax_bench_step(tmp_path, monkeypatch, leg):
    """The scale rung's fused step and the headline's packed step, each
    bench's own ``measure`` over the same batches from one npz state."""
    monkeypatch.setattr(bench, "BATCH", B)
    monkeypatch.setattr(bt, "BATCH", B)
    fused = leg == "fused"
    npz = _shared_npz(tmp_path, 1 if fused else 1 + K)
    ids = _batches(4, B, 7)
    jmodel = JaxFM(vocabulary_size=V, factor_num=K, order=2)
    model = FMModel(vocabulary_size=V, factor_num=K, order=2)
    if fused:
        jstep = jax_trainer.make_packed_train_step(jmodel, learning_rate=0.01, update="auto",
                                                   compact_cap=bench.SCALE_CAP)
        step = make_packed_train_step(model, 0.01, compact_cap=bt.SCALE_CAP)
    else:
        jstep = jax_trainer.make_packed_train_step(jmodel, 0.01)
        step = make_packed_train_step(model, 0.01)
    jstate, _ = bench.measure(jstep, _jax_state(npz["table"], npz["accum"], fused),
                              [bench.make_batch(x, i) for i, x in enumerate(ids)], iters=2,
                              windows=1)
    state, _ = bt.measure(step, _port_state(npz["table"], npz["accum"], fused),
                          [bt.make_batch(x, i, CPU) for i, x in enumerate(ids)], iters=2,
                          windows=1)
    assert state.step == 6 and int(jstate.step) == 6
    if fused:
        jt, ja = jpt.unpack_fused(jstate.table, V, 1 + K)
        t, a = pt.unpack_fused(state.table, V, 1 + K)
    else:
        jt = jpt.unpack_table(jstate.table, V, 1 + K)
        ja = jpt.unpack_accum_any(jstate.table_opt.accum, V, 1 + K)
        t, a = pt.unpack_table(state.table, V, 1 + K), pt.unpack_accum_any(state.table_accum,
                                                                           V, 1 + K)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    assert not np.array_equal(t.numpy(), npz["table"])  # the steps moved it


def _small(monkeypatch, tmp_path):
    """The line at small sizes, through the module's own constants."""
    for name, value in (("SCALE_VOCABS", (1 << 12, 1 << 10)), ("BATCH", 64),
                        ("SCALE_BATCH_BIG", 256), ("HEADLINE_VOCAB", 1 << 12),
                        ("CKPT_VOCAB", 1 << 12), ("TOY_VOCAB", 1 << 12), ("FMB_ROWS", 1024),
                        ("HERE", str(tmp_path))):
        monkeypatch.setattr(bt, name, value)
    monkeypatch.setattr(bt.tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("BENCH_RUNG", raising=False)
    monkeypatch.delenv("BENCH_TAIL_MODES", raising=False)


def test_line_keys_contain_the_jax_lines(tmp_path, monkeypatch, capsys):
    _small(monkeypatch, tmp_path)
    assert bt.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(REPO, "BENCH_r18.json")) as f:
        jax_line = json.load(f)
    assert set(jax_line) - set(line) == set()
    assert set(jax_line["tail_ab"]) <= set(line["tail_ab"])
    jax_mode = next(iter(jax_line["tail_ab"]["modes"].values()))
    assert set(jax_mode) - {"skipped"} <= set(line["tail_ab"]["modes"]["cuda"])
    assert line["device"] == "cpu" and line["card"] is None
    assert line["scale_vocab_rows"] == 1 << 12 and line["scale_fallbacks"] == []
    assert line["value"] == line["packed_b65536_value"] > 0
    assert line["nominal_hbm_gbps"] is None and line["scale_implied_over_nominal"] is None
    assert set(line["steps_per_call_values"]) == {"1", "8"}
    assert set(line["ckpt_stall_ms_per_save"]) == {"sync", "async", "delta"}
    assert set(line["kernel_launches"]) == {"anova_fwd", "anova_bwd", "rows_tail_adagrad",
                                            "fused_tail_adagrad", "fm2_fwd", "fm2_bwd"}
    # tools/report.py: the line as a bench artifact, its tail section, and
    # the delta report against the newest committed BENCH_TORCH_r*.json.
    art = tmp_path / "BENCH_TORCH_r99.json"
    art.write_text(json.dumps(line))
    loaded = report.load_bench_train(str(art))
    assert "Sparse-tail A/B" in report.render_bench_tail(loaded)
    rp = report.write_bench_report(line, str(tmp_path), prefix="BENCH_TORCH_r")
    assert rp.endswith("REPORT_r100.md") and "scale_value" in open(rp).read()


def _one_step_measures(monkeypatch):
    """Every leg's timing helper runs its step once: a test of the line's
    control flow, not of its rates, pays for no timing windows."""

    def measure(step, state, batches, iters, windows=3, batch_size=None):
        state, _ = step(state, batches[0])
        return state, 1.0

    def interleaved_measure(step, state, batches_a, batches_b, iters, rounds=4, batch=None):
        state, _ = step(state, batches_a[0])
        state, _ = step(state, batches_b[0])
        return (1.0, 1.0), state

    monkeypatch.setattr(bt, "measure", measure)
    monkeypatch.setattr(bt, "interleaved_measure", interleaved_measure)


def test_failed_section_exits_nonzero(tmp_path, monkeypatch, capsys):
    _small(monkeypatch, tmp_path)
    _one_step_measures(monkeypatch)

    def broken(device, rng):
        raise OSError("disk full")

    monkeypatch.setattr(bt, "bench_ckpt", broken)
    assert bt.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert "disk full" in line["ckpt_ab_error"]
    assert line["value"] is not None  # the line is printed before the exit
    assert "ckpt_ab_error" in captured.err


def test_refusals(tmp_path, monkeypatch):
    _small(monkeypatch, tmp_path)
    monkeypatch.setenv("BENCH_TAIL_MODES", "xla,pallas")
    with pytest.raises(ValueError, match="one sparse tail"):
        bt.bench_main(CPU)
    calls = []
    monkeypatch.setattr("subprocess.call", lambda cmd: calls.append(cmd) or 7)
    assert bt.main(["--tier", "--vocab", "64"]) == 7  # the probe's exit code
    assert calls == [[sys.executable, os.path.join(REPO, "tools", "torch_probe_tier.py"),
                      "--vocab", "64"]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bt.main([])


def test_dist_two_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setattr(bt, "DIST_VOCAB", 1 << 10)
    monkeypatch.setattr(bt, "DIST_ROWS", 512)
    monkeypatch.setattr(bt, "DIST_BATCH", 64)
    monkeypatch.setattr(bt.tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "dist.json"
    r = bt.bench_dist(2, CPU, str(out))
    assert "dist_error" not in r, r.get("dist_error")
    assert r["processes"] == 2 and r["value"] > 0
    assert set(r["per_host"]) == {"0", "1"}
    assert r["steady_recompiles_total"] == 0
    assert json.loads(out.read_text())["value"] == r["value"]


@pytest.mark.parametrize("path", ["bench_torch.py", "bench_all_torch.py",
                                  os.path.join("tools", "torch_loadgen.py")])
def test_driver_imports_neither_jax_nor_the_jax_package(path):
    """Each driver, imported as a module in a fresh interpreter (with the
    port modules it loads at run time), leaves no jax and no fast_tffm_tpu
    module behind."""
    import subprocess

    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tools')!r}]\n"
        f"spec = importlib.util.spec_from_file_location('driver', {os.path.join(REPO, path)!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import fast_tffm_tpu_torch.serving.engine, fast_tffm_tpu_torch.checkpoint_async\n"
        "import fast_tffm_tpu_torch.data.device_cache, fast_tffm_tpu_torch.parallel\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'fast_tffm_tpu' or m.startswith('fast_tffm_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    assert "import jax" not in src and "from fast_tffm_tpu " not in src
    assert "from fast_tffm_tpu." not in src and "import fast_tffm_tpu\n" not in src
