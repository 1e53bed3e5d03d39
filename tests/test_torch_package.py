"""Port: package boundaries, the device rule, the kernel build, configs, CLI.

* Importing fast_tffm_tpu_torch loads neither jax nor fast_tffm_tpu.
* Entry points default to cuda and raise without a CUDA device; a CUDA
  tensor goes to the kernel or raises, never to the plain version.
* Configs: the port reads every config of the repo as the JAX package does,
  or refuses it naming the later slice.
* ``python -m fast_tffm_tpu_torch.cli serve|train|predict`` and
  chip_smoke.py's refusals.
"""

import glob
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu_torch.config import Config, load_config
from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_bwd
from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update, rows_tail_apply
from fast_tffm_tpu_torch.prediction import predict
from fast_tffm_tpu_torch.serving import ServingEngine
from fast_tffm_tpu_torch.serving.engine import serve_lines
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.cfg"))) + [
    os.path.join(REPO, "sample.cfg")
]


def _run(args, **kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=120, env=env, **kw
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fast_tffm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(mods) >= 23, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'fast_tffm_tpu' or m.startswith('fast_tffm_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = _run(["-c", code], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 23


def test_engine_without_device_raises_on_a_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    cfg = Config(order=3, vocabulary_size=8, max_nnz=2, model_file=str(tmp_path / "m.ckpt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg.validate(), log=lambda *_: None)


class _CudaLike:
    """Stands in for a CUDA tensor on a box without one: everything the
    wrapper validates before it needs the kernel library."""

    device = torch.device("cuda")
    dtype = torch.float32
    shape = (4, 3, 8)

    def dim(self):
        return 3

    def is_contiguous(self):
        return True

    def data_ptr(self):
        raise AssertionError("the wrapper touched the data without a kernel")


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernel_build, "_libs", {})


def test_cuda_tensor_without_a_built_kernel_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    before = anova_inter.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        anova_inter(_CudaLike(), 3)
    assert anova_inter.launches == before


def test_train_without_device_raises_on_a_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    cfg = Config(order=3, vocabulary_size=8, max_nnz=2, train_files=(str(tmp_path / "t"),),
                 model_file=str(tmp_path / "m.ckpt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg.validate(), log=lambda *_: None)


class _CudaTensor(_CudaLike):
    """A stand-in CUDA tensor of a given shape and dtype."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def dim(self):
        return len(self.shape)


def test_backward_and_tail_on_a_cuda_tensor_without_a_built_kernel_raise(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    before = (anova_inter_bwd.launches, rows_tail_adagrad_update.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        anova_inter_bwd(_CudaTensor((4, 3, 8)), _CudaTensor((4,)), 3)
    table, accum = _CudaTensor((16, 9)), _CudaTensor((16, 9))
    with pytest.raises(RuntimeError, match="nvcc"):
        rows_tail_apply(table, accum, _CudaTensor((5,), torch.int32), _CudaTensor((5, 9)), 0.1)
    assert (anova_inter_bwd.launches, rows_tail_adagrad_update.launches) == before


@pytest.mark.parametrize("body", ["default", "decayed", "pallas"])
def test_every_step_body_takes_its_tail_through_the_kernel_wrapper(monkeypatch, body):
    """Each train step body updates the table through
    ``ops.tail.rows_tail_adagrad_update`` (the kernel on a CUDA state, its
    twin on a CPU one), once per step: no body calls the plain tail."""
    from fast_tffm_tpu_torch import trainer
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.models.fm import FMModel

    calls, real = [], trainer.rows_tail_adagrad_update

    def spy(*a, **kw):
        calls.append(kw["decay"])
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "rows_tail_adagrad_update", spy)
    model = FMModel(vocabulary_size=64, factor_num=4, order=3)
    state = trainer.init_state(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = Batch(
        labels=torch.tensor([0.0, 1.0, 1.0, 0.0]),
        ids=torch.from_numpy(rng.integers(0, 64, size=(4, 5)).astype(np.int32)),
        vals=torch.from_numpy(rng.uniform(0.1, 1.0, size=(4, 5)).astype(np.float32)),
        fields=torch.zeros((4, 0), dtype=torch.int32),
        weights=torch.ones(4),
    )
    bodies = {"default": None, "decayed": trainer.make_decayed_body(0.9),
              "pallas": trainer.make_pallas_tail_body()}
    step = trainer.make_train_step(model, 0.05, body=bodies[body])
    for _ in range(2):
        state, _ = step(state, batch)
    assert calls == [0.9 if body == "decayed" else 1.0] * 2 and state.step == 2


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_build.load("anova_fwd")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_build.build(["anova_fwd"])


def test_kernel_build_reports_a_failed_compile(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        kernel_build.build(["anova_fwd"])
    assert not os.listdir(tmp_path / "_build")  # nothing half-built is left to load


def test_every_kernel_source_exists():
    for name in ("anova_fwd", "anova_bwd", "rows_tail_adagrad", "fused_tail_adagrad"):
        assert os.path.isfile(os.path.join(kernel_build.CSRC_DIR, f"{name}.cu")), name
    assert "arch=compute_90a,code=sm_90a" in kernel_build.NVCC_FLAGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reads_every_repo_config_like_jax_or_refuses_it(path):
    want = jax_load_config(path)
    servable = want.model == "fm" and want.checkpoint_format == "npz"
    if not servable:
        with pytest.raises(ValueError, match="later slice"):
            load_config(path)
        return
    got = load_config(path)
    for f in Config.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize(
    "kw,needle",
    [
        (dict(model="ffm"), "later slice"),
        (dict(model="deepfm"), "later slice"),
        (dict(model="xyz"), "unknown model"),
        (dict(table_layout="packed", adagrad_accumulator="fused", online_adagrad_decay=0.9),
         "requires table_layout = rows"),
        (dict(checkpoint_format="orbax"), "later slice"),
        (dict(order=1), "order"),
        (dict(serve_buckets=()), "serve_buckets"),
        (dict(serve_max_batch=600), "largest bucket"),
        (dict(serve_overload="drop"), "serve_overload"),
        (dict(serve_classes="gold:x"), "serve_classes"),
        (dict(wire_format="x"), "wire_format"),
        (dict(adagrad_accumulator="fused"), "requires table_layout = packed"),
        (dict(adagrad_accumulator="xyz"), "adagrad_accumulator"),
        (dict(tail="xyz"), "tail"),
        (dict(online_adagrad_decay=0.0), "adagrad_decay"),
        (dict(init_accumulator_value=0.0), "init_accumulator_value"),
        (dict(on_nan="retry"), "on_nan"),
        (dict(batch_size=0), "batch_size"),
        # The JAX package's layout checks.
        (dict(packed_compact_cap=8), "requires adagrad_accumulator = fused"),
        (dict(packed_update="dense"), "requires table_layout = packed"),
        (dict(table_layout="packed", adagrad_accumulator="fused", packed_update="sorted"),
         "packed_update = auto, dense or compact"),
        (dict(table_layout="packed", tail="pallas"), "requires adagrad_accumulator = fused"),
        (dict(table_layout="packed", adagrad_accumulator="fused",
              online_accum_restart_steps=10), "no separate accumulator"),
    ],
)
def test_config_refusals(kw, needle):
    with pytest.raises(ValueError, match=needle):
        Config(**kw).validate()


TRAIN_ONLY = [
    dict(shuffle=True),
    dict(binary_cache=True),
    dict(device_cache=True),
    dict(steps_per_call=4),
    dict(dedup_gather_rows=1024),
    dict(paramstore=True),
    dict(online_follow=True),
    dict(online_accum_restart_steps=100),
    dict(on_nan="rollback"),
    dict(async_save=True),
    dict(delta_every_steps=10),
    dict(metrics_path="m.jsonl"),
    dict(trace_dir="trace"),
    dict(telemetry_profile_steps="2:4"),
    dict(table_layout="packed"),  # the element accumulator: an XLA packed tail
    dict(table_layout="packed", adagrad_accumulator="row"),
]


@pytest.mark.parametrize("kw", TRAIN_ONLY, ids=lambda kw: next(iter(kw)))
def test_train_refuses_later_slice_settings(kw, tmp_path):
    cfg = Config(order=3, vocabulary_size=8, max_nnz=2, train_files=(str(tmp_path / "t"),),
                 model_file=str(tmp_path / "m.ckpt"), **kw).validate()
    with pytest.raises(ValueError, match="later slice"):
        train(cfg, device="cpu", log=lambda *_: None)
    assert not os.listdir(tmp_path)  # refused before any read or write


@pytest.mark.parametrize("kw", [dict(binary_cache=True), dict(metrics_path="m.jsonl")],
                         ids=lambda kw: next(iter(kw)))
def test_predict_refuses_later_slice_settings(kw, tmp_path):
    cfg = Config(order=3, vocabulary_size=8, max_nnz=2, predict_files=(str(tmp_path / "p"),),
                 model_file=str(tmp_path / "m.ckpt"), **kw).validate()
    with pytest.raises(ValueError, match="later slice"):
        predict(cfg, device="cpu", log=lambda *_: None)


def test_serve_takes_a_config_with_training_only_settings(tmp_path):
    """Serving reads none of the training settings a later slice owns, so
    a config written for training (shuffle, telemetry, step fusion, the
    packed layout with an element accumulator) serves."""
    rng = np.random.default_rng(1)
    model = tmp_path / "m.ckpt"
    with open(model, "wb") as f:
        np.savez(f, table=rng.uniform(-0.3, 0.3, size=(32, 5)).astype(np.float32),
                 step=np.int64(1))
    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        f"[General]\norder = 3\nfactor_num = 4\nvocabulary_size = 32\nmodel_file = {model}\n"
        "table_layout = packed\n"
        "[Train]\nmax_nnz = 4\nshuffle = true\nbinary_cache = true\nsteps_per_call = 4\n"
        "metrics_path = m.jsonl\n[Checkpoint]\nasync_save = true\n"
    )
    loaded = load_config(str(cfg))
    assert loaded.shuffle and loaded.steps_per_call == 4 and loaded.table_layout == "packed"
    out = io.StringIO()
    serve_lines(loaded, ["1 1:0.5 2:1.0\n", "0 7:1\n"], out, log=lambda *_: None, device="cpu")
    scores = [float(x) for x in out.getvalue().split()]
    assert len(scores) == 2 and all(0.0 < x < 1.0 for x in scores)


def test_cli_serves_stdin_in_pipe_mode(tmp_path):
    rng = np.random.default_rng(0)
    table = rng.uniform(-0.3, 0.3, size=(32, 5)).astype(np.float32)
    model = tmp_path / "m.ckpt"
    with open(model, "wb") as f:
        np.savez(f, table=table, step=np.int64(2))
    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        f"[General]\norder = 3\nfactor_num = 4\nvocabulary_size = 32\nmodel_file = {model}\n"
        "[Train]\nmax_nnz = 4\n"
    )
    lines = "1 1:0.5 2:1.0 3:0.25\n0 7:1\n\n1 31:0.5 0:0.5\n"
    r = _run(["-m", "fast_tffm_tpu_torch.cli", "serve", str(cfg), "--device", "cpu"],
             cwd=REPO, input=lines)
    assert r.returncode == 0, r.stderr
    scores = [float(s) for s in r.stdout.split()]
    assert len(scores) == 3 and all(0.0 < s < 1.0 for s in scores)
    assert "served 3 scores" in r.stderr
    # The default device is cuda; without one the verb fails instead of
    # quietly serving on the CPU.
    if not torch.cuda.is_available():
        r = _run(["-m", "fast_tffm_tpu_torch.cli", "serve", str(cfg)], cwd=REPO, input=lines)
        assert r.returncode != 0 and not r.stdout
        assert "device='cpu'" in r.stderr


def test_cli_trains_and_predicts_on_the_cpu(tmp_path):
    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        f"[General]\norder = 3\nfactor_num = 4\nvocabulary_size = 256\n"
        f"model_file = {tmp_path / 'm.ckpt'}\n"
        f"[Train]\ntrain_files = {os.path.join(REPO, 'data', 'train.libsvm')}\n"
        "batch_size = 100\nlog_every = 2\n"
        f"[Predict]\npredict_files = {os.path.join(REPO, 'data', 'test.libsvm')}\n"
        f"score_path = {tmp_path / 's.txt'}\n"
    )
    r = _run(["-m", "fast_tffm_tpu_torch.cli", "train", str(cfg), "--device", "cpu"], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "step 2 epoch 0 loss" in r.stderr and "training done: steps 0->4" in r.stderr
    r = _run(["-m", "fast_tffm_tpu_torch.cli", "train", str(cfg), "--device", "cpu",
              "--resume"], cwd=REPO)
    assert r.returncode == 0 and "training done: steps 4->8" in r.stderr, r.stderr
    r = _run(["-m", "fast_tffm_tpu_torch.cli", "predict", str(cfg), "--device", "cpu"], cwd=REPO)
    assert r.returncode == 0, r.stderr
    scores = [float(s) for s in (tmp_path / "s.txt").read_text().split()]
    assert len(scores) == 120 and all(0.0 < s < 1.0 for s in scores)
    r = _run(["-m", "fast_tffm_tpu_torch.cli", "predict", str(cfg), "--resume"], cwd=REPO)
    assert r.returncode != 0 and "--resume" in r.stderr


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    r = _run([os.path.join(REPO, "chip_smoke.py")], cwd=REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _run([str(alone)], cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
