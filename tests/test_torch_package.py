"""Port: package boundaries, the device rule, the kernel build, configs, CLI.

* Importing fast_tffm_tpu_torch loads neither jax nor fast_tffm_tpu.
* Entry points default to cuda and raise without a CUDA device; a CUDA
  tensor goes to the kernel or raises, never to the plain version.
* Configs: the port reads every config of the repo as the JAX package does,
  or refuses it naming the later slice.
* ``python -m fast_tffm_tpu_torch.cli serve`` and chip_smoke.py's refusals.
"""

import glob
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
from fast_tffm_tpu_torch.ops.anova import anova_inter
from fast_tffm_tpu_torch.serving import ServingEngine

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
        "assert len(mods) >= 16, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'fast_tffm_tpu' or m.startswith('fast_tffm_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = _run(["-c", code], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 16


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
    assert os.path.isfile(os.path.join(kernel_build.CSRC_DIR, "anova_fwd.cu"))
    assert "arch=compute_90a,code=sm_90a" in kernel_build.NVCC_FLAGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reads_every_repo_config_like_jax_or_refuses_it(path):
    want = jax_load_config(path)
    servable = (
        want.model == "fm" and want.table_layout == "rows" and want.checkpoint_format == "npz"
    )
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
        (dict(table_layout="packed"), "later slice"),
        (dict(checkpoint_format="orbax"), "later slice"),
        (dict(order=1), "order"),
        (dict(serve_buckets=()), "serve_buckets"),
        (dict(serve_max_batch=600), "largest bucket"),
        (dict(serve_overload="drop"), "serve_overload"),
        (dict(serve_classes="gold:x"), "serve_classes"),
        (dict(wire_format="x"), "wire_format"),
    ],
)
def test_config_refusals(kw, needle):
    with pytest.raises(ValueError, match=needle):
        Config(**kw).validate()


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


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    r = _run([os.path.join(REPO, "chip_smoke.py")], cwd=REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _run([str(alone)], cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
