"""Port: orbax checkpoint directories (``fast_tffm_tpu_torch/ocdbt.py`` and
``checkpoint.py``'s orbax layer) against the JAX package's orbax saves and
tensorstore's reading, on the CPU.  orbax and tensorstore are imported
here only; the port reads and writes the format with numpy and ctypes.

* JAX saves, the port restores, bitwise: FM with element and row
  accumulators, FFM and DeepFM (dense leaves by name), single-device saves
  and 2 x 2 mesh saves (several chunks per array, dense leaves split over
  the replicas), the sidecars; the logical arrays a JAX packed or fused
  ``train`` writes; the committed JAX fixture against its npz twin.
* The port saves, JAX's ``restore_checkpoint`` restores bitwise onto one
  device, onto a 2 x 2 mesh and through its host re-pad path; tensorstore
  reads every key and every array of the port's directory as the port does.
* The accumulator-mode check from metadata raises the JAX package's message.
* Corruption raises: a flipped byte in a manifest or a node, a deleted data
  file, a truncated chunk; zarr v3, a missing chunk with ``fill_value``
  null and a zstd frame without libzstd are refused, naming what they met.
* A row range reads only the chunks that overlap it; tensorstore's interior
  B-tree nodes read as tensorstore reads them.
* Config: ``delta_every_steps`` and ``[ParamStore]`` with orbax refused in
  the JAX words; ``async_save`` with orbax saves synchronously with the
  JAX note; a model_file that holds an orbax directory keeps orbax.
* ``train`` with ``checkpoint_format = orbax``: stopped by SIGTERM and
  resumed, bitwise the uninterrupted run (rows and fused layouts), equal to
  its npz twin; ``predict`` from the directory equals ``predict`` from the
  npz; the serving engine starts from and reloads an orbax directory.
* ``tools/torch_convert_checkpoint.py``: a JAX npz to an orbax directory
  through the port, restored by JAX bitwise, and back.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.models.deepfm import DeepFMModel as JaxDeepFM
from fast_tffm_tpu.models.ffm import FFMModel as JaxFFM
from fast_tffm_tpu.models.fm import FMModel as JaxFM
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch import ocdbt
from fast_tffm_tpu_torch.checkpoint import (
    checkpoint_signature,
    latest_step,
    read_input_cursor,
    restore_checkpoint,
    restore_rows,
    save_checkpoint,
)
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.prediction import predict
from fast_tffm_tpu_torch.serving import ServingEngine
from fast_tffm_tpu_torch.trainer import TrainState
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows
TEST = os.path.join(REPO, "data", "test.libsvm")
FIXTURE = os.path.join(REPO, "tests", "data", "jax_b5_rowmesh")
CPU = torch.device("cpu")
V, K, NNZ = 256, 8, 8


def quiet(*_):
    pass


# -- states ------------------------------------------------------------------

MODELS = {
    "fm": lambda: JaxFM(vocabulary_size=V, factor_num=K),
    "ffm": lambda: JaxFFM(vocabulary_size=V, num_fields=3, factor_num=3),
    "deepfm": lambda: JaxDeepFM(vocabulary_size=V, num_fields=4, factor_num=3,
                                hidden_dims=(40, 6)),
}


def _jax_state(model_name, acc="element", seed=0, step=11):
    """A JAX TrainState of ``model_name`` with every array drawn from a
    numpy seed (the dense leaves too)."""
    model = MODELS[model_name]()
    st = jax_init_state(model, jax.random.key(0), 0.1, acc)
    rng = np.random.default_rng(seed)

    def draw(x, lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, x.shape).astype(np.float32))

    return st._replace(
        table=draw(st.table, -0.3, 0.3),
        table_opt=st.table_opt._replace(accum=draw(st.table_opt.accum, 0.1, 2.0)),
        dense=jax.tree.map(lambda x: draw(x, -1, 1), st.dense),
        dense_opt=st.dense_opt._replace(
            accum=jax.tree.map(lambda x: draw(x, 0.1, 2.0), st.dense_opt.accum)),
        step=jnp.asarray(step, jnp.int32),
    )


def _on_mesh(state):
    """``state`` on a 2 x 2 (data, row) mesh: the table and accumulator
    row-sharded, the rest replicated."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "row"))
    rows = NamedSharding(mesh, PartitionSpec("row", None))
    out = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, PartitionSpec())), state)
    return out._replace(table=jax.device_put(state.table, rows),
                        table_opt=out.table_opt._replace(
                            accum=jax.device_put(state.table_opt.accum, rows)))


def _dense_names(jstate):
    return sorted(jstate.dense)


def _assert_port_equals_jax(p: TrainState, j, with_accum=True):
    names = _dense_names(j)
    assert p.step == int(j.step)
    assert np.array_equal(p.table.numpy(), np.asarray(j.table))
    assert len(p.dense) == len(names)
    for leaf, n in zip(p.dense, names):
        assert np.array_equal(leaf.numpy(), np.asarray(j.dense[n])), n
    if with_accum:
        assert np.array_equal(p.table_accum.numpy(), np.asarray(j.table_opt.accum))
        for leaf, n in zip(p.dense_accum, names):
            assert np.array_equal(leaf.numpy(), np.asarray(j.dense_opt.accum[n])), n


def _port_state(jstate) -> TrainState:
    from fast_tffm_tpu_torch.weights import from_jax_arrays

    names = _dense_names(jstate)
    return from_jax_arrays(np.asarray(jstate.table), [np.asarray(jstate.dense[n]) for n in names],
                           np.asarray(jstate.step), CPU,
                           table_accum=np.asarray(jstate.table_opt.accum),
                           dense_accum=[np.asarray(jstate.dense_opt.accum[n]) for n in names])


# -- JAX saves, the port restores ----------------------------------------------

JAX_CASES = {
    "fm-element": ("fm", "element", False),
    "fm-row": ("fm", "row", False),
    "fm-element-mesh": ("fm", "element", True),
    "ffm": ("ffm", "element", False),
    "deepfm": ("deepfm", "element", False),
    "deepfm-mesh": ("deepfm", "element", True),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jax_saves_the_port_restores_bitwise(tmp_path, case):
    model_name, acc, mesh = JAX_CASES[case]
    j = _jax_state(model_name, acc)
    path = str(tmp_path / "j.orbax")
    cursor = {"epoch": 1, "batch_in_epoch": 4, "files": "x"}
    jax_save(path, _on_mesh(j) if mesh else j, "orbax", cursor=cursor)
    width = j.table.shape[1] if acc == "element" else 1
    p = restore_checkpoint(path, CPU, n_dense=len(j.dense), accum_width=width)
    _assert_port_equals_jax(p, j)
    scoring = restore_checkpoint(path, CPU, n_dense=len(j.dense))
    _assert_port_equals_jax(scoring, j, with_accum=False)
    assert scoring.table_accum is None
    assert read_input_cursor(path) == cursor and latest_step(path) == 11
    if mesh:  # several chunks per array: the table's row shards, the dense leaves' slices
        keys = ocdbt.OcdbtStore(path).keys()
        assert len([k for k in keys if k.startswith("table/") and k != "table/.zarray"]) > 1


def test_the_jax_fixture_restores_bitwise_its_npz_twin():
    """tests/data/jax_b5_rowmesh.orbax (tools/make_orbax_fixture.py: the
    JAX package on a 2-way row mesh) against the npz it wrote beside it."""
    a = restore_checkpoint(FIXTURE + ".orbax", CPU, accum_width=9)
    b = restore_checkpoint(FIXTURE + ".npz", CPU, accum_width=9)
    assert torch.equal(a.table, b.table) and torch.equal(a.table_accum, b.table_accum)
    assert a.step == b.step == 37 and a.table.shape == (4096, 9)
    assert read_input_cursor(FIXTURE + ".orbax") == read_input_cursor(FIXTURE + ".npz")
    store = ocdbt.OcdbtStore(FIXTURE + ".orbax")
    assert {"table/0.0", "table/1.0"} <= set(store.keys())
    like = jax_init_state(JaxFM(vocabulary_size=4096, factor_num=8, order=3), jax.random.key(0))
    assert np.array_equal(np.asarray(jax_restore(FIXTURE + ".orbax", like).table), a.table.numpy())


@pytest.mark.parametrize("layout", ["packed-element", "packed-fused"])
def test_a_jax_packed_train_writes_logical_arrays_the_port_restores(tmp_path, layout):
    acc = layout.split("-")[1]
    kw = dict(model="fm", factor_num=K, vocabulary_size=V, max_nnz=NNZ, batch_size=50,
              train_files=(TRAIN,), epoch_num=1, learning_rate=0.05, log_every=4,
              table_layout="packed", adagrad_accumulator=acc, checkpoint_format="orbax",
              model_file=str(tmp_path / "jp.orbax"), telemetry_profile_costs=False)
    jcfg = JaxConfig(**kw).validate()
    jax_train(jcfg, log=quiet)
    like = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1,
                          "row" if acc == "fused" else acc)
    j = jax_restore(jcfg.model_file, like)
    p = restore_checkpoint(jcfg.model_file, CPU, accum_width=K + 1 if acc == "element" else 1)
    _assert_port_equals_jax(p, j)
    assert p.step == 8


# -- the port saves, JAX restores -----------------------------------------------


@pytest.mark.parametrize("case", ["fm-element", "fm-row", "ffm", "deepfm"])
def test_the_port_saves_jax_restores_bitwise(tmp_path, case):
    model_name, acc, _ = JAX_CASES[case]
    j = _jax_state(model_name, acc, seed=3, step=29)
    path = str(tmp_path / "p.orbax")
    cursor = {"epoch": 0, "batch_in_epoch": 9}
    save_checkpoint(path, _port_state(j), dense_names=_dense_names(j), cursor=cursor)
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "array_metadatas",
                                        "d", "manifest.ocdbt", "ocdbt.process_0"]
    from fast_tffm_tpu.checkpoint import latest_step as jax_latest_step
    from fast_tffm_tpu.checkpoint import read_input_cursor as jax_read_cursor

    like = jax_init_state(MODELS[model_name](), jax.random.key(5), 0.1, acc)
    got = jax_restore(path, like)  # onto one device
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(j)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    got = jax_restore(path, _on_mesh(like))  # onto a 2 x 2 mesh
    assert got.table.sharding.spec == PartitionSpec("row", None)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(j)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert jax_read_cursor(path) == cursor and jax_latest_step(path) == 29
    # tensorstore reads every key and every array as the port does.
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}).result()
    store = ocdbt.OcdbtStore(path)
    keys = [k.decode() for k in kv.list().result()]
    assert keys == store.keys()
    for k in keys:
        assert kv.read(k).result().value == store.read(k), k
        if k.endswith("/.zarray"):
            name = k[: -len("/.zarray")]
            spec = {"driver": "zarr",
                    "kvstore": {"driver": "ocdbt", "base": "file://" + path, "path": name + "/"}}
            want = ts.open(spec).result().read().result()
            assert np.array_equal(ocdbt.ZarrArray(store, name).read(), want), name
            meta = json.loads(store.read(k))
            assert meta["compressor"] is None


def test_the_jax_host_path_repads_a_port_save(tmp_path):
    """A port save whose vocabulary differs from JAX's ``like``: the JAX
    host path (``_load_orbax_host``, metadata() then restore) re-pads it."""
    j = _jax_state("fm", seed=4)
    path = str(tmp_path / "p.orbax")
    save_checkpoint(path, _port_state(j))
    like = jax_init_state(JaxFM(vocabulary_size=V + 40, factor_num=K), jax.random.key(1))
    got = jax_restore(path, like)
    assert np.array_equal(np.asarray(got.table)[:V], np.asarray(j.table))
    assert np.array_equal(np.asarray(got.table)[V:], np.asarray(like.table)[V:])


def test_the_mode_check_from_metadata_is_jaxs(tmp_path):
    j = _jax_state("fm", "row")
    path = str(tmp_path / "m.orbax")
    jax_save(path, j, "orbax")
    with pytest.raises(ValueError) as want:
        jax_restore(path, jax_init_state(JaxFM(vocabulary_size=V, factor_num=K),
                                         jax.random.key(0), 0.1, "element"))
    with pytest.raises(ValueError) as got:
        restore_checkpoint(path, CPU, accum_width=K + 1)
    assert str(got.value) == str(want.value)
    assert "adagrad_accumulator = row" in str(got.value)


# -- corruption ----------------------------------------------------------------


def _flip(path, offset=20):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def _data_files(path):
    out = []
    for root, _, files in os.walk(path):
        out += [os.path.join(root, f) for f in files if os.sep + "d" + os.sep in
                os.path.join(root, f)]
    return sorted(out)


CORRUPTIONS = ["manifest", "node", "deleted_data_file", "truncated_chunk"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_corruption_raises(tmp_path, kind, writer):
    j = _jax_state("fm", seed=2)
    path = str(tmp_path / "c.orbax")
    if writer == "jax":
        jax_save(path, j, "orbax")
    else:
        save_checkpoint(path, _port_state(j))
    store = ocdbt.OcdbtStore(path)
    loc = store.locations()["table/0.0"]
    chunk_file = os.path.join(path, loc[1][0] + loc[1][1])
    if kind == "manifest":
        _flip(os.path.join(path, "manifest.ocdbt"))
        match = "checksum|magic|corrupt"
    elif kind == "node":
        root_nodes = [f for f in os.listdir(os.path.join(path, "d"))]
        _flip(os.path.join(path, "d", root_nodes[0]), 30)
        match = "checksum|corrupt"
    elif kind == "deleted_data_file":
        os.remove(chunk_file)
        match = "missing"
    else:
        with open(chunk_file, "r+b") as f:
            f.truncate(loc[2] + loc[3] // 2)
        match = "truncated|expected|ends|corrupt"
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(path, CPU, accum_width=K + 1)


def test_zarr_v3_missing_chunks_and_no_libzstd_are_refused(tmp_path, monkeypatch):
    root = str(tmp_path / "db")
    w = ocdbt.OcdbtWriter(root)
    w.put("v3/zarr.json", b"{}")
    w.put("a/.zarray", ocdbt.zarray_bytes((8, 2), (4, 2), np.float32))
    w.put("a/0.0", np.zeros((4, 2), np.float32).tobytes())  # a/1.0 missing
    w.commit()
    store = ocdbt.OcdbtStore(root)
    with pytest.raises(ValueError, match="zarr v3"):
        ocdbt.ZarrArray(store, "v3")
    a = ocdbt.ZarrArray(store, "a")
    assert a.read(rows=(0, 4)).shape == (4, 2)
    with pytest.raises(ValueError, match="missing.*fill_value is None"):
        a.read()
    # A JAX directory's nodes are zstd frames: without libzstd its read
    # raises, naming the library; the port's own saves need none.
    path = str(tmp_path / "j.orbax")
    jax_save(path, _jax_state("fm"), "orbax")
    monkeypatch.setattr(ocdbt, "_ZSTD", [])
    monkeypatch.setattr(ocdbt.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(ValueError, match="libzstd"):
        restore_checkpoint(path, CPU)
    mine = str(tmp_path / "p.orbax")
    save_checkpoint(mine, _port_state(_jax_state("fm")))
    assert restore_checkpoint(mine, CPU).table.shape == (V, K + 1)


def test_interior_nodes_read_as_tensorstore_reads_them(tmp_path):
    """A tensorstore database of 300 keys in nodes of at most 400 bytes: a
    B-tree of height > 0, its keys prefix-compressed under subtree
    prefixes, some values indirect."""
    root = str(tmp_path / "tree")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root,
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(0)
    want = {f"arr{i % 7}/{i:05d}": rng.bytes(int(rng.integers(1, 40))) for i in range(300)}
    with ts.Transaction() as txn:
        for k, v in want.items():
            kv.with_transaction(txn)[k] = v
    store = ocdbt.OcdbtStore(root)
    assert store.keys() == sorted(want)
    assert all(store.read(k) == v for k, v in want.items())


def test_a_row_range_reads_only_its_chunks(tmp_path):
    j = _jax_state("fm", seed=6)
    path = str(tmp_path / "m.orbax")
    jax_save(path, _on_mesh(j), "orbax")  # table chunks of 64 rows
    stats = {}
    p = restore_rows(path, CPU, 70, 120, accum_width=K + 1, stats=stats)
    assert np.array_equal(p.table.numpy(), np.asarray(j.table)[70:120])
    assert np.array_equal(p.table_accum.numpy(), np.asarray(j.table_opt.accum)[70:120])
    table_chunks = sorted(k for k in stats["chunks_read"] if k.startswith("table/"))
    assert table_chunks == ["table/1.0"]


# -- config ------------------------------------------------------------------


@pytest.mark.parametrize("kw,needle", [
    (dict(delta_every_steps=4), "requires checkpoint_format = npz"),
    (dict(paramstore=True), r"\[ParamStore\] requires checkpoint_format = npz"),
])
def test_orbax_refusals_are_jaxs(kw, needle):
    kw = dict(checkpoint_format="orbax", train_files=("x.libsvm",), **kw)
    errors = []
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match=needle) as e:
            cls(**kw).validate()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    Config(checkpoint_format="orbax").validate()


def _kw(tmp_path, name, **over):
    base = dict(model="fm", factor_num=K, vocabulary_size=V, max_nnz=NNZ, batch_size=40,
                train_files=(TRAIN,), validation_files=(TEST,), predict_files=(TEST,),
                epoch_num=2, learning_rate=0.05, log_every=5, checkpoint_format="orbax",
                model_file=str(tmp_path / f"{name}.orbax"),
                score_path=str(tmp_path / f"{name}.scores"),
                metrics_path=str(tmp_path / f"{name}.jsonl"), telemetry_profile_costs=False)
    base.update(over)
    return base


def _stop_at(n):
    def hook(step, fired=[]):  # noqa: B006 — one list per hook
        if step >= n and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)
    return hook


def _ckpt_records(path):
    return [r for r in map(json.loads, open(path)) if r["kind"] == "ckpt"]


def test_a_model_file_dir_keeps_orbax_and_async_stays_sync(tmp_path):
    """model_file already an orbax directory under checkpoint_format = npz:
    the run keeps orbax (the JAX note) and refuses delta saves in the JAX
    words; async_save with orbax saves synchronously, with the JAX note."""
    kw = _kw(tmp_path, "a", async_save=True, save_every_epochs=1)
    logs = []
    train(Config(**kw).validate(), device="cpu", log=logs.append)
    assert "note: async_save applies to npz checkpoints — orbax saves stay synchronous" in logs
    assert {r["mode"] for r in _ckpt_records(kw["metrics_path"])} == {"sync"}
    assert os.path.isdir(kw["model_file"]) and latest_step(kw["model_file"]) == 20
    npz_kw = dict(kw, checkpoint_format="npz", async_save=False, epoch_num=1)
    logs = []
    train(Config(**npz_kw).validate(), device="cpu", log=logs.append)
    assert f"note: {kw['model_file']} is an orbax checkpoint dir — keeping orbax format" in logs
    assert os.path.isdir(kw["model_file"]) and latest_step(kw["model_file"]) == 10
    with pytest.raises(ValueError, match="resolved checkpoint_format to orbax") as e:
        train(Config(**dict(npz_kw, delta_every_steps=3)).validate(), device="cpu", log=quiet)
    from fast_tffm_tpu.training import train as jtrain

    with pytest.raises(ValueError) as je:
        jtrain(JaxConfig(**dict(npz_kw, delta_every_steps=3)).validate(), log=quiet)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("layout", ["rows", "fused"])
def test_train_stops_and_resumes_bitwise_and_predicts_as_its_npz_twin(tmp_path, layout):
    over = {} if layout == "rows" else dict(table_layout="packed", adagrad_accumulator="fused")
    whole = _kw(tmp_path, "whole", **over)
    cut = _kw(tmp_path, "cut", **over)
    twin = _kw(tmp_path, "twin", checkpoint_format="npz", model_file=str(tmp_path / "twin.npz"),
               **over)
    train(Config(**whole).validate(), device="cpu", log=quiet)
    train(Config(**twin).validate(), device="cpu", log=quiet)
    train(Config(**cut).validate(), device="cpu", log=quiet, step_hook=_stop_at(7))
    assert latest_step(cut["model_file"]) == 7
    assert read_input_cursor(cut["model_file"])["batch_in_epoch"] == 7
    logs = []
    train(Config(**cut).validate(), resume=True, device="cpu", log=logs.append)
    assert any("resumed from" in line and "at step 7" in line for line in logs)
    width = 1 if layout == "fused" else K + 1
    a, b, c = (restore_checkpoint(kw["model_file"], CPU, accum_width=width)
               for kw in (whole, cut, twin))
    for x in (b, c):
        assert torch.equal(a.table, x.table) and torch.equal(a.table_accum, x.table_accum)
        assert a.step == x.step == 20
    for kw in (whole, twin):
        predict(Config(**kw).validate(), log=quiet, device="cpu")
    assert open(whole["score_path"]).read() == open(twin["score_path"]).read()


def test_serving_starts_from_and_reloads_an_orbax_directory(tmp_path):
    """The engine restores an orbax directory, notices a second save (its
    signature: the sidecar step and the renamed directory) and reloads it
    fully; the reloaded scores are bitwise a fresh engine's."""
    kw = _kw(tmp_path, "s", serve_buckets=(1, 4, 16), serve_flush_deadline_ms=2.0)
    cfg = Config(**kw).validate()
    save_checkpoint(cfg.model_file, _port_state(_jax_state("fm", seed=1, step=3)))
    rng = np.random.default_rng(5)
    probe = (rng.integers(0, V, (16, NNZ)).astype(np.int32),
             rng.uniform(0.05, 1.0, (16, NNZ)).astype(np.float32))

    def scores(eng):
        st, sc = eng.submit_block(*probe).result(timeout=30)
        assert not st.any()
        return np.asarray(sc)

    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        before = scores(eng)
        sig = checkpoint_signature(cfg.model_file)
        save_checkpoint(cfg.model_file, _port_state(_jax_state("fm", seed=2, step=9)))
        assert checkpoint_signature(cfg.model_file) != sig
        assert eng.reload_once()["status"] == "staged"
        scores(eng)  # the swap happens at a flush
        after = scores(eng)
        assert eng.step == 9
    with ServingEngine(cfg, log=quiet, device="cpu") as fresh:
        assert np.array_equal(after, scores(fresh))
    assert not np.array_equal(before, after)


# -- the converter ----------------------------------------------------------------


def test_the_converter_writes_an_orbax_dir_jax_restores(tmp_path):
    j = _jax_state("deepfm", seed=8, step=5)
    src = str(tmp_path / "j.npz")
    jax_save(src, j, "npz", cursor={"epoch": 2})
    ini = tmp_path / "c.cfg"
    ini.write_text("[General]\nmodel = deepfm\nfactor_num = 3\nnum_fields = 4\n"
                   f"vocabulary_size = {V}\nhidden_dims = 40,6\n")
    dst = str(tmp_path / "c.orbax")
    tool = os.path.join(REPO, "tools", "torch_convert_checkpoint.py")
    r = subprocess.run([sys.executable, tool, str(ini), src, dst, "--device", "cpu"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    like = jax_init_state(MODELS["deepfm"](), jax.random.key(3))
    got = jax_restore(dst, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(j)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    from fast_tffm_tpu.checkpoint import read_input_cursor as jax_read_cursor

    assert jax_read_cursor(dst) == {"epoch": 2}
    back = str(tmp_path / "back.npz")
    r = subprocess.run([sys.executable, tool, str(ini), dst, back, "--device", "cpu"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = jax_restore(back, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(j)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
