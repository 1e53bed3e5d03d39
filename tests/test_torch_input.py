"""Port: the training input paths against the JAX package on the CPU.

Every file is written from a numpy seed into a temporary directory; both
packages read the same bytes.  Tolerance: none.  Parsing, FMB files,
shuffled streams and the device-resident epoch move values without
arithmetic, so every comparison here is bitwise (``np.array_equal``).

* the native parser (``csrc/libsvm_parser.cpp``, the port's copy) against
  the JAX ``NativeParser`` and the port's ``parse_lines``: plain and hashed
  ids, and the same error for a malformed or blank line;
* ``native_batch_stream`` against the Python stream and the JAX native
  stream over several files, with per-file weights, a padded tail,
  ``drop_remainder`` and ``pad_to_batches``;
* FMB files written by the JAX ``write_fmb`` read by the port and the
  reverse (byte-identical files), plain and shuffled streams row for row;
* ``ensure_fmb_cache``: reuse, invalidation and the unwritable fallback;
* ``scan_max_nnz``, ``count_lines``, ``Batch.stack_parsed`` and the device
  cache's arrays and epoch permutation.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.data import binary as jax_binary
from fast_tffm_tpu.data import device_cache as jax_device_cache
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.native import load_native_parser as jax_load_native_parser
from fast_tffm_tpu.data.native import native_batch_stream as jax_native_batch_stream
from fast_tffm_tpu.models.base import Batch as JaxBatch
from fast_tffm_tpu.training import scan_max_nnz as jax_scan_max_nnz
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data import binary, device_cache
from fast_tffm_tpu_torch.data.libsvm import parse_lines, scan_max_nnz
from fast_tffm_tpu_torch.data.native import (
    NativeParser,
    best_parser,
    count_lines,
    native_batch_stream,
    scan_files,
    usable_cores,
)
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models.base import Batch

V = 1000


def quiet(*_):
    pass


def _lines(rng, n, *, vocab=V, width=(1, 9), ffm=False, raw=False, blank_every=0):
    """libsvm (or libffm) lines of seeded ids, values and labels."""
    out = []
    for i in range(n):
        if blank_every and i % blank_every == blank_every - 1:
            out.append("   ")
        m = int(rng.integers(*width))
        ids = rng.integers(0, vocab, size=m)
        vals = np.round(rng.uniform(0.0, 2.0, size=m), int(rng.integers(1, 7)))
        toks = []
        for j, (f, v) in enumerate(zip(ids, vals)):
            feat = f"tok{f}x" if raw else str(f)
            toks.append(f"{j % 5}:{feat}:{v}" if ffm else f"{feat}:{v}")
        out.append(f"{int(rng.integers(-1, 2))} " + " ".join(toks))
    return out


def _write(tmp_path, name, lines):
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _equal(a, b):
    """Two (ParsedBatch, weights) pairs, or two ParsedBatches, bitwise."""
    if isinstance(a, tuple):
        _equal(a[0], b[0])
        assert np.array_equal(a[1], b[1])
        return
    for f in ("labels", "ids", "vals", "fields", "nnz"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        assert np.array_equal(x.astype(np.int64) if f == "ids" else x,
                              y.astype(np.int64) if f == "ids" else y), f


def _all_equal(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        _equal(a, b)


@pytest.fixture(scope="module")
def jax_native():
    parser = jax_load_native_parser(3)
    assert parser is not None, "the JAX package's parser did not build"
    return parser


@pytest.mark.parametrize("threads", [1, 3, 0])
@pytest.mark.parametrize("kind", ["plain", "hashed", "ffm"])
def test_native_parser_is_bitwise_jax_and_parse_lines(jax_native, kind, threads):
    rng = np.random.default_rng(11)
    hashed = kind == "hashed"
    lines = _lines(rng, 700, ffm=kind == "ffm", raw=hashed)
    parser = best_parser(threads)
    assert isinstance(parser, NativeParser)
    assert parser.threads == (threads or usable_cores())
    kw = dict(vocabulary_size=V, hash_feature_id_flag=hashed)
    for max_nnz in (None, 12):
        got = parser(lines, max_nnz=max_nnz, **kw)
        _equal(got, jax_native(lines, max_nnz=max_nnz, **kw))
        _equal(got, parse_lines(lines, max_nnz=max_nnz, **kw))
        assert got.ids.dtype == np.int64


@pytest.mark.parametrize(
    "bad",
    ["1 3:0.5 7:x", "1 3:0.5 99999:1", "x 3:0.5", "1 1:2:3:4", "1 " + " ".join(
        f"{i}:1" for i in range(20))],
    ids=["bad-token", "out-of-range", "bad-label", "four-parts", "too-wide"],
)
def test_native_parser_errors_like_jax(jax_native, bad):
    lines = ["1 1:0.5 2:0.25", "0 4:1", bad, "1 5:1"]
    with pytest.raises(ValueError) as want:
        jax_native(lines, vocabulary_size=V, max_nnz=12)
    with pytest.raises(ValueError) as got:
        best_parser(2)(lines, vocabulary_size=V, max_nnz=12)
    assert str(got.value) == str(want.value)
    assert "at line 2" in str(got.value)
    with pytest.raises(ValueError):
        parse_lines(lines, vocabulary_size=V, max_nnz=12)


def test_native_parser_takes_a_blank_line_as_jax_does(jax_native):
    """``parse_lines`` refuses a blank line; both native parsers take the
    same (streams never hand them one: they skip blank lines)."""
    lines = ["1 1:0.5 2:0.25", "0 4:1", "", "1 5:1"]
    kw = dict(vocabulary_size=V, max_nnz=4)
    _equal(best_parser(2)(lines, **kw), jax_native(lines, **kw))
    with pytest.raises(ValueError, match="empty line at index 2"):
        parse_lines(lines, **kw)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(weights=(1.0, 0.5, 2.0)), dict(epochs=2), dict(drop_remainder=True),
     dict(pad_to_batches=9), dict(pad_to_batches=3), dict(hashed=True)],
    ids=["plain", "weights", "epochs", "drop_remainder", "pad_to_9", "pad_to_3", "hashed"],
)
def test_native_stream_is_bitwise_the_python_and_jax_streams(tmp_path, jax_native, kw):
    rng = np.random.default_rng(5)
    hashed = kw.pop("hashed", False)
    files = [
        _write(tmp_path, f"f{i}.libsvm", _lines(rng, n, raw=hashed, blank_every=7))
        for i, n in enumerate((45, 31, 60))
    ]
    common = dict(batch_size=32, vocabulary_size=V, hash_feature_id=hashed, max_nnz=10, **kw)
    native = list(native_batch_stream(best_parser(2), files, **common))
    assert native[0][0].ids.dtype == np.int32
    _all_equal(native, batch_stream(files, **common))  # the Python line stream
    _all_equal(native, batch_stream(files, parser=best_parser(2), **common))
    _all_equal(native, jax_native_batch_stream(jax_native, files, **common))
    rows = 136 * (2 if kw.get("epochs") == 2 else 1)
    n_batches = kw.get("pad_to_batches") or (rows // 32 if kw.get("drop_remainder") else -(-rows // 32))
    assert len(native) == n_batches


def test_native_stream_reports_the_bad_row_and_a_missing_file(tmp_path):
    path = _write(tmp_path, "bad.libsvm", ["1 1:1"] * 5 + ["1 2:zz"])
    with pytest.raises(ValueError, match=r"bad token in .*bad.libsvm \(batch row 1\)"):
        list(native_batch_stream(best_parser(1), [path], batch_size=4, vocabulary_size=V,
                                 max_nnz=4))
    with pytest.raises(FileNotFoundError):
        list(native_batch_stream(best_parser(1), [str(tmp_path / "nope")], batch_size=4,
                                 vocabulary_size=V, max_nnz=4))


@pytest.mark.parametrize("hashed", [False, True])
def test_fmb_files_cross_read_and_are_byte_identical(tmp_path, hashed):
    rng = np.random.default_rng(9)
    src = _write(tmp_path, "src.libsvm", _lines(rng, 300, raw=hashed, ffm=not hashed, blank_every=11))
    kw = dict(vocabulary_size=V, hash_feature_id=hashed)
    jax_path = jax_binary.write_fmb(src, str(tmp_path / "jax.fmb"), chunk=64, **kw)
    port_path = binary.write_fmb(src, str(tmp_path / "port.fmb"), chunk=64, **kw)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    assert binary.is_fmb(jax_path) and jax_binary.is_fmb(port_path)
    h = binary.read_header(jax_path)
    assert h.n_rows == 300 and h.version == binary.FMB_VERSION and h.hashed == hashed
    common = dict(batch_size=64, max_nnz=9, **kw)
    text = list(batch_stream([src], **common))
    _all_equal(binary.fmb_batch_stream([jax_path], **common), text)
    _all_equal(jax_binary.fmb_batch_stream([port_path], **common), text)
    _all_equal(batch_stream([port_path], **common), text)  # routed by the magic


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kw", [dict(), dict(weights=(2.0, 0.5)), dict(epochs=2),
                                dict(pad_to_batches=12), dict(drop_remainder=True)],
                         ids=["plain", "weights", "epochs", "pad", "drop"])
def test_shuffled_fmb_stream_is_jax_row_for_row(tmp_path, seed, kw):
    rng = np.random.default_rng(3)
    fmbs = []
    for i, n in enumerate((70, 55)):
        src = _write(tmp_path, f"s{i}.libsvm", _lines(rng, n))
        fmbs.append(binary.write_fmb(src, src + ".fmb", vocabulary_size=V))
    common = dict(batch_size=16, vocabulary_size=V, max_nnz=9, shuffle_seed=seed, **kw)
    got = list(binary.fmb_batch_stream(fmbs, **common))
    _all_equal(got, jax_binary.fmb_batch_stream(fmbs, **common))
    plain = list(binary.fmb_batch_stream(fmbs, **dict(common, shuffle_seed=None)))
    assert not np.array_equal(got[0][0].labels, plain[0][0].labels) or not np.array_equal(
        got[0][0].ids, plain[0][0].ids)
    # Every epoch visits every row once: the shuffled rows are a permutation.
    if not kw:
        rows = lambda bs: sorted(map(bytes, np.concatenate([p.ids for p, w in bs if w.any()])))
        assert rows(got) == rows(plain)
    assert np.array_equal(binary.draw_permutation(seed, 1, 50),
                          jax_binary.draw_permutation(seed, 1, 50))
    assert binary.fold_epoch_seed(seed, 3) == jax_binary.fold_epoch_seed(seed, 3)


def test_fmb_stream_refusals_like_jax(tmp_path):
    rng = np.random.default_rng(4)
    src = _write(tmp_path, "r.libsvm", _lines(rng, 40))
    fmb = binary.write_fmb(src, src + ".fmb", vocabulary_size=V)
    for kw, needle in ((dict(hash_feature_id=True), "hash_feature_id"),
                       (dict(vocabulary_size=V - 1), "vocabulary_size"),
                       (dict(max_nnz=2), "max_nnz")):
        args = dict(dict(batch_size=8, vocabulary_size=V), **kw)
        with pytest.raises(ValueError, match=needle):
            list(binary.fmb_batch_stream([fmb], **args))
        with pytest.raises(ValueError, match=needle):
            list(jax_binary.fmb_batch_stream([fmb], **args))
    with pytest.raises(ValueError, match="cannot mix FMB and text"):
        list(batch_stream([fmb, src], batch_size=8, vocabulary_size=V, max_nnz=9))
    with pytest.raises(ValueError, match="shuffle requires memmap"):
        list(batch_stream([src], batch_size=8, vocabulary_size=V, max_nnz=9, shuffle_seed=1))
    for skip in (7, -8):  # the seek takes whole batches only, as JAX's does
        with pytest.raises(ValueError, match="whole number of batches"):
            list(batch_stream([src], batch_size=8, vocabulary_size=V, max_nnz=9, skip_rows=skip))
        with pytest.raises(ValueError, match="whole number of batches"):
            list(jax_pipeline.batch_stream([src], batch_size=8, vocabulary_size=V, max_nnz=9,
                                           skip_rows=skip))


def test_shuffle_refusals_name_binary_cache_and_no_absent_verb(tmp_path, monkeypatch):
    """Both shuffle refusals tell the user to set binary_cache = true; the
    port has no convert verb or conversion tool to name."""
    src = _write(tmp_path, "s.libsvm", _lines(np.random.default_rng(8), 20))
    kw = dict(batch_size=8, vocabulary_size=V, max_nnz=9, shuffle_seed=1)
    with pytest.raises(ValueError) as text:
        list(batch_stream([src], **kw))
    # A cache that cannot be built leaves the text files in the list.
    monkeypatch.setattr(binary, "ensure_fmb_cache", lambda files, **_: tuple(files))
    with pytest.raises(ValueError) as unbuilt:
        list(batch_stream([src], binary_cache=True, **kw))
    for msg in (str(text.value), str(unbuilt.value)):
        assert "binary_cache = true" in msg
        assert "convert" not in msg and "tools/" not in msg


def test_fmb_reads_retry_a_transient_error_with_a_log_line(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    src = _write(tmp_path, "t.libsvm", _lines(rng, 20))
    fmb = binary.write_fmb(src, src + ".fmb", vocabulary_size=V)
    real, calls = binary.open_fmb, []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient")
        return real(path)

    monkeypatch.setattr(binary, "open_fmb", flaky)
    log = []
    got = list(binary.fmb_batch_stream([fmb], batch_size=8, vocabulary_size=V,
                                       io_retry_backoff_s=0.0, log=log.append))
    _all_equal(got, batch_stream([src], batch_size=8, vocabulary_size=V, max_nnz=got[0][0].max_nnz))
    assert len(calls) == 2 and len(log) == 1 and "io retry 1/3" in log[0]


def test_ensure_fmb_cache_reuses_invalidates_and_falls_back(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    srcs = [_write(tmp_path, f"c{i}.libsvm", _lines(rng, 50)) for i in range(2)]
    log = []
    kw = dict(vocabulary_size=V, max_nnz=9, log=log.append)
    out = binary.ensure_fmb_cache(srcs, **kw)
    assert out == tuple(s + ".fmb" for s in srcs)
    assert log == [f"building binary cache {s}.fmb" for s in srcs]
    # The JAX package takes the port's caches as fresh, and the reverse.
    assert jax_binary.ensure_fmb_cache(srcs, vocabulary_size=V, max_nnz=9) == out
    stamp = [os.stat(p).st_mtime_ns for p in out]
    log.clear()
    assert binary.ensure_fmb_cache(srcs, **kw) == out and log == []
    assert [os.stat(p).st_mtime_ns for p in out] == stamp
    # A changed source rebuilds its cache; so does another vocabulary.
    with open(srcs[1], "a") as f:
        f.write("1 3:1\n")
    binary.ensure_fmb_cache(srcs, **kw)
    assert log == [f"building binary cache {srcs[1]}.fmb"]
    assert binary.open_fmb(out[1]).n_rows == 51
    log.clear()
    binary.ensure_fmb_cache(srcs, **dict(kw, vocabulary_size=V + 1))
    assert len(log) == 0  # unhashed ids stay valid under a larger vocabulary
    binary.ensure_fmb_cache(srcs, **dict(kw, hash_feature_id=True))
    assert len(log) == 2
    # An unwritable cache location: the whole list streams as text, said in the log.
    fresh = [_write(tmp_path, f"u{i}.libsvm", _lines(rng, 30)) for i in range(2)]

    def unwritable(*a, **k):
        raise PermissionError(13, "Permission denied")

    monkeypatch.setattr(binary, "write_fmb", unwritable)
    log.clear()
    assert binary.ensure_fmb_cache(fresh, **kw) == tuple(fresh)
    assert any("cannot write" in m and "streaming text" in m for m in log)
    common = dict(batch_size=16, vocabulary_size=V, max_nnz=9)
    _all_equal(batch_stream(fresh, binary_cache=True, log=quiet, **common),
               batch_stream(fresh, **common))
    with pytest.raises(ValueError, match="could not be built"):
        list(batch_stream(fresh, binary_cache=True, shuffle_seed=1, log=quiet, **common))
    with pytest.raises(OSError, match="pre-built FMB with no text form"):
        binary.ensure_fmb_cache([out[0], fresh[1]], **kw)


def test_scan_max_nnz_and_count_lines_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    a = _write(tmp_path, "a.libsvm", _lines(rng, 40, width=(1, 6), blank_every=5))
    b = _write(tmp_path, "b.libsvm", _lines(rng, 30, width=(2, 14)))
    fmb = binary.write_fmb(b, str(tmp_path / "b.fmb"), vocabulary_size=V, max_nnz=20)
    for files in (dict(train_files=(a,)), dict(train_files=(a,), validation_files=(fmb,)),
                  dict(predict_files=(fmb,))):
        got = scan_max_nnz(Config(**files))
        assert got == jax_scan_max_nnz(JaxConfig(**files))
    assert scan_max_nnz(Config(train_files=(fmb,))) == binary.read_header(fmb).max_row_nnz <= 13
    assert count_lines([a, fmb]) == 70 == scan_files([a, b])[0]


def test_stack_parsed_gives_the_same_tensors_for_either_ids_dtype(tmp_path):
    rng = np.random.default_rng(2)
    path = _write(tmp_path, "k.libsvm", _lines(rng, 70))
    common = dict(batch_size=32, vocabulary_size=V, max_nnz=9)
    py = list(batch_stream([path], **common))
    nat = list(batch_stream([path], parser=best_parser(2), **common))
    assert py[0][0].ids.dtype == np.int64 and nat[0][0].ids.dtype == np.int32
    a = Batch.stack_parsed([p for p, _ in py], [w for _, w in py])
    b = Batch.stack_parsed([p for p, _ in nat], [w for _, w in nat])
    want = JaxBatch.stack_parsed([p for p, _ in py], [w for _, w in py], with_fields=False)
    for f in ("labels", "ids", "vals", "fields", "weights"):
        x, y, z = getattr(a, f), getattr(b, f), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and torch.equal(x, y), f
        assert x.shape == z.shape and np.array_equal(x.numpy(), z), f
    assert a.ids.dtype == torch.int32 and a.labels.shape == (3, 32)
    single = Batch.from_parsed(*nat[1])
    assert torch.equal(single.ids, a.ids[1]) and torch.equal(single.weights, a.weights[1])


def test_device_dataset_and_permutation_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    fmbs = []
    for i, n in enumerate((41, 30)):
        src = _write(tmp_path, f"d{i}.libsvm", _lines(rng, n))
        fmbs.append(binary.write_fmb(src, src + ".fmb", vocabulary_size=V))
    kw = dict(batch_size=16, vocabulary_size=V, max_nnz=9, weights=(1.0, 0.25))
    data = device_cache.load_device_dataset(fmbs, **kw)
    want = jax_device_cache.load_device_dataset(fmbs, with_fields=False, **kw)
    assert (data.batches, data.n_rows) == (want.batches, want.n_rows) == (5, 71)
    for f in ("labels", "ids", "vals", "fields", "weights"):
        assert np.array_equal(getattr(data, f).numpy(), np.asarray(getattr(want, f))), f
    assert data.nbytes == want.nbytes
    perm = device_cache.full_epoch_perm(data, 3, 1)
    assert np.array_equal(perm, jax_device_cache.full_epoch_perm(want, 3, 1))
    assert np.array_equal(perm[71:], np.arange(71, 80))
    chunks = device_cache.epoch_index_chunks(5, 2)
    want_chunks = jax_device_cache.epoch_index_chunks(5, 2)
    assert [c.tolist() for c in chunks] == [np.asarray(c).tolist() for c in want_chunks]
    # The shuffled epoch's batches are the shuffled stream's.
    device_cache.set_permutation(data, perm)
    stream = list(binary.fmb_batch_stream(fmbs, shuffle_seed=binary.fold_epoch_seed(3, 1), **kw))
    for i, (parsed, w) in enumerate(stream):
        b = device_cache._batch(data, torch.tensor(i), shuffled=True)
        assert np.array_equal(b.ids.numpy(), parsed.ids) and np.array_equal(b.weights.numpy(), w)
    assert jnp.asarray(want.ids).dtype == jnp.int32
