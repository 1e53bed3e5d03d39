"""Port: the serving wire protocol and the socket tier's config keys,
against the JAX package.

The port keeps its own copy of ``fast_tffm_tpu/serving/protocol.py``.  The
same numpy-seeded inputs go through both packages' ``pack_*_frame``: the
bytes must be identical, each package must decode the other's frames, the
layout constants must be the ones ``tools/analysis/formats.lock.json``
pins, torn input must raise the typed ``BadRequest`` (never hang), and the
``[Serving]`` / ``[Resilience]`` keys of the socket tier must parse and
validate as the JAX package's do.
"""

import io
import json
import os
import struct

import numpy as np
import pytest

from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.resilience import RestartPolicy as JaxRestartPolicy
from fast_tffm_tpu.serving import protocol as jp
from fast_tffm_tpu_torch.config import Config, load_config
from fast_tffm_tpu_torch.resilience import RestartPolicy
from fast_tffm_tpu_torch.serving import protocol as tp
from fast_tffm_tpu_torch.serving.engine import OverloadError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(rng, n, w, fields):
    ids = rng.integers(0, 1 << 20, size=(n, w)).astype(np.int32)
    vals = rng.uniform(-1, 1, size=(n, w)).astype(np.float32)
    fld = rng.integers(0, 22, size=(n, w)).astype(np.int32) if fields else None
    return ids, vals, fld


CASES = {
    "plain": dict(n=5, w=11, fields=False, deadlines=False, classes=None),
    "fields": dict(n=3, w=22, fields=True, deadlines=False, classes=None),
    "deadlines": dict(n=64, w=11, fields=False, deadlines=True, classes=None),
    "classes": dict(n=7, w=4, fields=False, deadlines=True,
                    classes=["gold", "", "std", "gold", "std", "", "gold"]),
    "one_class": dict(n=2, w=1, fields=True, deadlines=False, classes=["näive", "näive"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_request_frames_are_byte_identical_and_cross_decode(case):
    c = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    ids, vals, fld = _rows(rng, c["n"], c["w"], c["fields"])
    req = rng.integers(0, 2**32, size=c["n"], dtype=np.uint64).astype(np.uint32)
    dl = rng.uniform(0, 200, size=c["n"]).astype(np.float32) if c["deadlines"] else None
    kw = dict(fields=fld, deadlines_ms=dl, classes=c["classes"])
    ours = tp.pack_request_frame(req, ids, vals, **kw)
    theirs = jp.pack_request_frame(req, ids, vals, **kw)
    assert ours == theirs
    for reader, unpack in ((tp.read_frame, jp.unpack_request_frame),
                           (jp.read_frame, tp.unpack_request_frame)):
        kind, flags, count, width, payload = reader(io.BytesIO(ours))
        assert (kind, count, width) == (tp.FRAME_KIND_REQUEST, c["n"], c["w"])
        d = unpack(flags, count, width, payload)
        np.testing.assert_array_equal(d["req_ids"], req)
        np.testing.assert_array_equal(d["ids"], ids)
        np.testing.assert_array_equal(d["vals"], vals)
        if fld is None:
            assert d["fields"] is None
        else:
            np.testing.assert_array_equal(d["fields"], fld)
        np.testing.assert_array_equal(d["deadlines_ms"], dl if dl is not None else 0)
        assert d["classes"] == [str(k or "") for k in (c["classes"] or [""] * c["n"])]


def test_scores_and_error_frames_are_byte_identical_and_cross_decode():
    rng = np.random.default_rng(11)
    n = 37
    req = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    st = rng.integers(0, len(tp.FRAME_STATUS_CODES), size=n).astype(np.uint8)
    sc = rng.random(n).astype(np.float32)
    ours = tp.pack_scores_frame(req, st, sc)
    assert ours == jp.pack_scores_frame(req, st, sc)
    for reader, unpack in ((tp.read_frame, jp.unpack_scores_frame),
                           (jp.read_frame, tp.unpack_scores_frame)):
        kind, _, count, _, payload = reader(io.BytesIO(ours))
        assert kind == tp.FRAME_KIND_SCORES
        r, s, v = unpack(count, payload)
        np.testing.assert_array_equal(r, req)
        np.testing.assert_array_equal(s, st)
        np.testing.assert_array_equal(v, sc)
    for code, detail in (("bad_request", "torn"), ("deadline", ""), ("nonsense", "x" * 70000)):
        ours = tp.pack_error_frame(code, detail)
        assert ours == jp.pack_error_frame(code, detail)
        _, _, _, _, payload = tp.read_frame(io.BytesIO(ours))
        assert tp.unpack_error_frame(payload) == jp.unpack_error_frame(payload)


def test_jsonl_codes_and_errors_match_jax():
    for name in ("DeadlineExceeded", "Unavailable", "BadRequest", "Overloaded", "WireError"):
        assert tp.exc_code(getattr(tp, name)("x")) == jp.exc_code(getattr(jp, name)("x"))
    assert tp.exc_code(OverloadError("full")) == "overloaded"  # by name
    assert tp.exc_code(ValueError("parse")) == "bad_request"
    assert tp.exc_code(RuntimeError("boom")) == "unavailable"
    msg = {"id": 7, "line": "1 3:0.5", "class": "gold", "deadline_ms": 50}
    assert tp.encode(msg) == jp.encode(msg)
    assert tp.decode(jp.encode(msg)) == msg
    assert tp.error_response(3, tp.DeadlineExceeded("late")) == jp.error_response(
        3, jp.DeadlineExceeded("late"))
    for bad in (b"not json", b"[1, 2]", b"\xff\xfe"):
        with pytest.raises(tp.BadRequest):
            tp.decode(bad)


def test_frame_layout_is_the_locked_one():
    with open(os.path.join(REPO, "tools", "analysis", "formats.lock.json")) as f:
        lock = json.load(f)["sections"]["wire_protocol"]
    frame = lock["frame"]
    assert tp.FRAME_HEADER_FORMAT == frame["FRAME_HEADER_FORMAT"]
    assert tp.FRAME_MAGIC == frame["FRAME_MAGIC"].encode()
    assert tp.FRAME_VERSION == frame["FRAME_VERSION"]
    assert tp.FRAME_MAX_PAYLOAD == frame["FRAME_MAX_PAYLOAD"]
    assert tp.FRAME_FLAG_HAS_FIELDS == frame["FRAME_FLAG_HAS_FIELDS"]
    assert (tp.FRAME_KIND_REQUEST, tp.FRAME_KIND_SCORES, tp.FRAME_KIND_ERROR) == (
        frame["FRAME_KIND_REQUEST"], frame["FRAME_KIND_SCORES"], frame["FRAME_KIND_ERROR"])
    assert list(tp.FRAME_STATUS_CODES) == lock["FRAME_STATUS_CODES"]
    assert list(tp.WIRE_CODES) == lock["WIRE_CODES"]
    assert tp.SERVE_READY_PREFIX == lock["ready_prefixes"]["SERVE_READY_PREFIX"]
    assert tp.REPLICA_READY_PREFIX == lock["ready_prefixes"]["REPLICA_READY_PREFIX"]
    for name, code in lock["exception_codes"].items():
        assert getattr(tp, name).code == code
    assert tp.FRAME_HEADER.size == 16


def _torn_inputs():
    good = tp.pack_request_frame(np.arange(3, dtype=np.uint32), np.zeros((3, 2), np.int32),
                                 np.ones((3, 2), np.float32))
    hdr = tp.FRAME_HEADER
    return {
        "short_header": good[:7],
        "bad_magic": b"GARBAGE!" * 2 + good[16:],
        "bad_version": hdr.pack(tp.FRAME_MAGIC, 9, 1, 0, 3, 2, 0),
        "huge_payload": hdr.pack(tp.FRAME_MAGIC, 1, 1, 0, 3, 2, tp.FRAME_MAX_PAYLOAD + 1),
        "short_payload": good[:-5],
    }


@pytest.mark.parametrize("what", list(_torn_inputs()))
def test_torn_frames_raise_typed_errors_never_hang(what):
    data = _torn_inputs()[what]
    for mod in (tp, jp):
        with pytest.raises(mod.BadRequest) as ei:
            mod.read_frame(io.BytesIO(data))
        assert mod.exc_code(ei.value) == "bad_request"
    assert tp.read_frame(io.BytesIO(b"")) is None  # clean EOF at a boundary


def test_torn_payloads_raise_typed_errors():
    with pytest.raises(tp.BadRequest):
        tp.unpack_request_frame(0, 9, 4, b"\x00" * 32)  # too short for 9 rows
    req = tp.pack_request_frame(np.arange(2, dtype=np.uint32), np.zeros((2, 1), np.int32),
                                np.zeros((2, 1), np.float32), classes=["a", "b"])
    _, flags, count, width, payload = tp.read_frame(io.BytesIO(req))
    with pytest.raises(tp.BadRequest):  # class table cut off
        tp.unpack_request_frame(flags, count, width, payload[:-2])
    with pytest.raises(tp.BadRequest):
        tp.unpack_scores_frame(3, b"\x00" * 26)
    with pytest.raises(tp.BadRequest):
        tp.unpack_error_frame(b"\x00")
    with pytest.raises(ValueError):  # 3 request ids for 2 rows
        tp.pack_request_frame(np.arange(3, dtype=np.uint32), np.zeros((2, 1), np.int32),
                              np.zeros((2, 1), np.float32))


INI = """
[General]
model = fm
vocabulary_size = 1024
[Serving]
{serving}
[Resilience]
{resilience}
"""


@pytest.mark.parametrize(
    "serving,resilience",
    [
        ("", ""),
        ("replicas = 3\nwire = JSONL\naffinity = false\nreload_max_retries = 2\nport = 7071",
         "restart_max = 0\nrestart_backoff_s = 0.25\nrestart_backoff_max_s = 4"),
        ("wire = binary\naffinity = yes\nreload_interval_s = 0.2", "restart_max = 9"),
    ],
    ids=["defaults", "set", "binary"],
)
def test_socket_tier_keys_parse_as_jax(tmp_path, serving, resilience):
    path = tmp_path / "c.cfg"
    path.write_text(INI.format(serving=serving, resilience=resilience))
    ours, theirs = load_config(str(path)), jax_load_config(str(path))
    for key in ("serve_replicas", "serve_wire", "serve_affinity", "serve_reload_max_retries",
                "serve_port", "serve_reload_interval_s", "restart_max", "restart_backoff_s",
                "restart_backoff_max_s"):
        assert getattr(ours, key) == getattr(theirs, key), key
    p, q = (RestartPolicy(ours.restart_max, ours.restart_backoff_s, ours.restart_backoff_max_s),
            JaxRestartPolicy(theirs.restart_max, theirs.restart_backoff_s,
                             theirs.restart_backoff_max_s))
    assert [p.backoff(a) for a in range(1, 12)] == [q.backoff(a) for a in range(1, 12)]


@pytest.mark.parametrize(
    "bad",
    [dict(serve_replicas=0), dict(serve_wire="grpc"), dict(serve_reload_max_retries=0),
     dict(serve_port=70000), dict(restart_max=-1), dict(restart_backoff_s=-1.0),
     dict(restart_backoff_max_s=-0.5)],
    ids=lambda d: next(iter(d)),
)
def test_socket_tier_keys_validate_as_jax(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad).validate()
    with pytest.raises(ValueError):
        Config(**bad).validate()


def test_restart_policy_matches_jax():
    for args in ((5, 1.0, 30.0), (0, 1.0, 30.0), (3, 0.01, 0.02), (-2, 0.5, 1.0)):
        ours, theirs = RestartPolicy(*args), JaxRestartPolicy(*args)
        assert ours.max_restarts == theirs.max_restarts
        assert [ours.backoff(a) for a in range(1, 9)] == [theirs.backoff(a) for a in range(1, 9)]


def test_header_struct_is_little_endian_16_bytes():
    hdr = tp.FRAME_HEADER.pack(tp.FRAME_MAGIC, 1, 2, 3, 4, 5, 6)
    assert hdr == b"FMD1" + struct.pack("<BBHHHI", 1, 2, 3, 4, 5, 6)
