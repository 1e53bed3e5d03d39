"""Serving wire protocol: newline-delimited JSON, typed error codes, and
the binary DATA frame.

The port's own copy of ``fast_tffm_tpu/serving/protocol.py`` (stdlib and
numpy only): the same grammar, the same frame bytes and the same typed
errors, pinned in ``tools/analysis/formats.lock.json`` ("wire_protocol"),
so a client of either package talks to a front end or replica of the
other.  One grammar for every hop (client <-> front end, front end <->
router, router <-> replica):

  request   {"id": <any>, "line": "<libsvm>", "class": "gold",
             "deadline_ms": 50}
  score     {"id": <same>, "score": 0.123456}
  error     {"id": <same>, "code": "overloaded", "error": "<detail>"}
  ops       {"id": ..., "op": "ping" | "stats" | "reload" |
             "slow" | "hello" | "close", ...}  ->  {"id": ..., "ok": true, ...}

``id`` is caller-assigned and echoed verbatim; responses may arrive out
of submission order (micro-batching reorders), so callers key on it.
One JSON object per ``\\n``-terminated line, UTF-8.

Every admitted request line gets exactly one response line, a score or a
typed error ``code``, never a silently closed socket:

  * ``overloaded``  - shed at admission (queue full, or evicted by a
    higher-class request under tiered admission);
  * ``deadline``    - the request's own deadline expired before scoring;
  * ``bad_request`` - malformed line / out-of-range ids / bad fields;
  * ``unavailable`` - no healthy replica could answer.

**The binary DATA frame.**  JSONL stays the control plane and the
fallback data plane; a client may upgrade a data connection with
``{"op": "hello", "wire": "binary"}`` and then speak length-prefixed
frames.  Layout (little-endian; header = ``FRAME_HEADER_FORMAT``):

  magic(4s) version(B) kind(B) flags(H) count(H) width(H) payload(I)

followed by exactly ``payload`` bytes.  REQUEST payload sections, in
order, for ``count`` = n rows of ``width`` = w features:

  req_ids n x u32 | deadline_ms n x f32 | class_idx n x u8
  | ids n x w x i32 | vals n x w x f32 | [fields n x w x i32 iff HAS_FIELDS]
  | class table: u8 m, then m x (u8 len, utf-8 bytes)

SCORES payload: req_ids n x u32 | status n x u8 | scores n x f32; status 0
is a delivered score, anything else indexes ``FRAME_STATUS_CODES``.
ERROR payload (count = 0): u8 code idx | u16 len | utf-8 detail, the typed
answer to a frame the peer could not decode.

Device-free: the front end, router and client import it without torch.
"""

from __future__ import annotations

import json
import struct

import numpy as np

__all__ = [
    "WIRE_CODES",
    "FRAME_MAGIC",
    "FRAME_VERSION",
    "FRAME_HEADER",
    "FRAME_STATUS_CODES",
    "WireError",
    "Overloaded",
    "DeadlineExceeded",
    "BadRequest",
    "Unavailable",
    "exc_code",
    "error_response",
    "encode",
    "decode",
    "read_frame",
    "pack_request_frame",
    "unpack_request_frame",
    "pack_scores_frame",
    "unpack_scores_frame",
    "pack_error_frame",
    "unpack_error_frame",
]

WIRE_CODES = ("overloaded", "deadline", "bad_request", "unavailable")

# --- binary DATA frame constants (pinned in formats.lock.json) --------
FRAME_MAGIC = b"FMD1"
FRAME_VERSION = 1
FRAME_HEADER_FORMAT = "<4sBBHHHI"  # magic version kind flags count width payload
FRAME_HEADER = struct.Struct(FRAME_HEADER_FORMAT)
FRAME_KIND_REQUEST = 1
FRAME_KIND_SCORES = 2
FRAME_KIND_ERROR = 3
FRAME_FLAG_HAS_FIELDS = 1
# Garbage or torn headers die on this bound, not inside a gigabyte read.
FRAME_MAX_PAYLOAD = 1 << 24
# Per-row status byte in a SCORES frame: 0 = delivered score, else an
# index into this tuple.  Append-only — the wire outlives any release.
FRAME_STATUS_CODES = ("ok", "overloaded", "deadline", "bad_request", "unavailable")
assert FRAME_STATUS_CODES[1:] == WIRE_CODES

# Readiness announcements, parsed by routers/clients (`key=value` pairs
# after the prefix).  Defined here so the printer and every parser share
# one spelling.
SERVE_READY_PREFIX = "SERVE_READY "  # front end on stdout
REPLICA_READY_PREFIX = "REPLICA_READY "  # replica worker on stdout


class WireError(RuntimeError):
    """A typed serving failure; ``code`` is what goes on the wire."""

    code = "unavailable"


class Overloaded(WireError):
    """Shed at admission: queue full, or evicted for a higher class."""

    code = "overloaded"


class DeadlineExceeded(WireError):
    """The request's deadline expired before it could be scored."""

    code = "deadline"


class BadRequest(WireError):
    """Unparseable/invalid request — the caller's bug, not overload."""

    code = "bad_request"


class Unavailable(WireError):
    """No healthy replica could answer (and the one retry is spent)."""

    code = "unavailable"


def exc_code(exc: BaseException) -> str:
    """Wire code for an exception.  WireError carries its own; the
    engine's own types map by NAME so this module never has to import
    the (torch-heavy) engine: OverloadError → overloaded, ValueError →
    bad_request, anything else (EngineClosed, a scoring crash, a dead
    replica) → unavailable."""
    if isinstance(exc, WireError):
        return exc.code
    if type(exc).__name__ == "OverloadError":
        return "overloaded"
    if isinstance(exc, ValueError):
        return "bad_request"
    return "unavailable"


def error_response(req_id, exc: BaseException) -> dict:
    return {"id": req_id, "code": exc_code(exc), "error": str(exc) or repr(exc)}


def encode(obj: dict) -> bytes:
    """One wire line.  Compact separators: at 10k+ QPS the spaces are
    measurable; non-ASCII survives as \\u escapes on any locale."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def decode(line: bytes | str) -> dict:
    """Parse one wire line; raises BadRequest (never a bare JSON error)
    so handlers answer malformed input with a typed response."""
    try:
        obj = json.loads(line)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BadRequest(f"malformed request line: {e}") from None
    if not isinstance(obj, dict):
        raise BadRequest(f"request must be a JSON object, got {type(obj).__name__}")
    return obj


# ----------------------------------------------------------------------
# Binary DATA frames
# ----------------------------------------------------------------------


def _read_exact(reader, n: int) -> bytes:
    """Read exactly n bytes from a (buffered) binary reader; short data
    means the peer died mid-frame."""
    buf = reader.read(n)
    if buf is None:
        buf = b""
    while len(buf) < n:
        chunk = reader.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def read_frame(reader):
    """Read one frame from a buffered binary reader.

    Returns ``(kind, flags, count, width, payload)``; ``None`` on clean
    EOF at a frame boundary.  Raises BadRequest for anything torn: a
    truncated header, wrong magic/version (framing is lost — the caller
    should answer with an ERROR frame and close), an absurd payload
    length, or EOF mid-payload.  Never hangs on a well-formed header:
    at most ``payload`` more bytes are awaited.
    """
    hdr = _read_exact(reader, FRAME_HEADER.size)
    if not hdr:
        return None
    if len(hdr) < FRAME_HEADER.size:
        raise BadRequest(f"truncated frame header ({len(hdr)}/{FRAME_HEADER.size} bytes)")
    magic, version, kind, flags, count, width, payload_len = FRAME_HEADER.unpack(hdr)
    if magic != FRAME_MAGIC:
        raise BadRequest(f"bad frame magic {magic!r} (want {FRAME_MAGIC!r})")
    if version != FRAME_VERSION:
        raise BadRequest(f"unsupported frame version {version} (want {FRAME_VERSION})")
    if payload_len > FRAME_MAX_PAYLOAD:
        raise BadRequest(f"frame payload {payload_len} exceeds max {FRAME_MAX_PAYLOAD}")
    payload = _read_exact(reader, payload_len)
    if len(payload) < payload_len:
        raise BadRequest(f"truncated frame payload ({len(payload)}/{payload_len} bytes)")
    return kind, flags, count, width, payload


def _header(kind: int, flags: int, count: int, width: int, payload: bytes) -> bytes:
    return FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION, kind, flags, count, width, len(payload))


def pack_request_frame(req_ids, ids, vals, fields=None, deadlines_ms=None, classes=None) -> bytes:
    """One REQUEST frame: n rows coalesced into a single buffer.

    ``ids``/``vals`` (and ``fields`` if given) are (n, width) arrays;
    ``deadlines_ms`` per-row relative deadlines (0 / None = none) —
    relative on purpose: the server anchors them at wire receipt, same
    as the JSONL ``deadline_ms`` field, so client-side socket-buffer
    wait does not eat the budget and no cross-host monotonic-clock
    agreement is assumed.  ``classes`` is a per-row sequence of class
    names (None = all default class).
    """
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    if ids.ndim != 2 or vals.shape != ids.shape:
        raise ValueError(f"ids/vals must be matching (n, width) arrays, got {ids.shape}/{vals.shape}")
    n, width = ids.shape
    req = np.ascontiguousarray(req_ids, dtype=np.uint32)
    if req.shape != (n,):
        raise ValueError(f"req_ids must be ({n},), got {req.shape}")
    if deadlines_ms is None:
        dl = np.zeros(n, dtype=np.float32)
    else:
        dl = np.ascontiguousarray(deadlines_ms, dtype=np.float32)
        if dl.shape != (n,):
            raise ValueError(f"deadlines_ms must be ({n},), got {dl.shape}")
    names: list[str] = []
    if classes is None:
        idx = np.zeros(n, dtype=np.uint8)
        names = [""]
    else:
        table: dict[str, int] = {}
        idx = np.empty(n, dtype=np.uint8)
        for i, klass in enumerate(classes):
            k = str(klass or "")
            j = table.get(k)
            if j is None:
                j = table.setdefault(k, len(table))
                if j > 255:
                    raise ValueError("more than 256 distinct classes in one frame")
            idx[i] = j
        names = list(table)
    parts = [req.tobytes(), dl.tobytes(), idx.tobytes(), ids.tobytes(), vals.tobytes()]
    flags = 0
    if fields is not None:
        fld = np.ascontiguousarray(fields, dtype=np.int32)
        if fld.shape != ids.shape:
            raise ValueError(f"fields must match ids shape {ids.shape}, got {fld.shape}")
        parts.append(fld.tobytes())
        flags |= FRAME_FLAG_HAS_FIELDS
    tbl = [struct.pack("<B", len(names))]
    for name in names:
        raw = name.encode("utf-8")
        if len(raw) > 255:
            raise ValueError(f"class name too long for wire: {name!r}")
        tbl.append(struct.pack("<B", len(raw)) + raw)
    parts.append(b"".join(tbl))
    payload = b"".join(parts)
    return _header(FRAME_KIND_REQUEST, flags, n, width, payload) + payload


def unpack_request_frame(flags: int, count: int, width: int, payload: bytes) -> dict:
    """Decode a REQUEST payload into arrays (one decode per frame).

    Returns ``{"req_ids", "deadlines_ms", "ids", "vals", "fields",
    "classes"}`` — ``fields`` is None without HAS_FIELDS, ``classes`` a
    per-row list of names.  Raises BadRequest on any size mismatch, so
    a torn payload gets a typed answer instead of an exception escape.
    """
    n, w = int(count), int(width)
    has_fields = bool(flags & FRAME_FLAG_HAS_FIELDS)
    fixed = n * 4 + n * 4 + n + n * w * 4 * (3 if has_fields else 2)
    if len(payload) < fixed + 1:
        raise BadRequest(
            f"request frame payload too short: {len(payload)} bytes for count={n} width={w}"
        )
    try:
        off = 0
        req_ids = np.frombuffer(payload, np.uint32, n, off); off += n * 4
        deadlines = np.frombuffer(payload, np.float32, n, off); off += n * 4
        idx = np.frombuffer(payload, np.uint8, n, off); off += n
        ids = np.frombuffer(payload, np.int32, n * w, off).reshape(n, w); off += n * w * 4
        vals = np.frombuffer(payload, np.float32, n * w, off).reshape(n, w); off += n * w * 4
        fields = None
        if has_fields:
            fields = np.frombuffer(payload, np.int32, n * w, off).reshape(n, w); off += n * w * 4
        m = payload[off]; off += 1
        names = []
        for _ in range(m):
            ln = payload[off]; off += 1
            names.append(payload[off:off + ln].decode("utf-8")); off += ln
            if off > len(payload):
                raise ValueError("class table overruns payload")
        if idx.size and (m == 0 or int(idx.max()) >= m):
            raise ValueError("class index outside table")
    except (ValueError, IndexError) as e:
        raise BadRequest(f"malformed request frame: {e}") from None
    classes = [names[i] for i in idx] if n else []
    return {
        "req_ids": req_ids,
        "deadlines_ms": deadlines,
        "ids": ids,
        "vals": vals,
        "fields": fields,
        "classes": classes,
    }


def pack_scores_frame(req_ids, statuses, scores) -> bytes:
    """One SCORES frame: float32 rows back, status byte per row."""
    req = np.ascontiguousarray(req_ids, dtype=np.uint32)
    st = np.ascontiguousarray(statuses, dtype=np.uint8)
    sc = np.ascontiguousarray(scores, dtype=np.float32)
    n = req.size
    if st.shape != (n,) or sc.shape != (n,):
        raise ValueError(f"statuses/scores must be ({n},), got {st.shape}/{sc.shape}")
    payload = req.tobytes() + st.tobytes() + sc.tobytes()
    return _header(FRAME_KIND_SCORES, 0, n, 0, payload) + payload


def unpack_scores_frame(count: int, payload: bytes):
    """Decode a SCORES payload → (req_ids u32, statuses u8, scores f32)."""
    n = int(count)
    if len(payload) != n * 9:
        raise BadRequest(f"scores frame payload {len(payload)} bytes != {n * 9} for count={n}")
    req_ids = np.frombuffer(payload, np.uint32, n, 0)
    statuses = np.frombuffer(payload, np.uint8, n, n * 4)
    scores = np.frombuffer(payload, np.float32, n, n * 5)
    return req_ids, statuses, scores


def pack_error_frame(code: str, detail: str = "") -> bytes:
    """A connection-scoped typed error (e.g. the answer to a frame the
    server could not decode): no req_ids to echo, but never silence."""
    ci = FRAME_STATUS_CODES.index(code) if code in FRAME_STATUS_CODES else FRAME_STATUS_CODES.index("unavailable")
    raw = detail.encode("utf-8")[:65535]
    payload = struct.pack("<BH", ci, len(raw)) + raw
    return _header(FRAME_KIND_ERROR, 0, 0, 0, payload) + payload


def unpack_error_frame(payload: bytes):
    """Decode an ERROR payload → (code, detail)."""
    if len(payload) < 3:
        raise BadRequest(f"error frame payload too short: {len(payload)} bytes")
    ci, ln = struct.unpack_from("<BH", payload, 0)
    detail = payload[3:3 + ln].decode("utf-8", "replace")
    code = FRAME_STATUS_CODES[ci] if ci < len(FRAME_STATUS_CODES) else "unavailable"
    return code, detail
