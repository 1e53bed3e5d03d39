"""The OCDBT key-value store and the zarr v2 arrays in it, in numpy + ctypes.

An orbax checkpoint directory (``ocp.StandardCheckpointer``, ``use_ocdbt``
and zarr v2, what ``fast_tffm_tpu/checkpoint.py::_save_orbax`` writes) is
one OCDBT database at its root — ``manifest.ocdbt`` and B-tree nodes in
``d/`` — whose values may live in the data files of per-process databases
(``ocdbt.process_<i>/``).  Its keys are zarr v2 arrays: ``<name>/.zarray``
(JSON metadata) and one value per chunk, ``<name>/<i>.<j>`` (``<name>/0``
for a scalar).  This module reads and writes that layout without
tensorstore, following tensorstore's "OCDBT on-disk format":

* A manifest or a B-tree node is an envelope: the magic number (big-endian
  ``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a node), the total
  length (uint64 LE), a varint version (0), a varint compression format
  (0 none, 1 zstd) and the payload, then the CRC-32C (LE) of every byte
  before it.
* The manifest's payload: the config (uuid, manifest kind, inline and node
  limits, version-tree arity, compression method), the data-file table and
  the versions (generation, root height, root node reference, statistics,
  commit time); the newest version's root is the tree.
* A node's payload: its height, its data-file table, and columnar entries:
  keys prefix-compressed against the previous key; a leaf's values inline
  or indirect (data file, offset, length); an interior node's children by
  reference, their keys relative to each entry's subtree common prefix.
  Data-file paths are ``base_path + relative_path``, relative to the
  database root; a node read from a file under a base path resolves its
  own table under that base path.

Reading raises ``ValueError`` naming the file for an unknown magic number,
a checksum or length mismatch, a missing data file, a value cut short or a
compression method it does not know, and never returns a partial tree.
zstd (tensorstore's default for nodes and orbax's for chunks) is read
through ``libzstd`` loaded with ``ctypes`` when a compressed frame is met;
without the library that read raises, naming it.

The writer (``OcdbtWriter``) writes one version: every large value into
one data file as an indirect reference, small values inline, one leaf node
after them, and the manifest — with ``compression = none`` in the config
and the envelopes, and ``"compressor": null`` in each ``.zarray``, so a
save needs no ``libzstd``.  ``write_root`` merges per-process databases
into the root database a multi-process orbax save has: one leaf whose
indirect values point into ``ocdbt.process_<i>/d/``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import time
import uuid

import numpy as np

__all__ = ["OcdbtStore", "OcdbtWriter", "ZarrArray", "chunk_key", "write_root", "zarray_bytes"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # orbax's config: .zarray inline, chunks in data files
MAX_DECODED_NODE_BYTES = 100_000_000
_VERSION_TREE_ARITY_LOG2 = 4
_MANIFEST_NAME = "manifest.ocdbt"

# ---------------------------------------------------------------------------
# CRC-32C, varints, zstd
# ---------------------------------------------------------------------------


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``; manifests and nodes are small."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n = int(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Cursor:
    """Reads the payload of one manifest or node; running off its end is a
    format error naming the file."""

    def __init__(self, data: bytes, where: str):
        self.data = data
        self.pos = 0
        self.where = where

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.where}: payload ends early (corrupt or truncated)")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.where}: varint too long (corrupt)")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


class _ZstdInBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _ZstdOutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_ZSTD = []  # the loaded library, once
_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


def _zstd():
    """libzstd through ctypes, loaded on the first compressed read."""
    if _ZSTD:
        return _ZSTD[0]
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise ValueError(
            "reading a zstd-compressed OCDBT node or zarr chunk needs libzstd "
            "(libzstd.so.1), which this host does not have; the port's own "
            "saves are uncompressed and need no libzstd"
        )
    lib = ctypes.CDLL(name)
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_initDStream.restype = ctypes.c_size_t
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ZstdOutBuffer),
                                          ctypes.POINTER(_ZstdInBuffer)]
    lib.ZSTD_freeDStream.restype = ctypes.c_size_t
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    _ZSTD.append(lib)
    return lib


def _zstd_check(lib, r: int, where: str) -> int:
    if lib.ZSTD_isError(r):
        raise ValueError(f"{where}: zstd frame is corrupt ({lib.ZSTD_getErrorName(r).decode()})")
    return r


def zstd_decompress(src: bytes, where: str, *, out: np.ndarray | None = None,
                    limit: int = MAX_DECODED_NODE_BYTES) -> bytes | None:
    """Decompress the zstd frame(s) ``src``.  With ``out`` (a contiguous
    buffer of the exact decoded size) the bytes land there and None is
    returned; otherwise the decoded bytes (at most ``limit``) are."""
    lib = _zstd()
    srcbuf = ctypes.create_string_buffer(bytes(src), len(src))
    size = lib.ZSTD_getFrameContentSize(srcbuf, len(src))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError(f"{where}: not a zstd frame (corrupt)")
    if out is not None and size == out.nbytes:
        r = _zstd_check(lib, lib.ZSTD_decompress(out.ctypes.data, out.nbytes, srcbuf, len(src)),
                        where)
        if r != out.nbytes:
            raise ValueError(f"{where}: zstd frame decodes to {r} bytes, expected {out.nbytes}")
        return None
    if size != _ZSTD_CONTENTSIZE_UNKNOWN and out is None and size <= limit:
        dst = ctypes.create_string_buffer(max(1, size))
        r = _zstd_check(lib, lib.ZSTD_decompress(dst, size, srcbuf, len(src)), where)
        return dst.raw[:r]
    # Streaming: a frame without its content size (tensorstore's nodes).
    parts = []
    total = 0
    step = 1 << 17
    dst = ctypes.create_string_buffer(step)
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _zstd_check(lib, lib.ZSTD_initDStream(ds), where)
        inb = _ZstdInBuffer(ctypes.cast(srcbuf, ctypes.c_void_p), len(src), 0)
        last = 1
        while inb.pos < inb.size or last != 0:
            outb = _ZstdOutBuffer(ctypes.cast(dst, ctypes.c_void_p), step, 0)
            before = inb.pos
            last = _zstd_check(lib, lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                                              ctypes.byref(inb)), where)
            parts.append(dst.raw[: outb.pos])
            total += outb.pos
            if total > limit:
                raise ValueError(f"{where}: zstd frame decodes past {limit} bytes (corrupt)")
            if outb.pos == 0 and inb.pos == before:
                if last != 0:
                    raise ValueError(f"{where}: zstd frame is truncated")
                break
    finally:
        lib.ZSTD_freeDStream(ds)
    data = b"".join(parts)
    if out is not None:
        if len(data) != out.nbytes:
            raise ValueError(f"{where}: zstd frame decodes to {len(data)} bytes, "
                             f"expected {out.nbytes}")
        out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        return None
    return data


# ---------------------------------------------------------------------------
# envelopes, data-file tables
# ---------------------------------------------------------------------------


def _open_envelope(raw: bytes, magic: int, where: str) -> bytes:
    """The payload of a manifest or node envelope, every check passed."""
    what = "manifest" if magic == MANIFEST_MAGIC else "B-tree node"
    if len(raw) < 4 + 8 + 2 + 4:
        raise ValueError(f"OCDBT {what} {where}: {len(raw)} bytes, too short (truncated)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"OCDBT {what} {where}: unknown magic number {got:#010x} "
                         f"(expected {magic:#010x})")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"OCDBT {what} {where}: header says {length} bytes, found "
                         f"{len(raw)} (truncated or corrupt)")
    stored = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != stored:
        raise ValueError(f"OCDBT {what} {where}: CRC-32C checksum mismatch (corrupt)")
    cur = _Cursor(raw[12:-4], f"{what} {where}")
    version = cur.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what} {where}: unknown format version {version}")
    method = cur.varint()
    body = raw[12 + cur.pos : -4]
    if method == 0:
        return body
    if method == 1:
        return zstd_decompress(body, f"OCDBT {what} {where}")
    raise ValueError(f"OCDBT {what} {where}: unknown compression format {method}")


def _seal_envelope(magic: int, payload: bytes) -> bytes:
    """An uncompressed envelope around ``payload``."""
    head = _varint(0) + _varint(0)
    n = 4 + 8 + len(head) + len(payload) + 4
    body = magic.to_bytes(4, "big") + n.to_bytes(8, "little") + head + payload
    return body + crc32c(body).to_bytes(4, "little")


def _read_file_table(cur: _Cursor, transitive: str) -> list[tuple[str, str]]:
    """[(base_path, relative_path)] with the containing file's base path
    prepended to each base path."""
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {cur.where}: data-file table prefix out of range (corrupt)")
        path = prev[: prefix[i]] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"OCDBT {cur.where}: data-file base path out of range (corrupt)")
        out.append((transitive + path[: base_len[i]].decode(), path[base_len[i] :].decode()))
        prev = path
    return out


def _file_table_bytes(paths: list[tuple[str, str]]) -> bytes:
    """The encoded table of (base_path, relative_path), in the given order."""
    full = [(b + r).encode() for b, r in paths]
    out = bytearray(_varint(len(full)))
    prev = b""
    prefixes = []
    for p in full:
        k = 0
        while k < min(len(p), len(prev)) and p[k] == prev[k]:
            k += 1
        prefixes.append(k)
        prev = p
    for k in prefixes[1:]:
        out += _varint(k)
    for p, k in zip(full, prefixes):
        out += _varint(len(p) - k)
    for b, _ in paths:
        out += _varint(len(b.encode()))
    for p, k in zip(full, prefixes):
        out += p[k:]
    return bytes(out)


def _keys(cur: _Cursor, n: int, interior: bool):
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {cur.where}: key prefix out of range (corrupt)")
        k = prev[: prefix[i]] + cur.take(suffix[i])
        keys.append(k)
        prev = k
    return keys, common


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class OcdbtStore:
    """One OCDBT database opened for reading: the newest version's keys
    and where each value lives (inline bytes, or a data file, offset and
    length), every manifest and node checked as it is parsed.
    ``opened_files`` names the data files a value read opened and
    ``values_read`` the keys read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._entries: dict[str, tuple] = {}
        self.opened_files: set[str] = set()
        self.values_read: set[str] = set()
        man = os.path.join(self.root, _MANIFEST_NAME)
        try:
            with open(man, "rb") as f:
                raw = f.read()
        except FileNotFoundError as e:
            raise ValueError(f"{self.root!r} holds no OCDBT manifest ({_MANIFEST_NAME} "
                             "missing: not an orbax checkpoint, or one caught mid-write)") from e
        cur = _Cursor(_open_envelope(raw, MANIFEST_MAGIC, man), f"manifest {man}")
        self.uuid = cur.take(16).hex()
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"OCDBT manifest {man}: manifest kind {kind} (numbered) is not "
                             "supported; orbax writes the single-file kind 0")
        self.max_inline_value_bytes = cur.varint()
        self.max_decoded_node_bytes = cur.varint()
        cur.byte()  # version tree arity log2
        method = cur.varint()
        if method == 1:
            cur.take(4)  # zstd level
        elif method != 0:
            raise ValueError(f"OCDBT manifest {man}: unknown compression method {method}")
        files = _read_file_table(cur, "")
        n = cur.varint()
        if n == 0:
            raise ValueError(f"OCDBT manifest {man}: no committed version")
        gens = cur.varints(n)
        heights = list(cur.take(n))
        fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
        nkeys = cur.varints(n)
        newest = max(range(n), key=lambda i: gens[i])
        self.generation = gens[newest]
        if nkeys[newest] == 0:
            return  # an empty tree
        if fids[newest] >= len(files):
            raise ValueError(f"OCDBT manifest {man}: root references data file "
                             f"{fids[newest]} of {len(files)} (corrupt)")
        self._walk(files[fids[newest]], offs[newest], lens[newest], heights[newest], b"")
        if len(self._entries) != nkeys[newest]:
            raise ValueError(f"OCDBT manifest {man}: the tree holds {len(self._entries)} "
                             f"keys, the manifest says {nkeys[newest]} (corrupt)")

    def _read_file(self, ref: tuple[str, str], offset: int, length: int) -> bytes:
        path = os.path.join(self.root, ref[0] + ref[1])
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                raw = f.read(length)
        except FileNotFoundError as e:
            raise ValueError(f"OCDBT data file {path!r} is missing (deleted, or the "
                             "checkpoint was caught mid-write)") from e
        if len(raw) != length:
            raise ValueError(f"OCDBT data file {path!r}: {length} bytes at offset {offset} "
                             f"expected, {len(raw)} found (truncated)")
        return raw

    def _walk(self, ref, offset: int, length: int, height: int, prefix: bytes) -> None:
        where = f"{os.path.join(self.root, ref[0] + ref[1])}@{offset}"
        payload = _open_envelope(self._read_file(ref, offset, length), NODE_MAGIC, where)
        cur = _Cursor(payload, f"B-tree node {where}")
        h = cur.byte()
        if h != height:
            raise ValueError(f"OCDBT B-tree node {where}: height {h}, its parent says "
                             f"{height} (corrupt)")
        files = _read_file_table(cur, ref[0])
        n = cur.varint()
        if n == 0:
            raise ValueError(f"OCDBT B-tree node {where}: no entries (corrupt)")

        def file(i):
            if i >= len(files):
                raise ValueError(f"OCDBT B-tree node {where}: data file {i} of "
                                 f"{len(files)} (corrupt)")
            return files[i]

        if height == 0:
            keys, _ = _keys(cur, n, False)
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"OCDBT B-tree node {where}: unknown value kind (corrupt)")
            k_ind = sum(kinds)
            vfids, voffs = cur.varints(k_ind), cur.varints(k_ind)
            ind = 0
            for key, vlen, kind in zip(keys, lengths, kinds):
                full = (prefix + key).decode()
                if kind == 0:
                    self._entries[full] = ("inline", cur.take(vlen))
                else:
                    self._entries[full] = ("file", file(vfids[ind]), voffs[ind], vlen)
                    ind += 1
            if cur.pos != len(payload):
                raise ValueError(f"OCDBT B-tree node {where}: {len(payload) - cur.pos} "
                                 "trailing bytes (corrupt)")
            return
        keys, common = _keys(cur, n, True)
        cfids, coffs, clens = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(n), cur.varints(n), cur.varints(n)  # statistics
        for key, c, fid, off, ln in zip(keys, common, cfids, coffs, clens):
            if c > len(key):
                raise ValueError(f"OCDBT B-tree node {where}: subtree prefix out of range")
            self._walk(file(fid), off, ln, height - 1, prefix + key[:c])

    # -- values ------------------------------------------------------------

    def keys(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def value_length(self, key: str) -> int:
        e = self._entry(key)
        return len(e[1]) if e[0] == "inline" else e[3]

    def _entry(self, key: str):
        try:
            return self._entries[key]
        except KeyError:
            raise KeyError(f"OCDBT database {self.root!r} has no key {key!r}") from None

    def read(self, key: str) -> bytes:
        e = self._entry(key)
        self.values_read.add(key)
        if e[0] == "inline":
            return e[1]
        self.opened_files.add(e[1][0] + e[1][1])
        return self._read_file(e[1], e[2], e[3])

    def read_into(self, key: str, out: np.ndarray) -> None:
        """The value of ``key`` straight into the contiguous ``out`` (of
        exactly its size): an indirect value is ``pread`` into it."""
        e = self._entry(key)
        self.values_read.add(key)
        mv = memoryview(out.reshape(-1).view(np.uint8))
        n = self.value_length(key)
        if n != mv.nbytes:
            raise ValueError(f"OCDBT value {key!r} in {self.root!r}: {n} bytes, expected "
                             f"{mv.nbytes} (truncated or corrupt)")
        if e[0] == "inline":
            mv[:] = e[1]
            return
        path = os.path.join(self.root, e[1][0] + e[1][1])
        self.opened_files.add(e[1][0] + e[1][1])
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError as err:
            raise ValueError(f"OCDBT data file {path!r} is missing (deleted, or the "
                             "checkpoint was caught mid-write)") from err
        try:
            done = 0
            while done < n:
                got = os.preadv(fd, [mv[done:]], e[2] + done)
                if got <= 0:
                    raise ValueError(f"OCDBT data file {path!r}: value {key!r} ends after "
                                     f"{done} of {n} bytes (truncated)")
                done += got
        finally:
            os.close(fd)

    def locations(self) -> dict[str, tuple]:
        """key → ("inline", bytes) or ("file", (base, rel), offset, length)."""
        return dict(self._entries)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _leaf_node_bytes(entries: list[tuple[str, tuple]], files: list[tuple[str, str]]) -> bytes:
    """An uncompressed height-0 node of ``entries`` (sorted keys; values
    ("inline", bytes) or ("file", file index, offset, length))."""
    keys = [k.encode() for k, _ in entries]
    out = bytearray(b"\x00")  # height
    out += _file_table_bytes(files)
    out += _varint(len(keys))
    prefixes = [0]
    for prev, k in zip(keys, keys[1:]):
        n = 0
        while n < min(len(k), len(prev)) and k[n] == prev[n]:
            n += 1
        prefixes.append(n)
    for p in prefixes[1:]:
        out += _varint(p)
    for k, p in zip(keys, prefixes):
        out += _varint(len(k) - p)
    for k, p in zip(keys, prefixes):
        out += k[p:]
    for _, v in entries:
        out += _varint(len(v[1]) if v[0] == "inline" else v[3])
    for _, v in entries:
        out += _varint(0 if v[0] == "inline" else 1)
    ind = [v for _, v in entries if v[0] == "file"]
    for v in ind:
        out += _varint(v[1])
    for v in ind:
        out += _varint(v[2])
    for _, v in entries:
        if v[0] == "inline":
            out += v[1]
    node = bytes(out)
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"OCDBT leaf of {len(entries)} keys is {len(node)} bytes, over "
                         f"max_decoded_node_bytes {MAX_DECODED_NODE_BYTES}")
    return _seal_envelope(NODE_MAGIC, node)


def _manifest_bytes(files: list[tuple[str, str]], fid: int, offset: int, length: int,
                    num_keys: int, indirect_bytes: int) -> bytes:
    out = bytearray(uuid.uuid4().bytes)
    out += _varint(0)  # manifest kind: single
    out += _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
    out += bytes([_VERSION_TREE_ARITY_LOG2])
    out += _varint(0)  # compression method: none
    out += _file_table_bytes(files)
    out += _varint(1)  # one version
    out += _varint(1)  # generation 1
    out += bytes([0])  # root height
    out += _varint(fid) + _varint(offset) + _varint(length)
    out += _varint(num_keys) + _varint(length) + _varint(indirect_bytes)
    out += time.time_ns().to_bytes(8, "little")
    out += _varint(0)  # no version tree nodes
    return _seal_envelope(MANIFEST_MAGIC, bytes(out))


def _write_manifest(root: str, data: bytes) -> None:
    tmp = os.path.join(root, _MANIFEST_NAME + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, os.path.join(root, _MANIFEST_NAME))


class OcdbtWriter:
    """One version of one database under ``root``: ``put`` small values
    (kept inline) or large ones (``put_chunks``, streamed into the data
    file ``d/<random hex>``), then ``commit`` appends the leaf node to that
    file and writes the manifest, and returns their bytes."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self._rel = "d/" + uuid.uuid4().hex
        self._data = open(os.path.join(root, self._rel), "wb")
        self._offset = 0
        self._entries: dict[str, tuple] = {}

    def put(self, key: str, value: bytes) -> None:
        if len(value) <= MAX_INLINE_VALUE_BYTES:
            self._entries[key] = ("inline", bytes(value))
        else:
            self.put_chunks(key, len(value), [value])

    def put_chunks(self, key: str, nbytes: int, chunks) -> None:
        """A value of ``nbytes`` written as the buffers ``chunks`` yields
        (a large array streamed without a host copy of the whole)."""
        if nbytes <= MAX_INLINE_VALUE_BYTES:
            value = b"".join(bytes(memoryview(c).cast("B")) for c in chunks)
            if len(value) != nbytes:
                raise ValueError(f"value {key!r}: {len(value)} bytes, {nbytes} announced")
            self._entries[key] = ("inline", value)
            return
        off = self._offset
        for c in chunks:
            self._data.write(c)
            self._offset += memoryview(c).nbytes
        if self._offset - off != nbytes:
            raise ValueError(f"value {key!r}: {self._offset - off} bytes written, "
                             f"{nbytes} announced")
        self._entries[key] = ("file", 0, off, nbytes)

    def commit(self) -> int:
        entries = sorted(self._entries.items())
        node = _leaf_node_bytes(entries, [("", self._rel)])
        node_off = self._offset
        self._data.write(node)
        self._data.close()
        indirect = sum(v[3] for _, v in entries if v[0] == "file")
        man = _manifest_bytes([("", self._rel)], 0, node_off, len(node), len(entries), indirect)
        _write_manifest(self.root, man)
        return len(node) + len(man)

    def abort(self) -> None:
        self._data.close()


def write_root(root: str, parts: list[str]) -> int:
    """The root database of a multi-process save: one leaf with every key
    of the databases ``root/<part>`` (each ``ocdbt.process_<i>``), their
    inline values copied and their indirect values referenced where they
    lie.  A key in two parts raises.  Returns the bytes written."""
    merged: dict[str, tuple] = {}
    files: list[tuple[str, str]] = []
    for part in parts:
        store = OcdbtStore(os.path.join(root, part))
        index: dict[tuple[str, str], int] = {}
        for key, loc in store.locations().items():
            if key in merged:
                raise ValueError(f"key {key!r} written by two processes ({part})")
            if loc[0] == "inline":
                merged[key] = loc
                continue
            ref = (part + "/" + loc[1][0], loc[1][1])
            if ref not in index:
                index[ref] = len(files)
                files.append(ref)
            merged[key] = ("file", index[ref], loc[2], loc[3])
    entries = sorted(merged.items())
    order = sorted(range(len(files)), key=lambda i: files[i][0] + files[i][1])
    renum = {old: new for new, old in enumerate(order)}
    files = [files[i] for i in order]
    entries = [(k, v if v[0] == "inline" else ("file", renum[v[1]], v[2], v[3]))
               for k, v in entries]
    node = _leaf_node_bytes(entries, files)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    rel = "d/" + uuid.uuid4().hex
    with open(os.path.join(root, rel), "wb") as f:
        f.write(node)
    indirect = sum(v[3] for _, v in entries if v[0] == "file")
    man = _manifest_bytes([("", rel)], 0, 0, len(node), len(entries), indirect)
    _write_manifest(root, man)
    return len(node) + len(man)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

# tensorstore's zarr v2 dtype names → numpy (bfloat16 read as its raw uint16 bits)
_DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4"), "<i8": np.dtype("<i8"),
           "bfloat16": np.dtype("<u2")}


def chunk_key(name: str, index: tuple) -> str:
    """The key of chunk ``index`` of array ``name`` (``<name>/0`` for a
    scalar)."""
    return f"{name}/" + (".".join(str(i) for i in index) if index else "0")


def zarray_bytes(shape, chunks, dtype) -> bytes:
    """The ``.zarray`` the port writes: C order, no compressor, no filters."""
    name = {np.dtype("<f4"): "<f4", np.dtype("<i4"): "<i4", np.dtype("<i8"): "<i8"}.get(
        np.dtype(dtype))
    if name is None:
        raise ValueError(f"no zarr v2 dtype for {np.dtype(dtype)}")
    meta = {"chunks": [int(c) for c in chunks], "compressor": None,
            "dimension_separator": ".", "dtype": name, "fill_value": None, "filters": None,
            "order": "C", "shape": [int(s) for s in shape], "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


class ZarrArray:
    """One zarr v2 array of an ``OcdbtStore``: its ``.zarray`` parsed and
    checked; ``read(rows=(lo, hi))`` opens only the chunks that overlap."""

    def __init__(self, store: OcdbtStore, name: str):
        self.store, self.name = store, name
        if f"{name}/zarr.json" in store:
            raise ValueError(f"array {name!r} in {store.root!r} is zarr v3 (zarr.json); "
                             "only zarr v2 (.zarray) is supported")
        key = f"{name}/.zarray"
        if key not in store:
            raise ValueError(f"array {name!r} missing from {store.root!r} (no {key})")
        try:
            meta = json.loads(store.read(key))
        except ValueError as e:
            raise ValueError(f"{key} in {store.root!r} is not JSON: {e}") from e
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{key}: zarr_format {meta.get('zarr_format')!r}, expected 2")
        if meta.get("order", "C") != "C":
            raise ValueError(f"{key}: order {meta.get('order')!r}; only C order is supported")
        if meta.get("filters"):
            raise ValueError(f"{key}: filters {meta['filters']!r} are not supported")
        if meta.get("dtype") not in _DTYPES:
            raise ValueError(f"{key}: dtype {meta.get('dtype')!r} is not supported "
                             f"({', '.join(_DTYPES)})")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{key}: compressor {comp!r} is not supported (none or zstd)")
        sep = meta.get("dimension_separator", ".")
        if sep != ".":
            raise ValueError(f"{key}: dimension_separator {sep!r}; only '.' is supported")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c < 1 for c in self.chunks):
            raise ValueError(f"{key}: chunks {self.chunks} do not fit shape {self.shape}")
        self.dtype_name = meta["dtype"]
        self.dtype = _DTYPES[self.dtype_name]
        self.compressed = comp is not None
        self.fill_value = meta.get("fill_value")

    def _load_chunk(self, idx) -> np.ndarray:
        key = chunk_key(self.name, idx)
        buf = np.empty(self.chunks, self.dtype)
        if key not in self.store:
            raise ValueError(
                f"chunk {key!r} is missing from {self.store.root!r} and the array's "
                f"fill_value is {self.fill_value!r}; refusing to invent its values")
        if not self.compressed:
            self.store.read_into(key, buf)
        else:
            zstd_decompress(self.store.read(key), f"zarr chunk {key!r} in {self.store.root!r}",
                            out=buf)
        return buf

    def read(self, rows: tuple[int, int] | None = None) -> np.ndarray:
        """The array (or rows ``[lo, hi)`` of axis 0) as a numpy array."""
        if not self.shape:
            return self._load_chunk(()).reshape(())
        lo, hi = (0, self.shape[0]) if rows is None else rows
        if not 0 <= lo <= hi <= self.shape[0]:
            raise ValueError(f"rows [{lo}, {hi}) outside {self.name!r} of {self.shape[0]} rows")
        out = np.empty((hi - lo,) + self.shape[1:], self.dtype)
        grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
        grid[0] = range(lo // self.chunks[0], -(-hi // self.chunks[0]))
        for idx in np.ndindex(*[len(g) for g in grid]):
            cidx = tuple(g[i] for g, i in zip(grid, idx))
            starts = [i * c for i, c in zip(cidx, self.chunks)]
            r0, r1 = max(lo, starts[0]), min(hi, starts[0] + self.chunks[0])
            whole = (not self.compressed and r0 == starts[0]
                     and r1 == starts[0] + self.chunks[0]
                     and all(c == s for c, s in zip(self.chunks[1:], self.shape[1:])))
            if whole:
                # A whole uncompressed chunk spanning every column: one pread
                # straight into the destination rows.
                key = chunk_key(self.name, cidx)
                if key not in self.store:
                    self._load_chunk(cidx)  # raises, naming the chunk
                self.store.read_into(key, out[r0 - lo : r1 - lo])
                continue
            chunk = self._load_chunk(cidx)
            src = [slice(r0 - starts[0], r1 - starts[0])]
            dst = [slice(r0 - lo, r1 - lo)]
            for s, c, st in zip(self.shape[1:], self.chunks[1:], starts[1:]):
                e = min(s, st + c)
                src.append(slice(0, e - st))
                dst.append(slice(st, e))
            out[tuple(dst)] = chunk[tuple(src)]
        return out
