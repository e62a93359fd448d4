"""A frozen copy of the orbax checkpoint reader, for the plain reference.

The reference reads the checkpoint directory itself, so that nothing the
program under test made (its weights, tables or layouts) enters the
comparison that decides a run's ``correct``.  This is a copy of the reader
in ``mlic_tpu_torch/utils/checkpoint.py`` as it stood when the benchmark
was written: the OCDBT key-value store (a manifest, a B-tree of nodes,
values inline or in data files) holding zarr v2 arrays whose chunks are
zstd frames, read with the standard library, numpy and the system
``libzstd`` through ``ctypes``.  It imports nothing of the program.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import os
import struct
from typing import Optional

import numpy as np

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE


@functools.cache
def _zstd():
    """The system zstd library through ctypes (loaded on first use)."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("reading an orbax checkpoint needs the system zstd "
                      "library (libzstd), which was not found")
    lib = ctypes.CDLL(name)
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_createDStream.restype = vp
    lib.ZSTD_freeDStream.argtypes = [vp]
    lib.ZSTD_freeDStream.restype = size_t
    lib.ZSTD_initDStream.argtypes = [vp]
    lib.ZSTD_initDStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_ZBuffer),
                                          ctypes.POINTER(_ZBuffer)]
    lib.ZSTD_decompressStream.restype = size_t
    return lib


class _ZBuffer(ctypes.Structure):
    """``ZSTD_inBuffer`` / ``ZSTD_outBuffer``."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _zstd_check(lib, rc: int, what: str) -> int:
    if lib.ZSTD_isError(rc):
        raise ValueError(f"zstd: {what}: "
                         f"{lib.ZSTD_getErrorName(rc).decode()}")
    return rc


def zstd_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """Decode one zstd frame; ``size`` is the decoded size where the caller
    knows it (one call), else the frame is streamed."""
    lib = _zstd()
    src = ctypes.create_string_buffer(data, len(data))
    if size is not None:
        dst = ctypes.create_string_buffer(max(size, 1))
        n = _zstd_check(lib, lib.ZSTD_decompress(dst, size, src, len(data)),
                        "decompress")
        if n != size:
            raise ValueError(f"zstd: {n} bytes decoded, {size} expected")
        return dst.raw[:n]
    stream = lib.ZSTD_createDStream()
    try:
        _zstd_check(lib, lib.ZSTD_initDStream(stream), "init")
        inb = _ZBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        cap = max(4 * len(data), 1 << 16)
        out = []
        while True:
            dst = ctypes.create_string_buffer(cap)
            outb = _ZBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
            left = _zstd_check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(outb), ctypes.byref(inb)), "stream")
            out.append(dst.raw[:outb.pos])
            if left == 0:
                return b"".join(out)
            if inb.pos == inb.size and outb.pos < cap:
                raise ValueError("zstd: truncated frame")
    finally:
        lib.ZSTD_freeDStream(stream)


@functools.cache
def _crc32c_table() -> tuple:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT's manifests and nodes."""
    table = _crc32c_table()
    c = 0xFFFFFFFF
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads OCDBT's integers from a byte string: LEB128 varints, bytes
    and little-endian fixed widths."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("OCDBT: record runs past its end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _envelope(data: bytes, magic: int, what: str) -> _Cursor:
    """Check an OCDBT record (big-endian magic, little-endian total length,
    format version 0, CRC-32C footer) and return a cursor over its body,
    zstd-decoded where the record says so."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"OCDBT: {what} has no valid magic")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"OCDBT: {what} length field disagrees with its "
                         "size")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"OCDBT: {what} fails its checksum")
    head = _Cursor(data[:-4])
    head.pos = 12
    if head.varint() != 0:
        raise ValueError(f"OCDBT: {what} has an unknown format version")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT: {what} has unknown compression "
                         f"{compression}")
    return _Cursor(body)


def _data_file_table(cur: _Cursor, transitive: str) -> list:
    """The data files a record names: [(base path, full path)], both
    relative to the store's root.  Paths share prefixes with the one
    before; ``transitive`` is the base path of the file holding the record,
    which the stored paths are relative to."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        full = prev[:prefix[i]] + cur.take(suffix[i])
        prev = full
        path = full.decode()
        files.append((transitive + path[:base_len[i]], transitive + path))
    return files


def _manifest_kind(cur: _Cursor) -> int:
    """Read the store's config (uuid, manifest kind, inline and node size
    limits, version-tree arity, node compression); returns the manifest
    kind, 0 for a single manifest file."""
    cur.take(16)                                    # uuid
    kind = cur.varint()
    cur.varints(2)                                  # inline, node limits
    cur.u8()                                        # version-tree arity
    compression = cur.varint()
    if compression == 1:
        cur.take(4)                                 # zstd level, int32
    elif compression != 0:
        raise ValueError(f"OCDBT: unknown node compression {compression}")
    return kind


def _latest_root(root_dir: str) -> Optional[tuple]:
    """The B-tree root of the newest version in ``manifest.ocdbt``: (height,
    (base, path), offset, length), or None for an empty store."""
    with open(os.path.join(root_dir, "manifest.ocdbt"), "rb") as f:
        cur = _envelope(f.read(), _MANIFEST_MAGIC, "manifest.ocdbt")
    if _manifest_kind(cur) != 0:
        raise ValueError("OCDBT: numbered manifests are not supported")
    files = _data_file_table(cur, "")
    n = cur.varint()                 # the inline leaf of the version tree
    cur.varints(n)                   # generation numbers
    heights = [cur.u8() for _ in range(n)]
    file_ids, offsets, lengths = cur.varints(n), cur.varints(n), \
        cur.varints(n)
    if n == 0 or lengths[-1] == 0:
        return None
    return heights[-1], files[file_ids[-1]], offsets[-1], lengths[-1]


class _Store:
    """Reads ranges of an OCDBT store's data files, each file once."""

    def __init__(self, root_dir: str):
        self.root = root_dir
        self._files = {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        data = self._files.get(path)
        if data is None:
            with open(os.path.join(self.root, path), "rb") as f:
                data = self._files[path] = f.read()
        if offset + length > len(data):
            raise ValueError(f"OCDBT: {path} is shorter than a reference "
                             "into it")
        return data[offset:offset + length]


def _keys(cur: _Cursor, n: int, extra_prefix_lengths: bool):
    """A node's keys (stored sharing prefixes with the key before), and
    for an interior node each entry's subtree common-prefix length."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if extra_prefix_lengths else None
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + cur.take(suffix[i])
        keys.append(prev)
    return keys, common


def _walk(store: _Store, height: int, file: tuple, offset: int, length: int,
          key_prefix: bytes, out: dict):
    """Collect every (key, value) of the subtree rooted at a node."""
    cur = _envelope(store.read(file[1], offset, length), _NODE_MAGIC,
                    f"B-tree node in {file[1]}")
    if cur.u8() != height:
        raise ValueError("OCDBT: node height disagrees with its reference")
    files = _data_file_table(cur, file[0])
    n = cur.varint()
    if height == 0:
        keys, _ = _keys(cur, n, False)
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        ref_files = cur.varints(len(indirect))
        ref_offsets = cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(ref_files, ref_offsets)))
        for i, key in enumerate(keys):
            if kinds[i] == 0:
                value = cur.take(lengths[i])
            elif kinds[i] == 1:
                fid, off = refs[i]
                value = store.read(files[fid][1], off, lengths[i])
            else:
                raise ValueError(f"OCDBT: unknown value kind {kinds[i]}")
            out[key_prefix + key] = value
        return
    keys, common = _keys(cur, n, True)
    child_files = cur.varints(n)
    child_offsets, child_lengths = cur.varints(n), cur.varints(n)
    for i, key in enumerate(keys):
        _walk(store, height - 1, files[child_files[i]], child_offsets[i],
              child_lengths[i], key_prefix + key[:common[i]], out)


def read_ocdbt(root_dir: str) -> dict:
    """Every key of the newest version of an OCDBT store -> its value."""
    root = _latest_root(root_dir)
    out = {}
    if root is not None:
        _walk(_Store(root_dir), *root, b"", out)
    return out


def _zarr_dtype(name: str):
    """(stored numpy dtype, returned numpy dtype) of a zarr v2 dtype;
    bfloat16 is stored as 16-bit words and returned widened to f32,
    exactly."""
    if name == "bfloat16":
        return np.dtype("<u2"), np.dtype(np.float32)
    dt = np.dtype(name)
    return dt, dt


def _zarr_array(meta: dict, chunks: dict) -> np.ndarray:
    """Assemble a zarr v2 array from its ``.zarray`` and its chunk values,
    keyed by chunk name (``"0.1"``); missing chunks hold the fill value."""
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"unsupported zarr array {meta}")
    stored, out_dt = _zarr_dtype(meta["dtype"])
    shape, chunk_shape = tuple(meta["shape"]), tuple(meta["chunks"])
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"unsupported zarr compressor {compressor}")
    fill = meta.get("fill_value")
    arr = np.full(shape, 0 if fill is None else fill, stored)
    sep = meta.get("dimension_separator", ".")
    n_bytes = int(np.prod(chunk_shape, dtype=np.int64)) * stored.itemsize
    for name, value in chunks.items():
        raw = value if compressor is None else zstd_decompress(value, n_bytes)
        chunk = np.frombuffer(raw, stored).reshape(
            chunk_shape, order=meta.get("order", "C"))
        idx = [int(i) for i in name.split(sep)] if shape else []
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunk_shape, shape))
        arr[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta["dtype"] == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(out_dt, copy=False)


def orbax_arrays(path: str) -> dict:
    """An orbax checkpoint directory -> {"params.g_a...": (the array's
    ``.zarray`` metadata, {chunk name: stored chunk})}."""
    arrays = {}
    for key, value in read_ocdbt(path).items():
        name, _, leaf = key.decode().rpartition("/")
        entry = arrays.setdefault(name, [None, {}])
        if leaf == ".zarray":
            entry[0] = json.loads(value)
        else:
            entry[1][leaf] = value
    missing = [k for k, (meta, _) in arrays.items() if meta is None]
    if missing:
        raise ValueError(f"orbax: arrays without .zarray: {missing[:5]}")
    return {k: tuple(v) for k, v in arrays.items()}


def _tree_keys(path: str, names) -> dict:
    """Each array's path in the saved tree: [(key, is_sequence index)],
    from orbax's ``_METADATA`` where the directory has one (keys may hold
    dots there, and tuple or list levels are marked), else the array's name
    split at its dots, every level a dict."""
    meta_file = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_file):
        return {n: [(k, False) for k in n.split(".")] for n in names}
    with open(meta_file) as f:
        entries = json.load(f)["tree_metadata"].values()
    keys = {}
    for entry in entries:
        km = entry["key_metadata"]
        keys[".".join(str(k["key"]) for k in km)] = [
            (str(k["key"]), k["key_type"] == 1) for k in km]
    return keys


_SEQUENCE = object()


def _as_lists(node):
    """Turn the levels marked as sequences into lists, in index order."""
    if not isinstance(node, dict):
        return node
    items = {k: _as_lists(v) for k, v in node.items() if k is not _SEQUENCE}
    if node.get(_SEQUENCE):
        return [items[k] for k in sorted(items, key=int)]
    return items


def read_orbax(path: str) -> dict:
    """An orbax checkpoint directory (OCDBT, zarr v2) -> the nested tree of
    numpy arrays that orbax's restore gives (``{"params": {"g_a": ...}}``,
    lists where the saved tree had tuples or lists), with bfloat16 arrays
    widened exactly to f32."""
    arrays = orbax_arrays(path)
    keys = _tree_keys(path, arrays)
    tree = {}
    for name, (meta, chunks) in arrays.items():
        node = tree
        *parents, (leaf, in_sequence) = keys[name]
        for key, sequence in parents:
            if sequence:
                node[_SEQUENCE] = True
            node = node.setdefault(key, {})
        if in_sequence:
            node[_SEQUENCE] = True
        node[leaf] = _zarr_array(meta, chunks)
    return _as_lists(tree)
