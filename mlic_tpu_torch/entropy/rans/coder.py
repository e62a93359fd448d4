"""The host rANS coder of the ``steps`` and ``fused`` codec backends (the
port's own copy of ``mlic_tpu/entropy/rans/coder.py:93-613``, its
single-stream part).

One compressai-style stream per image: ``encode_with_indexes`` codes int32
symbols, each through the CDF row its index names, and ``RansDecoder``
decodes them back, a phase at a time (``set_stream`` once, then
``decode_stream`` per phase), as the reference's ``BufferedRansEncoder`` /
``RansDecoder`` (``MLIC++/models/mlicpp.py:215,279-280,306-307``).

``encode_interleaved``, ``parse_interleaved`` and ``decode_interleaved``
(``coder.py:271-380``) code the interleaved format v2, per-lane word
blocks, with ``rans.cpp``'s lane coder: the bytes are the JAX host
coder's, and the device encode's (``device_rans.encode_interleaved_device``)
equal them.

``encode_global`` and ``decode_global`` (``coder.py:417-520``) code the
interleaved format v3 of the device backend on the host, in numpy
vectorised over the lanes: the tests' and the smoke's oracle of the
device coder's v3 bytes (the port has no host encode of v3: the device
writes the same bytes).

The coder is ``rans.cpp`` beside this file, compiled by ``g++`` at first
use into ``build/host/`` at the repository root, the library named by a
hash of its source and flags.  The build is safe across processes: a
process takes an ``fcntl`` lock on the library's lock file, compiles into a
temporary file of its own and renames it into place, so a reader sees
either no library or a whole one.  A failed build raises: nothing codes
quietly with another coder.  Nothing is built when this module is imported.

``numpy_encode`` and ``NumpyDecoder`` state the same stream format in
Python; they are the plain version the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from mlic_tpu_torch.entropy.stream import (
    _V3_FLAG,
    parse_global,
    parse_interleaved,
)

SOURCE = Path(__file__).resolve().with_name("rans.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

PROB_BITS = 16
_RANS_L = 1 << 31
_BYPASS_BITS = 5
_BYPASS_FREQ = 1 << (PROB_BITS - _BYPASS_BITS)
_MASK16 = (1 << PROB_BITS) - 1

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librans-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``rans.cpp`` unless its library exists; returns its path.
    Holds the library's ``fcntl`` lock while it checks and builds, so
    processes that start together build it once; raises if ``g++``
    fails."""
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                out = subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
                if out.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed to build {SOURCE.name}:"
                                       f"\n{out.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _native():
    """The loaded library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.mlic_rans_encode.restype = ctypes.c_int64
            lib.mlic_rans_encode.argtypes = [
                i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i32p,
                u8p, ctypes.c_int64]
            lib.mlic_rans_decoder_new.restype = ctypes.c_void_p
            lib.mlic_rans_decoder_new.argtypes = [u8p, ctypes.c_int64]
            lib.mlic_rans_decoder_free.restype = None
            lib.mlic_rans_decoder_free.argtypes = [ctypes.c_void_p]
            lib.mlic_rans_decode.restype = ctypes.c_int32
            lib.mlic_rans_decode.argtypes = [
                ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                i32p, i32p, i32p]
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i64 = ctypes.c_int64
            lib.mlic_rans16_encode_interleaved.restype = i64
            lib.mlic_rans16_encode_interleaved.argtypes = [
                i32p, i32p, i64, ctypes.c_int32, i32p, i64, i32p, i32p, u16p,
                i64, i64p, i64p, i32p, i64, i64p]
            lib.mlic_rans16_decode_interleaved.restype = ctypes.c_int32
            lib.mlic_rans16_decode_interleaved.argtypes = [
                u16p, i64, i64p, ctypes.c_int32, i32p, i64, i32p, i64, i32p,
                i32p, i32p, i64, i32p]
            _lib = lib
    return _lib


def rans_backend() -> str:
    """``"native"``: the library, built if it was not (a failed build
    raises; there is no other backend)."""
    _native()
    return "native"


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _tables(indexes, cdfs, cdf_lengths, offsets):
    """int32 copies of the tables, checked so that the C code reads only
    rows that exist."""
    indexes = _as_i32(indexes).ravel()
    cdfs = _as_i32(cdfs)
    cdf_lengths = _as_i32(cdf_lengths).ravel()
    offsets = _as_i32(offsets).ravel()
    if cdfs.ndim != 2:
        raise ValueError("cdfs must be 2-D [n_ctx, max_len]")
    n_ctx = cdfs.shape[0]
    if len(cdf_lengths) != n_ctx or len(offsets) != n_ctx:
        raise ValueError("cdf_lengths and offsets need one entry a row")
    if n_ctx and (cdf_lengths.min() < 3 or cdf_lengths.max() > cdfs.shape[1]):
        raise ValueError("cdf_lengths outside [3, cdfs.shape[1]]")
    if len(indexes) and (indexes.min() < 0 or indexes.max() >= n_ctx):
        raise ValueError(f"indexes outside [0, {n_ctx})")
    return indexes, cdfs, cdf_lengths, offsets


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                        offsets) -> bytes:
    """Code int32 ``symbols``, symbol k through row ``indexes[k]`` of
    ``cdfs`` (valid up to ``cdf_lengths``, value ``symbol - offset``;
    values outside the row take the escape slot and bypass digits), into
    one stream."""
    symbols = _as_i32(symbols).ravel()
    indexes, cdfs, cdf_lengths, offsets = _tables(indexes, cdfs,
                                                  cdf_lengths, offsets)
    if len(symbols) != len(indexes):
        raise ValueError("one index a symbol")
    lib = _native()
    n = len(symbols)
    capacity = 16 * max(n, 1) + 64
    while True:
        out = np.empty(capacity, dtype=np.uint8)
        written = lib.mlic_rans_encode(
            _i32p(symbols), _i32p(indexes), n, _i32p(cdfs), cdfs.shape[1],
            _i32p(cdf_lengths), _i32p(offsets),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity)
        if written >= 0:
            return out[:written].tobytes()
        capacity *= 4


def decode_with_indexes(stream: bytes, indexes, cdfs, cdf_lengths,
                        offsets) -> np.ndarray:
    """One-shot decode of ``len(indexes)`` symbols from ``stream``."""
    dec = RansDecoder()
    try:
        dec.set_stream(stream)
        return dec.decode_stream(indexes, cdfs, cdf_lengths, offsets)
    finally:
        dec.close()


class BufferedRansEncoder:
    """Collects (symbols, indexes) chunks and codes them all at ``flush``,
    in the order they came (the reference's buffering of every slice of a
    latent into one stream)."""

    def __init__(self):
        self._symbols: list = []
        self._indexes: list = []

    def encode_with_indexes(self, symbols, indexes) -> None:
        self._symbols.append(_as_i32(symbols).ravel())
        self._indexes.append(_as_i32(indexes).ravel())

    def flush(self, cdfs, cdf_lengths, offsets) -> bytes:
        empty = np.empty(0, np.int32)
        symbols = np.concatenate(self._symbols) if self._symbols else empty
        indexes = np.concatenate(self._indexes) if self._indexes else empty
        self._symbols, self._indexes = [], []
        return encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                                   offsets)


class RansDecoder:
    """Streaming decoder: ``set_stream`` once, ``decode_stream``
    repeatedly; holds a C decoder until ``close``."""

    def __init__(self):
        self._handle = None
        self._buf = None

    def set_stream(self, stream: bytes) -> None:
        self.close()
        lib = _native()
        buf = np.frombuffer(stream, dtype=np.uint8)
        self._buf = buf if len(buf) else np.zeros(8, np.uint8)
        self._handle = lib.mlic_rans_decoder_new(
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(self._buf))

    def decode_stream(self, indexes, cdfs, cdf_lengths,
                      offsets) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("set_stream() must be called first")
        indexes, cdfs, cdf_lengths, offsets = _tables(indexes, cdfs,
                                                      cdf_lengths, offsets)
        out = np.empty(len(indexes), dtype=np.int32)
        rc = _lib.mlic_rans_decode(
            ctypes.c_void_p(self._handle), _i32p(indexes), len(indexes),
            _i32p(cdfs), cdfs.shape[1], _i32p(cdf_lengths), _i32p(offsets),
            _i32p(out))
        if rc != 0:
            raise RuntimeError(f"rANS decode failed with code {rc}")
        return out

    def close(self) -> None:
        if self._handle is not None:
            _lib.mlic_rans_decoder_free(ctypes.c_void_p(self._handle))
            self._handle = None
        self._buf = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# The plain version: the same stream format in Python (tests only)
# ---------------------------------------------------------------------------
class _NumpyEncoder:
    def __init__(self):
        self.x = _RANS_L
        self.words: list[int] = []

    def put(self, start: int, freq: int):
        x = self.x
        x_max = ((_RANS_L >> PROB_BITS) << 32) * freq
        while x >= x_max:
            self.words.append(x & 0xFFFFFFFF)
            x >>= 32
        self.x = ((x // freq) << PROB_BITS) + (x % freq) + start

    def put_escape_payload(self, value: int, max_value: int):
        u = -2 * value - 1 if value < 0 else 2 * (value - max_value)
        digits = []
        while True:
            digits.append(u & 0xF)
            u >>= 4
            if u == 0:
                break
        for i in range(len(digits) - 1, -1, -1):
            s5 = digits[i] | (0x10 if i + 1 < len(digits) else 0)
            self.put(s5 << (PROB_BITS - _BYPASS_BITS), _BYPASS_FREQ)

    def flush(self) -> bytes:
        words = [self.x & 0xFFFFFFFF, (self.x >> 32) & 0xFFFFFFFF] \
            + self.words[::-1]
        return np.asarray(words, dtype=np.uint32).tobytes()


class NumpyDecoder:
    """The plain decoder of one stream (``decode`` as ``decode_stream``)."""

    def __init__(self, stream: bytes):
        self.words = np.frombuffer(stream[: len(stream) // 4 * 4],
                                   dtype=np.uint32)
        lo = int(self.words[0]) if len(self.words) > 0 else 0
        hi = int(self.words[1]) if len(self.words) > 1 else 0
        self.pos = min(2, len(self.words))
        self.x = (hi << 32) | lo

    def _renorm(self):
        while self.x < _RANS_L and self.pos < len(self.words):
            self.x = (self.x << 32) | int(self.words[self.pos])
            self.pos += 1

    def advance(self, start: int, freq: int):
        cf = self.x & _MASK16
        self.x = freq * (self.x >> PROB_BITS) + cf - start
        self._renorm()

    def get_escape_payload(self, max_value: int) -> int:
        u = shift = 0
        while True:
            s5 = (self.x & _MASK16) >> (PROB_BITS - _BYPASS_BITS)
            self.advance(s5 << (PROB_BITS - _BYPASS_BITS), _BYPASS_FREQ)
            u |= (s5 & 0xF) << shift
            shift += 4
            if not (s5 & 0x10):
                break
        if u & 1:
            return -((u + 1) >> 1)
        return (u >> 1) + max_value

    def decode(self, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
        indexes = _as_i32(indexes).ravel()
        out = np.empty(len(indexes), dtype=np.int32)
        for k, i in enumerate(indexes):
            row = cdfs[i]
            length = int(cdf_lengths[i])
            max_value = length - 2
            cf = self.x & _MASK16
            slot = int(np.searchsorted(row[:length], cf, side="right")) - 1
            self.advance(int(row[slot]), int(row[slot + 1] - row[slot]))
            value = (self.get_escape_payload(max_value) if slot == max_value
                     else slot)
            out[k] = value + int(offsets[i])
        return out


def numpy_encode(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    """The plain encoder: ``encode_with_indexes`` in Python."""
    symbols = _as_i32(symbols).ravel()
    indexes = _as_i32(indexes).ravel()
    enc = _NumpyEncoder()
    for k in range(len(symbols) - 1, -1, -1):
        i = int(indexes[k])
        row = cdfs[i]
        max_value = int(cdf_lengths[i]) - 2
        value = int(symbols[k]) - int(offsets[i])
        if 0 <= value < max_value:
            slot = value
        else:
            enc.put_escape_payload(value, max_value)
            slot = max_value
        enc.put(int(row[slot]), int(row[slot + 1] - row[slot]))
    return enc.flush()


# ---------------------------------------------------------------------------
# Format v2 on the host: L lockstep rans16 lanes, a word block a lane
# ---------------------------------------------------------------------------
def _u16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def encode_interleaved(symbols, indexes, n_lanes: int, cdfs, cdf_lengths,
                       offsets) -> bytes:
    """Format-v2 encode (``coder.py:271``): position p in lane p % n_lanes
    (any count of symbols, fewer than the lanes included), a value outside
    its row's support coded as the escape slot with its raw value in the
    int32 side channel, in position order.  Returns the stream
    ``parse_interleaved`` reads (layout in ``entropy/stream.py``)."""
    symbols = _as_i32(symbols).ravel()
    indexes, cdfs, cdf_lengths, offsets = _tables(indexes, cdfs,
                                                  cdf_lengths, offsets)
    if len(symbols) != len(indexes) or n_lanes < 1:
        raise ValueError("one index a symbol, and at least one lane")
    lib = _native()
    n = len(symbols)
    cap = 8 * max(n, n_lanes) + 4 * n_lanes + 64
    esc = np.empty(max(n, 16), dtype=np.int32)
    n_esc = np.zeros(1, dtype=np.int64)
    begin = np.empty(n_lanes, dtype=np.int64)
    end = np.empty(n_lanes, dtype=np.int64)
    while True:
        words = np.empty(cap, dtype=np.uint16)
        total = lib.mlic_rans16_encode_interleaved(
            _i32p(symbols), _i32p(indexes), n, n_lanes, _i32p(cdfs),
            cdfs.shape[1], _i32p(cdf_lengths), _i32p(offsets), _u16p(words),
            cap, _i64p(begin), _i64p(end), _i32p(esc), len(esc),
            _i64p(n_esc))
        if total >= 0:
            break
        cap *= 4
    e = int(n_esc[0])
    header = np.asarray([n_lanes, total, e], dtype=np.uint32).tobytes()
    body = begin.astype(np.uint32).tobytes() + words[:total].tobytes()
    if len(body) % 4:
        body += b"\x00\x00"
    return header + body + esc[:e].tobytes()


def decode_interleaved(stream: bytes, indexes, cdfs, cdf_lengths,
                       offsets) -> np.ndarray:
    """Format-v2 decode of ``len(indexes)`` symbols on the host
    (``coder.py:351``): the oracle of the device decode.  Raises for a
    stream whose words or escapes run out."""
    words, begin, esc = parse_interleaved(stream)
    words = np.ascontiguousarray(words)
    begin = np.ascontiguousarray(begin)
    esc = np.ascontiguousarray(esc)
    indexes, cdfs, cdf_lengths, offsets = _tables(indexes, cdfs,
                                                  cdf_lengths, offsets)
    out = np.empty(len(indexes), dtype=np.int32)
    rc = _native().mlic_rans16_decode_interleaved(
        _u16p(words), len(words), _i64p(begin), len(begin), _i32p(indexes),
        len(indexes), _i32p(cdfs), cdfs.shape[1], _i32p(cdf_lengths),
        _i32p(offsets), _i32p(esc), len(esc), _i32p(out))
    if rc != 0:
        raise RuntimeError(f"interleaved decode failed: {rc}")
    return out


# ---------------------------------------------------------------------------
# Format v3 on the host: L lockstep rans16 lanes, global emission order
# ---------------------------------------------------------------------------
_RANS16_L = 1 << 16


def encode_global(symbols, indexes, n_lanes: int, cdfs, cdf_lengths,
                  offsets) -> bytes:
    """Format-v3 encode of one image (``coder.py:417``): ``symbols`` and
    their rows ``indexes`` in position order (step-major, lane-minor), a
    multiple of ``n_lanes`` long (callers pad each phase with pad-row
    symbols).  A value outside its row's support advances its lane with
    the escape slot and travels in the int32 side channel, in position
    order.  Returns the stream ``entropy.stream.parse_global`` reads."""
    symbols = _as_i32(symbols).ravel()
    indexes = _as_i32(indexes).ravel()
    cdfs = _as_i32(cdfs)
    cdf_lengths = _as_i32(cdf_lengths).ravel()
    offsets = _as_i32(offsets).ravel()
    n = len(symbols)
    if n % n_lanes or len(indexes) != n:
        raise ValueError("encode_global: one index a symbol, a multiple of "
                         "n_lanes of them")
    S = n // n_lanes
    sym = symbols.reshape(S, n_lanes)
    row = indexes.reshape(S, n_lanes)
    mv = cdf_lengths[row] - 2
    v = sym - offsets[row]
    esc = (v < 0) | (v >= mv)
    slot = np.where(esc, mv, v)
    start = cdfs[row, slot].astype(np.uint64)
    freq = cdfs[row, slot + 1].astype(np.uint64) - start
    x = np.full(n_lanes, _RANS16_L, np.uint64)
    emits = np.zeros((S, n_lanes), bool)
    words = np.zeros((S, n_lanes), np.uint16)
    for s in range(S - 1, -1, -1):          # rANS is LIFO: encode in reverse
        fr, st = freq[s], start[s]
        emit = x >= (fr << np.uint64(16))
        words[s] = (x & np.uint64(_MASK16)).astype(np.uint16)
        x = np.where(emit, x >> np.uint64(16), x)
        x = ((x // fr) << np.uint64(PROB_BITS)) + (x % fr) + st
        emits[s] = emit
    states = np.empty(2 * n_lanes, np.uint16)
    states[0::2] = (x >> np.uint64(16)).astype(np.uint16)
    states[1::2] = (x & np.uint64(_MASK16)).astype(np.uint16)
    allw = np.concatenate([states, words[emits]])   # (step, lane) order
    esc_vals = sym[esc].astype(np.int32)
    header = np.asarray([np.uint32(n_lanes) | _V3_FLAG, len(allw),
                         len(esc_vals)], dtype=np.uint32).tobytes()
    body = allw.tobytes()
    if len(body) % 4:
        body += b"\x00\x00"
    return header + body + esc_vals.tobytes()


def decode_global(stream: bytes, indexes, cdfs, cdf_lengths,
                  offsets) -> np.ndarray:
    """Format-v3 (or v4) decode of ``len(indexes)`` symbols of one stream
    (``coder.py:482``), at rows ``indexes`` in position order: a bisection
    over each lane's integer row, then the lanes whose state fell below
    2^16 read one word each, in lane order.  Returns int32 symbols."""
    n_lanes, words, esc_vals = parse_global(stream)
    indexes = _as_i32(indexes).ravel()
    cdfs = _as_i32(cdfs).astype(np.int64)
    cdf_lengths = _as_i32(cdf_lengths).ravel()
    offsets = _as_i32(offsets).ravel()
    if len(indexes) % n_lanes:
        raise ValueError("decode_global: a multiple of n_lanes indexes")
    S = len(indexes) // n_lanes
    row = indexes.reshape(S, n_lanes)
    w = words.astype(np.int64)
    x = (w[0:2 * n_lanes:2] << 16) | w[1:2 * n_lanes:2]
    ptr = 2 * n_lanes
    out = np.empty((S, n_lanes), np.int64)
    esc = np.zeros((S, n_lanes), bool)
    for s in range(S):
        r = row[s]
        cf = x & _MASK16
        lo = np.zeros(n_lanes, np.int64)
        hi = cdf_lengths[r].astype(np.int64) - 1     # cdf[hi] = 2^16 > cf
        while np.any(hi - lo > 1):
            mid = (lo + hi) >> 1
            take = cdfs[r, mid] <= cf
            lo = np.where(take, mid, lo)
            hi = np.where(take, hi, mid)
        start = cdfs[r, lo]
        x = (cdfs[r, lo + 1] - start) * (x >> 16) + cf - start
        need = x < _RANS16_L
        pos = np.minimum(ptr + np.cumsum(need) - need, len(w) - 1)
        x = np.where(need, (x << 16) | w[pos], x)
        ptr += int(need.sum())
        esc[s] = lo == cdf_lengths[r] - 2
        out[s] = lo + offsets[r]
    out[esc] = esc_vals[:int(esc.sum())]
    return out.reshape(-1).astype(np.int32)
