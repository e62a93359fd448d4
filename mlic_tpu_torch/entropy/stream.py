"""The format-v3/v4 stream container (the port's own copy of
``mlic_tpu/entropy/rans/coder.py:375-479`` and of the per-image assembly in
``mlic_tpu/codec.py:709-765``).

Byte layout, little-endian: uint32 (n_lanes | flags) | uint32 n_words |
uint32 n_escapes | uint16 words[n_words] | pad to 4 B | int32
esc_values[n_escapes].  ``words`` = 2*n_lanes state words ([hi, lo] per
lane) then the renorm words in (step-major, lane-minor) consumption order.
Bit 31 marks the global emission order (v3); bit 30 additionally marks
format v4, whose leading phases code the hyper-latent z inline.

A y stream of the host-coded backends has no header: its first 4 bytes
are the low word of a rans64 state, so bit 31 is set about half the time.
The flag alone cannot tell such a stream from v3; ``stream_is_global``
also asks for a plausible lane count and that the stream's length be
exactly what its header says.  ``stream_is_damaged_global`` finds a v3 or
v4 stream that was cut or padded: its header parses and declares a length
within a factor of two of the stream's, but not the stream's.  A random
header declares gigabytes, so a host-coded stream of n bytes passes
either test by chance with a probability under 2^-27 (n / 2^32)^2.
"""

from __future__ import annotations

import numpy as np
import torch

_V3_FLAG = np.uint32(1 << 31)
_V4_FLAG = np.uint32(1 << 30)
MAX_LANES = 4096


def stream_lanes(stream: bytes) -> int:
    """Lane count from the header; raises ``ValueError`` unless it is a
    power of two in [1, 4096]."""
    if len(stream) < 4:
        raise ValueError(
            f"stream too short for a lane-count header ({len(stream)} B)")
    head = int(np.frombuffer(stream[:4], dtype=np.uint32)[0])
    lanes = head & ~int(_V3_FLAG | _V4_FLAG)
    if not 1 <= lanes <= MAX_LANES or lanes & (lanes - 1):
        raise ValueError(f"implausible lane count {lanes} in stream header")
    return lanes


def stream_is_unified(stream: bytes) -> bool:
    """True if the stream is format v4 (hyper-latent coded inline)."""
    if len(stream) < 4:
        return False
    return bool(np.frombuffer(stream[:4], dtype=np.uint32)[0] & _V4_FLAG)


def global_length(n_words: int, n_esc: int) -> int:
    """Bytes of a v3/v4 stream of ``n_words`` words and ``n_esc`` escapes:
    the 12-byte header, the words padded to 4 B, the escapes."""
    return 12 + 2 * n_words + 2 * (n_words % 2) + 4 * n_esc


def _declared_length(stream: bytes) -> int | None:
    """The length a v3/v4 header declares: None unless the stream holds a
    header with bit 31, a power-of-two lane count in [1, 4096] and at
    least the lanes' 2 * n_lanes state words."""
    if len(stream) < 12:
        return None
    head = np.frombuffer(stream[:12], dtype=np.uint32)
    lanes = int(head[0] & ~(_V3_FLAG | _V4_FLAG))
    if not head[0] & _V3_FLAG or not 1 <= lanes <= MAX_LANES \
            or lanes & (lanes - 1) or int(head[1]) < 2 * lanes:
        return None
    return global_length(int(head[1]), int(head[2]))


def stream_is_global(stream: bytes) -> bool:
    """True if ``stream`` reads as format v3 or v4: its header parses
    (bit 31, a plausible lane count, the state words) and its length is
    exactly the header's ``global_length``."""
    return _declared_length(stream) == len(stream)


def stream_is_damaged_global(stream: bytes) -> bool:
    """True if ``stream``'s header parses as v3/v4 and declares a length
    within a factor of two of the stream's but not equal to it: a v3 or
    v4 stream cut short or padded."""
    n = _declared_length(stream)
    return n is not None and n != len(stream) \
        and len(stream) <= 2 * n <= 4 * len(stream)


def parse_global(stream: bytes):
    """-> (n_lanes, words uint16 [n_words], esc_values int32 [n_escapes])."""
    head = np.frombuffer(stream[:12], dtype=np.uint32)
    if len(head) < 3 or not head[0] & _V3_FLAG:
        raise ValueError("not a format-v3/v4 stream")
    n_lanes = int(head[0] & ~(_V3_FLAG | _V4_FLAG))
    n_words, n_esc = int(head[1]), int(head[2])
    off = 12
    words = np.frombuffer(stream[off:off + 2 * n_words], dtype=np.uint16)
    off += 2 * n_words
    if off % 4:
        off += 2
    esc = np.frombuffer(stream[off:off + 4 * n_esc], dtype=np.int32)
    if len(words) != n_words or len(esc) != n_esc:
        raise ValueError("truncated stream")
    return n_lanes, words, esc


def assemble_streams(comp: dict, n_lanes: int) -> list:
    """Per-image format-v4 streams from the rANS encode's device arrays
    (``device_rans.rans_encode_compact``): one copy of the counts, then one
    of the used word prefix and one of the used escape prefix."""
    counts = torch.cat([comp["img_n"], comp["ecount"]]).cpu().numpy()
    img_n, ecount = np.split(counts.astype(np.int64), 2)
    buf = comp["buf"][:int(img_n.sum())].cpu().numpy().view(np.uint16)
    ebuf = comp["ebuf"][:int(ecount.sum())].cpu().numpy()
    return pack_streams(img_n, ecount, buf, ebuf, n_lanes)


def pack_streams(img_n, ecount, buf: np.ndarray, ebuf: np.ndarray,
                 n_lanes: int, v4: bool = True) -> list:
    """Per-image streams from host arrays: each image's word count and
    escape count, all images' words (uint16, image after image) and
    escapes (int32).  Format v4 sets bits 31 and 30 of the first word, v3
    bit 31 only."""
    flags = _V3_FLAG | (_V4_FLAG if v4 else np.uint32(0))
    wb = np.concatenate([[0], np.cumsum(img_n)])
    eb = np.concatenate([[0], np.cumsum(ecount)])
    ebuf = ebuf.astype(np.int32)
    streams = []
    for b in range(len(img_n)):
        header = np.asarray([np.uint32(n_lanes) | flags, img_n[b], ecount[b]],
                            np.uint32).tobytes()
        body = buf[wb[b]:wb[b + 1]].tobytes()
        if len(body) % 4:
            body += b"\x00\x00"
        streams.append(header + body + ebuf[eb[b]:eb[b + 1]].tobytes())
    return streams
