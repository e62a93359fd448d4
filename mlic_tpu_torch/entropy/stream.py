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


# --------------------------------------------------------------------------
# Format v2: per-lane word blocks (coder.py:271-316)
#
# Byte layout, little-endian: uint32 n_lanes | uint32 n_words | uint32
# n_escapes | uint32 lane_begin[n_lanes] | uint16 words[n_words] | pad to
# 4 B | int32 esc_values[n_escapes].  Lane l's words are [lane_begin[l],
# next lane's begin): its state [hi, lo], then its renorm words in decode
# order.  No flag bit: bit 31 of n_lanes is clear.
# --------------------------------------------------------------------------
def parse_interleaved(stream: bytes):
    """-> (words uint16 [n_words], lane_begin int64 [n_lanes], esc_values
    int32 [n_escapes])."""
    head = np.frombuffer(stream[:12], dtype=np.uint32)
    if len(head) < 3 or head[0] & _V3_FLAG:
        raise ValueError("not a format-v2 stream")
    n_lanes, n_words, n_esc = int(head[0]), int(head[1]), int(head[2])
    off = 12 + 4 * n_lanes
    begin = np.frombuffer(stream[12:off], dtype=np.uint32).astype(np.int64)
    words = np.frombuffer(stream[off:off + 2 * n_words], dtype=np.uint16)
    off += 2 * n_words
    if off % 4:
        off += 2
    esc = np.frombuffer(stream[off:off + 4 * n_esc], dtype=np.int32)
    if len(begin) != n_lanes or len(words) != n_words or len(esc) != n_esc:
        raise ValueError("truncated stream")
    return words, begin, esc


def pack_lane_streams(lane_begin, lane_n, ecount, buf: np.ndarray,
                      ebuf: np.ndarray, n_lanes: int) -> list:
    """Per-image format-v2 streams from host arrays: every lane's begin and
    word count (lanes image after image), each image's escape count, all
    lanes' words (uint16) and all images' escapes (int32)."""
    lane_begin = np.asarray(lane_begin, np.int64)
    lane_n = np.asarray(lane_n, np.int64)
    eb = np.concatenate([[0], np.cumsum(ecount)]).astype(np.int64)
    ebuf = np.asarray(ebuf, np.int32)
    streams = []
    for b in range(len(ecount)):
        lo, hi = b * n_lanes, (b + 1) * n_lanes
        w0 = int(lane_begin[lo])
        w1 = int(lane_begin[hi - 1] + lane_n[hi - 1])
        header = np.asarray([n_lanes, w1 - w0, int(ecount[b])],
                            np.uint32).tobytes()
        body = (lane_begin[lo:hi] - w0).astype(np.uint32).tobytes() \
            + buf[w0:w1].tobytes()
        if len(body) % 4:
            body += b"\x00\x00"
        streams.append(header + body + ebuf[eb[b]:eb[b + 1]].tobytes())
    return streams


def assemble_lane_streams(comp: dict, n_lanes: int) -> list:
    """Per-image format-v2 streams from the device arrays of
    ``device_rans.compact_streams`` (as ``Codec``'s download does for v4:
    the counts, then the used prefixes)."""
    lane_begin = comp["lane_begin"].cpu().numpy()
    lane_n = comp["lane_n"].cpu().numpy()
    ecount = comp["ecount"].cpu().numpy()
    n_w = int(lane_begin[-1] + lane_n[-1])
    buf = comp["buf"][:n_w].cpu().numpy().view(np.uint16)
    ebuf = comp["ebuf"][:int(ecount.sum())].cpu().numpy()
    return pack_lane_streams(lane_begin, lane_n, ecount, buf, ebuf, n_lanes)


def lane_decode_inputs(streams, device) -> dict:
    """Format-v2 streams -> the decoder's device inputs: all words, each
    lane's begin offset into them, the escapes and each image's first."""
    words, begins, escs, esc_begin = [], [], [], []
    n_w = n_e = 0
    for s in streams:
        w, b, e = parse_interleaved(s)
        words.append(w)
        begins.append(b + n_w)
        escs.append(e)
        esc_begin.append(n_e)
        n_w, n_e = n_w + len(w), n_e + len(e)

    def dev(a, dt):
        return torch.as_tensor(np.asarray(a, dt)).to(device)

    return {"words": dev(np.concatenate(words).view(np.int16), np.int16),
            "lane_begin": dev(np.concatenate(begins), np.int32),
            "esc": dev(np.concatenate(escs) if n_e else np.zeros(1),
                       np.int32),
            "esc_begin": dev(esc_begin, np.int32)}
