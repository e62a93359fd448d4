"""On-disk bitstream container: the port's own copy of
``mlic_tpu/utils/bitstream.py`` (pure Python), so that both packages write
byte-identical files and read each other's.

Big-endian unsigned ints; body = (shape_h, shape_w, n_strings,
[len, bytes]...); the file header, written by the caller, = (H, W[, level]).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Sequence


def write_uchars(f: BinaryIO, values: Sequence[int]):
    f.write(struct.pack(f">{len(values)}B", *values))


def read_uchars(f: BinaryIO, n: int):
    return struct.unpack(f">{n}B", f.read(n))


def write_uints(f: BinaryIO, values: Sequence[int]):
    f.write(struct.pack(f">{len(values)}I", *values))


def read_uints(f: BinaryIO, n: int):
    return struct.unpack(f">{n}I", f.read(4 * n))


def write_bytes(f: BinaryIO, data: bytes):
    f.write(data)


def read_bytes(f: BinaryIO, n: int) -> bytes:
    return f.read(n)


def write_body(f: BinaryIO, shape: tuple[int, int], strings: list[list[bytes]]) -> int:
    """Write (shape, streams). Returns bytes written.

    The container is per-image (one y and one z stream); a batched
    ``compress()`` result (several streams per group) must be written one
    image at a time — refusing here beats silently dropping images.
    """
    total = 0
    flat = []
    for s in strings:
        if isinstance(s, (list, tuple)):
            if len(s) != 1:
                raise ValueError(
                    f"write_body is per-image; got a group of {len(s)} streams "
                    "(write each image of a batched compress() separately)")
            s = s[0]
        flat.append(s)
    write_uints(f, (shape[0], shape[1], len(flat)))
    total += 12
    for s in flat:
        write_uints(f, (len(s),))
        write_bytes(f, s)
        total += 4 + len(s)
    return total


def read_body(f: BinaryIO):
    h, w, n = read_uints(f, 3)
    strings = []
    for _ in range(n):
        (length,) = read_uints(f, 1)
        strings.append([read_bytes(f, length)])
    return strings, (h, w)
