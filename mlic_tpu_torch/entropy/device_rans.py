"""Interleaved rANS on the device (port of ``mlic_tpu/entropy/device_rans.py``).

L lockstep rans16 lanes per image (32-bit state, 16-bit renorm words,
16-bit probabilities).  Position order is step-major, image-major,
lane-minor: ``phase_order`` pads each phase to a lane multiple and lays it
out as [steps, B*n_lanes].  Stream format v3/v4 ("global emission order"):
per image, 2*n_lanes state words, then the renorm words in the decoder's
(step, lane) consumption order; out-of-support values (escapes) travel in
an int32 side channel.

Kernels here: K7 ``rans_encode_prep`` (replaces ``analytic_start_freq``,
:419, with the row select of ``select_rows`` in its shared memory, and
``_gather_start_freq``, :468, for the z section and, where ``Codec.update``
fell back, for y), K3 ``rans_encode_scan`` (replaces
``encode_scan_prepped``, :525, and the ``phase_order`` layout in front of
it), K6 ``rans_encode_compact`` (replaces ``compact_streams_global``, :602)
and K4 ``rans_decode_phase`` (replaces the ``lax.scan`` of
``make_decoder(fmt="global")``, :169; selects its rows' Gaussian constants
in shared memory).  K3 and K6 read the prep's [B, n] sections through the
index arithmetic of ``encode_sources_plain``.  The plain versions use
int64 masked to 32 bits for the uint32 state.  16-bit words, starts and
frequencies are kept as int16 tensors holding uint16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from mlic_tpu_torch.entropy.parametric import eval_cdf_plain
from mlic_tpu_torch.ops._build import KERNELS, stream_handle
from mlic_tpu_torch.ops.select_rows import MAX_ROWS, select_rows_plain

_RANS_L = 1 << 16
_MASK16 = (1 << 16) - 1
_MASK32 = (1 << 32) - 1
# Pad positions see the pad row's CDF [0, 2^16-1, 2^16] in every table
# family: symbol 0, start 0, freq 2^16-1.
_PAD_START = 0
_PAD_FREQM1 = (1 << 16) - 2
PREP_KERNEL = KERNELS["rans_encode_prep"]
ENCODE_KERNEL = KERNELS["rans_encode_scan"]
COMPACT_KERNEL = KERNELS["rans_encode_compact"]
DECODE_KERNEL = KERNELS["rans_decode_phase"]


def u16_bits(t: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 2^16) -> int16 tensor with the same 16 bits."""
    return (t.to(torch.int32) & _MASK16).to(torch.int16)


def parametric_device_tables(params: np.ndarray | None,
                             cdf_lengths: np.ndarray, offsets: np.ndarray,
                             cdf_rows: np.ndarray, device) -> dict:
    """Device tables (device_rans.py:63, :97): ``row_params`` f32 [n, 6] for
    the analytic paths, the integer ``cdf_rows`` for the encoder's gathers
    and the row-mode decode, ``max_value`` (= length - 2) and ``offsets``.
    ``params`` None (the host-built tables of ``Codec.update``'s fallback
    B) leaves ``row_params`` out: every row then codes by its integer row,
    where the JAX package decodes y through a [n_rows, 65536] LUT
    (``device_tables``).  The LUT is a ``searchsorted`` of the same rows, so
    the bisection finds its slot and no LUT is built."""
    i32 = torch.int32
    out = {
        "max_value": torch.as_tensor(np.asarray(cdf_lengths) - 2, dtype=i32,
                                     device=device),
        "offsets": torch.as_tensor(offsets, dtype=i32, device=device),
        "cdf_rows": torch.as_tensor(cdf_rows, dtype=i32, device=device),
    }
    if params is not None:
        out["row_params"] = torch.as_tensor(params, dtype=torch.float32,
                                            device=device)
    return out


def analytic_start_freq(sym: torch.Tensor, row: torch.Tensor,
                        row_params: torch.Tensor, select=select_rows_plain,
                        cdf=eval_cdf_plain):
    """(start, freq-1, esc) per symbol from the analytic Gaussian CDF
    (device_rans.py:419): row constants by ``select``, cdf at slot and
    slot+1 in one ``cdf`` call.  Returns int32, int32, bool in ``sym``'s
    shape.  With ``select_rows`` and ``eval_cdf`` (K1 and K2) it is the
    composition K7 replaced on the card."""
    m, b, A, C, Bc, Lf = select(row.to(torch.int32).contiguous(),
                                row_params)
    L = Lf.to(torch.int32)               # support size (exact in f32)
    off = -((L - 1) >> 1)
    v = sym.to(torch.int32) - off
    esc = (v < 0) | (v >= L)
    slot = torch.where(esc, L, v)
    both = cdf(torch.stack([slot, slot + 1]), m, b, A, C, Bc)
    return both[0], both[1] - both[0] - 1, esc


def gather_start_freq(sym: torch.Tensor, row: torch.Tensor, tables: dict):
    """(start, freq-1, esc) by integer-table gathers (device_rans.py:468):
    the v4 z section's factorized-prior rows, and y where ``Codec.update``
    fell back (``analytic_enc_rows == 0``)."""
    row = row.long()
    mv = tables["max_value"][row]
    v = sym.to(torch.int32) - tables["offsets"][row]
    esc = (v < 0) | (v >= mv)
    slot = torch.where(esc, mv, v).long()
    start = tables["cdf_rows"][row, slot]
    nxt = tables["cdf_rows"][row, slot + 1]
    return start, nxt - start - 1, esc


def encode_prep_plain(sym, idx, z_flat, tables: dict, z_rows_base: int,
                      n_z_rows: int, select=select_rows_plain,
                      cdf=eval_cdf_plain, y_gather: bool = False):
    """The plain version of K7: the z section by ``gather_start_freq`` on
    rows ``z_rows_base + j % n_z_rows`` (j the flat index within an
    image), the y section by ``analytic_start_freq`` with ``select`` and
    ``cdf``, or with ``y_gather`` by ``gather_start_freq`` on rows ``idx``.
    Returns ((start, freq-1, esc) of z, the same of y)."""
    b, n_z = z_flat.shape
    if n_z:
        z_rows = z_rows_base + torch.arange(n_z, dtype=torch.int32,
                                            device=z_flat.device) % n_z_rows
        z = gather_start_freq(z_flat, z_rows[None].expand(b, n_z), tables)
    else:
        empty = z_flat.new_empty((b, 0), dtype=torch.int32)
        z = (empty, empty.clone(), empty.bool())
    if y_gather:
        return z, gather_start_freq(sym, idx, tables)
    return z, analytic_start_freq(sym, idx, tables["row_params"], select, cdf)


def rans_encode_prep(sym, idx, z_flat, tables: dict, z_rows_base: int = 0,
                     n_z_rows: int = 1, y_gather: bool = False):
    """K7 for CUDA tensors, ``encode_prep_plain`` for CPU tensors: the rANS
    encode's prep in one launch.  ``sym``/``idx`` int32 [B, n_y] y symbols
    and scale indexes: into ``tables["row_params"]`` (f32 [<= 128, 6],
    staged in the kernel's shared memory), or with ``y_gather`` into the
    integer rows ``tables["cdf_rows"]`` (then ``row_params`` is not read and
    may be absent); ``z_flat`` int32 [B, n_z] (n_z may be 0, format v3)
    coded with the integer rows ``z_rows_base + j % n_z_rows``.  The
    integer rows come with ``max_value`` and ``offsets`` and are read only
    by a gathered section.  Returns ((start int32, freq-1 int32, esc bool)
    of z [B, n_z], the same of y [B, n_y])."""
    i32 = torch.int32
    if sym.dim() != 2 or z_flat.dim() != 2 or z_flat.shape[0] != sym.shape[0]:
        raise ValueError("rans_encode_prep: sym must be [B, n_y] and z_flat "
                         "[B, n_z]")
    B, n_y = sym.shape
    n_z = z_flat.shape[1]
    specs = [(sym, i32, (B, n_y)), (idx, i32, (B, n_y)),
             (z_flat, i32, (B, n_z))]
    rp = None
    if not y_gather:
        rp = tables["row_params"]
        if rp.dim() != 2 or rp.shape[1] != 6 \
                or not 1 <= rp.shape[0] <= MAX_ROWS:
            raise ValueError(f"rans_encode_prep: row_params must be f32 "
                             f"[<= {MAX_ROWS}, 6], got {tuple(rp.shape)}")
        specs.append((rp, torch.float32, tuple(rp.shape)))
    n_rows = 0
    if n_z or y_gather:
        cdf_rows, mv, off = (tables[k] for k in ("cdf_rows", "max_value",
                                                 "offsets"))
        n_rows = cdf_rows.shape[0]
        if n_z and (n_z_rows < 1 or z_rows_base < 0
                    or z_rows_base + n_z_rows > n_rows):
            raise ValueError("rans_encode_prep: z rows outside cdf_rows")
        specs += [(cdf_rows, i32, tuple(cdf_rows.shape)),
                  (mv, i32, (n_rows,)), (off, i32, (n_rows,))]
    if B * max(n_y, n_z) >= 1 << 31:
        raise ValueError("rans_encode_prep: sections exceed int32 indexing")
    _check_tensors("rans_encode_prep", *specs)
    dev = sym.device
    if dev.type == "cpu":
        return encode_prep_plain(sym, idx, z_flat, tables, z_rows_base,
                                 n_z_rows, y_gather=y_gather)
    if dev.type != "cuda":
        raise ValueError("rans_encode_prep: inputs must be on a CUDA device")
    outs = [sym.new_empty((B, n), dtype=dt) for n in (n_z, n_y)
            for dt in (i32, i32, torch.bool)]
    rt = (None, 0) if rp is None else (rp.data_ptr(), rp.shape[0])
    zt = (cdf_rows.data_ptr(), cdf_rows.shape[1], n_rows, mv.data_ptr(),
          off.data_ptr()) if n_rows else (None, 0, 0, None, None)
    PREP_KERNEL.launch(sym.data_ptr(), idx.data_ptr(), z_flat.data_ptr(),
                       *rt, int(y_gather), *zt, z_rows_base, n_z_rows, B,
                       n_y, n_z, *(t.data_ptr() for t in outs),
                       stream_handle(sym))
    return tuple(outs[:3]), tuple(outs[3:])


def phase_order(flat: torch.Tensor, n_lanes: int, pad_value=0) -> torch.Tensor:
    """[B, n] per-phase values -> [steps, B*n_lanes] position order
    (device_rans.py:654): pad to a lane multiple, then step-major /
    image-major / lane-minor."""
    b, n = flat.shape
    steps = -(-n // n_lanes)
    pad = steps * n_lanes - n
    if pad:
        flat = torch.cat([flat, torch.full((b, pad), pad_value,
                                           dtype=flat.dtype,
                                           device=flat.device)], 1)
    return (flat.reshape(b, steps, n_lanes).permute(1, 0, 2)
            .reshape(steps, b * n_lanes))


# --------------------------------------------------------------------------
# K3 and K6: the encode back end, from the prep's [B, n] sections
# --------------------------------------------------------------------------
MAX_ENCODE_LANES = 1024


def encode_steps(n_z: int, n_per: int, n_phases: int, n_lanes: int) -> tuple:
    """(steps of z, steps of one y phase, all steps) of the position layout
    (csrc/rans_layout.cuh): each section padded to a lane multiple."""
    sz, sp = -(-n_z // n_lanes), -(-n_per // n_lanes)
    return sz, sp, sz + n_phases * sp


def encode_sources_plain(n_images: int, n_z: int, n_per: int, n_phases: int,
                         n_lanes: int, device=None):
    """Where each position (step, image, lane) reads its symbol, by the
    index arithmetic of K3 and K6 (``encode_run`` in rans_layout.cuh):
    returns (in_y bool [S, L], idx int64 [S, L]), idx the flat index into
    the z section [B, n_z] or the y section [B, n_phases * n_per], -1 for a
    pad.  The CPU tests hold it against ``phase_order``."""
    sz, sp, S = encode_steps(n_z, n_per, n_phases, n_lanes)
    s = torch.arange(S, device=device)[:, None]
    g = torch.arange(n_images * n_lanes, device=device)[None, :]
    b, l = g // n_lanes, g % n_lanes
    in_y = (s >= sz).expand(S, g.shape[1])
    t = (s - sz).clamp(min=0)
    k = t // max(sp, 1)
    jy = (t - k * sp) * n_lanes + l
    jz = s * n_lanes + l
    idx = torch.where(in_y,
                      torch.where(jy < n_per,
                                  b * (n_phases * n_per) + k * n_per + jy, -1),
                      torch.where(jz < n_z, b * n_z + jz, -1))
    return in_y, idx


def encode_layout_plain(z: torch.Tensor, y: torch.Tensor, n_lanes: int,
                        n_phases: int, pad_value) -> torch.Tensor:
    """The z [B, n_z] and y [B, n_phases * n_per] sections in position
    order [S, B*n_lanes] by ``encode_sources_plain``, pads ``pad_value``."""
    in_y, idx = encode_sources_plain(z.shape[0], z.shape[1],
                                     y.shape[1] // n_phases, n_phases, n_lanes,
                                     z.device)
    flat = torch.cat([z.reshape(-1), y.reshape(-1),
                      torch.full((1,), pad_value, dtype=z.dtype,
                                 device=z.device)])
    where = torch.where(idx < 0, flat.numel() - 1, idx + in_y * z.numel())
    return flat[where]


def _popc32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK32) >> 24


def emits_to_masks(emits: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """bool [S, B*n_lanes] -> K3's ballot masks int32 [S, B, W] (uint32
    bits; lane l of an image at bit l % 32 of word l // 32)."""
    S, L = emits.shape
    wl = min(n_lanes, 32)
    e = emits.reshape(S, L // n_lanes, -1, wl).long()
    bits = (e << torch.arange(wl, device=emits.device)).sum(-1)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)


def masks_to_emits(masks: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """K3's ballot masks int32 [S, B, W] -> bool [S, B*n_lanes]."""
    S, B, _ = masks.shape
    j = torch.arange(min(n_lanes, 32), device=masks.device)
    return ((masks.long()[..., None] >> j) & 1).bool().reshape(S, B * n_lanes)


def divmod_magic_plain(x: torch.Tensor, freq: torch.Tensor, slack: int = 2):
    """K3's divide (``make_prep`` and ``quotient`` in csrc/rans_encode.cu)
    in plain PyTorch: (x // freq, x % freq) for int64 x in [0, 2^32) and
    freq in [1, 2^16], with no division of x.

    Any M = 2^52 / freq + e with 0 <= e < 16 gives q = floor(x M / 2^52) =
    x // freq: x M / 2^52 = x / freq + x e / 2^52, where x e / 2^52 < 16 *
    2^-20 = 2^-16 <= 1 / freq, while x / freq lies at least 1 / freq below
    the next integer.  Here M = floor(w) + ``slack`` with w = 2^52 / freq
    rounded to nearest (|w - 2^52 / freq| <= 1/4), so slack 1 to 15 stays
    in range; the kernel takes w from an approximate reciprocal and slack
    4.  The product is split as the kernel splits it, M = Mh 2^32 + Ml and
    q = (x Mh + umulhi(x, Ml)) >> 20 (umulhi here from 16-bit halves of x,
    so that every product fits int64)."""
    w = torch.full(freq.shape, float(1 << 52), dtype=torch.float64,
                   device=freq.device) / freq.double()
    m = w.floor().long() + slack
    m_hi, m_lo = m >> 32, m & _MASK32
    t = ((x >> 16) * m_lo + (((x & _MASK16) * m_lo) >> 16)) >> 16
    q = (x * m_hi + t) >> 20
    return q, x - q * freq


def rans_encode_scan_plain(start16: torch.Tensor, freqm1: torch.Tensor,
                           n_lanes: int):
    """Reverse scan over [S, L] position-ordered uint16-bit (start, freq-1),
    int64 state, plain // and %.  Returns (x int64 [L] final states, words
    int16 [S, L] (x & 0xffff before each step's emit test), masks int32
    [S, B, W] of the lanes that emitted)."""
    S, L = start16.shape
    st = start16.long() & _MASK16
    fr = (freqm1.long() & _MASK16) + 1
    x = torch.full((L,), _RANS_L, dtype=torch.int64, device=start16.device)
    words = torch.empty((S, L), dtype=torch.int64, device=start16.device)
    emits = torch.empty((S, L), dtype=torch.bool, device=start16.device)
    for s in range(S - 1, -1, -1):
        f = fr[s]
        emit = x >= ((f << 16) & _MASK32)
        words[s] = x & _MASK16
        emits[s] = emit
        x = torch.where(emit, x >> 16, x)
        x = ((x // f) << 16) + (x % f) + st[s]
    return x, u16_bits(words), emits_to_masks(emits, n_lanes)


def _encode_geometry(name: str, z: torch.Tensor, y: torch.Tensor,
                     n_lanes: int, n_phases: int) -> tuple:
    """(B, n_z, n_per, S, z.shape, y.shape) of the sections; raises, on any
    device, for what K3 and K6 refuse (``make_encode_layout`` in
    csrc/rans_layout.cuh)."""
    if not 1 <= n_lanes <= MAX_ENCODE_LANES or n_lanes & (n_lanes - 1):
        raise ValueError(f"{name}: n_lanes {n_lanes} is not a power of two "
                         f"in [1, {MAX_ENCODE_LANES}]")
    zs, ys = z.shape, y.shape
    if len(zs) != 2 or len(ys) != 2 or zs[0] != ys[0] or zs[0] < 1:
        raise ValueError(f"{name}: sections must be [B, n_z] and [B, n_y] "
                         "with B >= 1")
    (B, n_z), n_y = zs, ys[1]
    if n_phases < 1 or n_y % n_phases:
        raise ValueError(f"{name}: n_phases {n_phases} does not split the y "
                         f"section's {n_y} columns")
    n_per = n_y // n_phases
    S = encode_steps(n_z, n_per, n_phases, n_lanes)[2]
    if (S + 2) * B * n_lanes >= 1 << 31 or B * (n_z + n_y) >= 1 << 31:
        raise ValueError(f"{name}: {B} images of {S} steps exceed int32 "
                         "positions")
    return B, n_z, n_per, S, zs, ys


def _check_tensors(name: str, *specs) -> None:
    """Each (tensor, dtype, shape) on the first tensor's device, with that
    dtype and shape, contiguous."""
    dev = specs[0][0].device
    for t, dt, shape in specs:
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs must share one device")


def rans_encode_scan(z_start, z_freqm1, y_start, y_freqm1, n_lanes: int,
                     n_phases: int):
    """K3 for CUDA tensors, its plain version for CPU tensors: the encode
    scan straight from the prep's sections, int32 (uint16 values) start
    and freq-1 of z [B, n_z] and y [B, n_phases * n_per]; on the card a
    block of one consumer warp and eight producer warps serves 32 lanes.
    Returns (x int64 [B*n_lanes], words int16 [S, B*n_lanes], masks int32
    [S, B, W])."""
    B, n_z, n_per, S, zs, ys = _encode_geometry(
        "rans_encode_scan", z_start, y_start, n_lanes, n_phases)
    i32 = torch.int32
    _check_tensors("rans_encode_scan", (z_start, i32, zs), (z_freqm1, i32, zs),
                   (y_start, i32, ys), (y_freqm1, i32, ys))
    dev = z_start.device
    if dev.type == "cpu":
        return rans_encode_scan_plain(
            u16_bits(encode_layout_plain(z_start, y_start, n_lanes, n_phases,
                                         _PAD_START)),
            u16_bits(encode_layout_plain(z_freqm1, y_freqm1, n_lanes,
                                         n_phases, _PAD_FREQM1)), n_lanes)
    if dev.type != "cuda":
        raise ValueError("rans_encode_scan: inputs must be on a CUDA device")
    L, W = B * n_lanes, -(-n_lanes // 32)
    x = z_start.new_empty(L, dtype=torch.int64)
    words = z_start.new_empty((S, L), dtype=torch.int16)
    masks = z_start.new_empty((S, B, W), dtype=i32)
    ENCODE_KERNEL.launch(z_start.data_ptr(), z_freqm1.data_ptr(),
                         y_start.data_ptr(), y_freqm1.data_ptr(),
                         x.data_ptr(), words.data_ptr(), masks.data_ptr(), B,
                         n_lanes, n_z, n_per, n_phases,
                         stream_handle(z_start))
    return x, words, masks


def word_positions_plain(masks: torch.Tensor, n_lanes: int):
    """K6's rank arithmetic in plain PyTorch: each emitted word's place in
    ``buf`` from K3's masks alone -- after its image's begin and 2*n_lanes
    state words, the exclusive scan of the popcounts of the image's
    (step, word) masks in (step, word) order, plus the popcount of the
    mask's bits below the lane.  Returns (pos int64 [S, B*n_lanes], -1
    where nothing was emitted; img_n int64 [B]).  The CPU tests hold it
    against the cumsum ranks of ``compact_streams_global``."""
    S, B, W = masks.shape
    m = masks.long() & _MASK32
    per_img = _popc32(m).permute(1, 0, 2).reshape(B, S * W)
    base = (torch.cumsum(per_img, 1) - per_img).reshape(B, S, W) \
        .permute(1, 0, 2)
    img_n = per_img.sum(1) + 2 * n_lanes
    img_begin = torch.cumsum(img_n, 0) - img_n
    j = torch.arange(min(n_lanes, 32), device=masks.device)
    below = _popc32(m[..., None] & ((1 << j) - 1))
    pos = img_begin[None, :, None, None] + 2 * n_lanes + base[..., None] \
        + below
    pos = torch.where(((m[..., None] >> j) & 1).bool(), pos, -1)
    return pos.reshape(S, B * n_lanes), img_n


def compact_streams_global(x, words, masks, esc, sym, n_images: int) -> dict:
    """Format-v3/v4 compaction (device_rans.py:602), the plain version of
    K6: per-image word blocks [2*n_lanes state words (hi, lo per lane),
    renorm words in (step, lane) order], written by a cumsum and a scatter
    onto unique positions; ``masks`` are K3's, ``esc`` and ``sym`` [S, L]
    in position order.

    Returns buf int16 [S*L + 2L] (uint16 bits; image b occupies
    [img_begin[b], img_begin[b] + img_n[b])), img_n int32 [B], ebuf int32
    (escape values, image-major, position order) and ecount int32 [B]."""
    S, L = words.shape
    nl = L // n_images
    emits = masks_to_emits(masks, nl)

    def per_image(a):
        return a.reshape(S, n_images, nl).permute(1, 0, 2).reshape(
            n_images, -1)

    em_i = per_image(emits)
    e = em_i.to(torch.int32)
    prefix = torch.cumsum(e, 1, dtype=torch.int32) - e
    img_n = e.sum(1, dtype=torch.int32) + 2 * nl
    img_begin = torch.cumsum(img_n, 0, dtype=torch.int32) - img_n
    buf = torch.zeros(S * L + 2 * L, dtype=torch.int16, device=words.device)
    pos = (img_begin[:, None] + 2 * nl + prefix)[em_i]
    buf[pos.long()] = per_image(words)[em_i]
    spos = (img_begin[:, None] + 2 * torch.arange(
        nl, dtype=torch.int32, device=x.device)[None, :]).reshape(-1).long()
    buf[spos] = u16_bits(x >> 16)
    buf[spos + 1] = u16_bits(x & _MASK16)
    esc_i = per_image(esc)
    return {"buf": buf, "img_n": img_n,
            "ebuf": per_image(sym).to(torch.int32)[esc_i],
            "ecount": esc_i.sum(1, dtype=torch.int32)}


COMPACT_THREADS = 256       # K6's block: one 32-lane mask word a thread
STATUS_AGGREGATE, STATUS_PREFIX = 1, 2
_STATUS_WORDS = 3           # int64s an item: tag, aggregate, prefix
_compact_state = {}         # (device index, stream) -> (control, status)


def compact_plan(n_lanes: int, steps: int) -> tuple:
    """K6's work items (``rans_compact.cu``): an item is one image's run of
    ``COMPACT_THREADS // W`` steps (W mask words a step), one mask word a
    thread; items are numbered image-major.  Returns (steps an item, items
    an image); an image of no steps is one empty item (its state words)."""
    W = -(-n_lanes // 32)
    per = COMPACT_THREADS // W
    return per, max(-(-steps // per), 1)


def compact_status_tag(epoch: int, flag: int) -> int:
    """The tag K6 publishes an item's status under: ``epoch << 2 | flag``
    (flag 1 aggregate, 2 inclusive prefix).  Zeroed memory (flag 0) and a
    tag of an earlier launch's epoch are never taken as ready."""
    return (epoch << 2) | flag


def compact_items_plain(masks, esc_pos, n_lanes: int) -> dict:
    """K6's item arithmetic in plain PyTorch: each item's (words, escapes)
    aggregate from K3's masks and the position-order escape flags, the
    exclusive prefix over all items that the look-back gives each item,
    and img_n / ecount from the inclusive prefixes at each image's last
    item.  The CPU tests hold it against ``compact_streams_global``."""
    S, B, W = masks.shape
    per, ipi = compact_plan(n_lanes, S)
    emasks = emits_to_masks(esc_pos, n_lanes)
    counts = torch.stack([_popc32(masks.long() & _MASK32),
                          _popc32(emasks.long() & _MASK32)], -1)
    pad = ipi * per - S
    counts = torch.cat([counts, counts.new_zeros((pad, B, W, 2))])
    agg = counts.reshape(ipi, per, B, W, 2).sum((1, 3)).permute(1, 0, 2) \
        .reshape(B * ipi, 2)
    incl = torch.cumsum(agg, 0)
    last = incl[ipi - 1::ipi]
    img = last - torch.cat([last.new_zeros((1, 2)), last[:-1]])
    return {"aggregate": agg, "exclusive": incl - agg,
            "img_n": img[:, 0] + 2 * n_lanes, "ecount": img[:, 1]}


def _compact_buffers(dev, stream: int, n_items: int):
    """K6's control block (ticket, done count, epoch) and item statuses on
    ``dev`` for launches on ``stream``, zeroed when first made and when the
    statuses grow; K6 itself leaves the control block ready for the next
    launch, so a call costs no set-up launch and a CUDA graph may replay
    it."""
    key = (dev.index, stream)
    ctl, st = _compact_state.get(key, (None, None))
    if ctl is None:
        ctl = torch.zeros(2, dtype=torch.int64, device=dev)
    if st is None or st.numel() < _STATUS_WORDS * n_items:
        st = torch.zeros(_STATUS_WORDS * max(n_items, 4096),
                         dtype=torch.int64, device=dev)
    _compact_state[key] = (ctl, st)
    return ctl, st


def rans_encode_compact(x, words, masks, z_esc, z_sym, y_esc, y_sym,
                        n_lanes: int, n_phases: int) -> dict:
    """K6 for CUDA tensors, ``compact_streams_global`` for CPU tensors:
    K3's outputs and the prep's escape flags (bool) and symbols (int32) of
    z [B, n_z] and y [B, n_phases * n_per] -> {"buf", "img_n", "ebuf",
    "ecount"} as ``compact_streams_global`` returns them, except that on
    the card ``ebuf`` holds S*L entries of which the first sum(ecount) are
    used.  One launch of ``B * items an image`` blocks (``compact_plan``),
    nothing read back to the host."""
    B, n_z, n_per, S, zs, ys = _encode_geometry(
        "rans_encode_compact", z_sym, y_sym, n_lanes, n_phases)
    L, W = B * n_lanes, -(-n_lanes // 32)
    i32 = torch.int32
    _check_tensors("rans_encode_compact", (x, torch.int64, (L,)),
                   (words, torch.int16, (S, L)), (masks, i32, (S, B, W)),
                   (z_esc, torch.bool, zs), (z_sym, i32, zs),
                   (y_esc, torch.bool, ys), (y_sym, i32, ys))
    dev = x.device
    if dev.type == "cpu":
        return compact_streams_global(
            x, words, masks,
            encode_layout_plain(z_esc, y_esc, n_lanes, n_phases, False),
            encode_layout_plain(z_sym, y_sym, n_lanes, n_phases, 0), B)
    if dev.type != "cuda":
        raise ValueError("rans_encode_compact: inputs must be on a CUDA "
                         "device")
    per, ipi = compact_plan(n_lanes, S)
    stream = stream_handle(x)
    ctl, status = _compact_buffers(dev, stream, B * ipi)
    counts = x.new_empty((2, B), dtype=i32)
    out = {"buf": x.new_empty(S * L + 2 * L, dtype=torch.int16),
           "img_n": counts[0], "ebuf": x.new_empty(max(S * L, 1), dtype=i32),
           "ecount": counts[1]}
    COMPACT_KERNEL.launch(
        masks.data_ptr(), words.data_ptr(), x.data_ptr(), z_esc.data_ptr(),
        z_sym.data_ptr(), y_esc.data_ptr(), y_sym.data_ptr(), ctl.data_ptr(),
        status.data_ptr(), out["buf"].data_ptr(), out["img_n"].data_ptr(),
        out["ebuf"].data_ptr(), out["ecount"].data_ptr(), B, n_lanes, n_z,
        n_per, n_phases, per, ipi, stream)
    return out


# --------------------------------------------------------------------------
# K4: the decode of one phase
# --------------------------------------------------------------------------
def rans_init_global(words: torch.Tensor, img_begin: torch.Tensor,
                     n_lanes: int):
    """Lane states from each image block's 2*n_lanes leading words
    (device_rans.py:138).  Returns (x int64 [B*n_lanes], img_ptr int32 [B])."""
    B = img_begin.shape[0]
    li = torch.arange(n_lanes, device=words.device).repeat(B)
    base = torch.repeat_interleave(img_begin.long(), n_lanes) + 2 * li
    w0 = words[base].long() & _MASK16
    w1 = words[base + 1].long() & _MASK16
    return (w0 << 16) | w1, (img_begin + 2 * n_lanes).to(torch.int32)


def _renorm_global_plain(x, img_ptr, words):
    """The lanes whose state fell below 2^16 read one word each, at the
    image pointer plus their exclusive rank among this step's reading lanes
    (device_rans.py:152)."""
    B = img_ptr.shape[0]
    need = x < _RANS_L
    need_i = need.reshape(B, -1).to(torch.int32)
    rank = torch.cumsum(need_i, 1, dtype=torch.int32) - need_i
    pos = (img_ptr[:, None] + rank).reshape(-1).clamp_(max=words.numel() - 1)
    w = words[pos.long()].long() & _MASK16
    x = torch.where(need, (x << 16) | w, x)
    return x, img_ptr + need_i.sum(1, dtype=torch.int32)


def rans_decode_phase_plain(words, x, img_ptr, n_lanes: int, n_steps: int,
                            rows, tables: dict, parametric: bool):
    """Decode S steps over B*n_lanes lanes (the plain version of K4) at
    ``rows`` int32 [S, B*n_lanes].

    Parametric: each row's constants (m, b, A, C, B, L) by
    ``select_rows_plain`` from ``tables["row_params"]``; ``n_steps``-level
    bisection on ``eval_cdf_plain``.  Row-table mode: bisection over the
    integer ``cdf_rows`` with ``max_value``/``offsets``.
    Returns (sym int32 [S, BL], esc bool [S, BL], x int64, img_ptr int32);
    escaped positions hold a placeholder symbol until the escape patch."""
    S = rows.shape[0]
    BL = x.shape[0]
    dev = x.device
    cols = select_rows_plain(rows, tables["row_params"]) if parametric \
        else None
    cdf_rows, max_value, offsets = (None if parametric else tables[k] for k
                                    in ("cdf_rows", "max_value", "offsets"))
    sym = torch.empty((S, BL), dtype=torch.int32, device=dev)
    esc_out = torch.empty((S, BL), dtype=torch.bool, device=dev)
    for s in range(S):
        cf = (x & _MASK16).to(torch.int32)
        lo = torch.zeros_like(cf)
        v_lo = torch.zeros_like(cf)
        if parametric:
            pm, pb, pA, pC, pB, pL = cols[:, s]
            max_value_s = pL.to(torch.int32)
            esc = cf == _MASK16
            hi = max_value_s
            v_hi = torch.full_like(cf, _MASK16)

            def cdf_at(mid):
                return eval_cdf_plain(mid, pm, pb, pA, pC, pB)
        else:
            row = rows[s].long()
            max_value_s = max_value[row]
            hi = max_value_s + 1
            v_hi = torch.full_like(cf, 1 << 16)

            def cdf_at(mid):
                return cdf_rows[row, mid.long()]
        for _ in range(n_steps):
            guard = (hi - lo) > 1
            mid = (lo + hi) >> 1
            v_mid = cdf_at(mid)
            take = (v_mid <= cf) & guard
            keep = guard & ~take
            lo = torch.where(take, mid, lo)
            v_lo = torch.where(take, v_mid, v_lo)
            hi = torch.where(keep, mid, hi)
            v_hi = torch.where(keep, v_mid, v_hi)
        if parametric:
            start = torch.where(esc, _MASK16, v_lo).long()
            freq = torch.where(esc, 1, v_hi - v_lo).long()
            sym[s] = lo - ((max_value_s - 1) >> 1)
        else:
            start, freq = v_lo.long(), (v_hi - v_lo).long()
            esc = lo == max_value_s
            sym[s] = lo + offsets[row]
        esc_out[s] = esc
        x = (freq * (x >> 16) + (x & _MASK16) - start) & _MASK32
        x, img_ptr = _renorm_global_plain(x, img_ptr, words)
    return sym, esc_out, x, img_ptr


_MAX_CLUSTER = 8        # the portable thread-block cluster size
_MAX_BLOCK = 512        # K4's threads a block, at most


def decode_group(n_lanes: int) -> int:
    """K4's threads a lane (``lane_group`` in rans_decode.cu): 8 where an
    image's lanes fit a cluster of 8 blocks of 512 threads that way (up to
    512 lanes), else 4."""
    return 8 if n_lanes * 8 <= _MAX_CLUSTER * _MAX_BLOCK else 4


def decode_blocks_per_image(n_lanes: int) -> int:
    """K4's cluster size (``cluster_blocks`` in rans_decode.cu): one block
    below 32 lanes, else the fewest of 1, 2, 4, 8 blocks that split an
    image's lanes evenly with at most 512 threads (``decode_group`` a lane)
    each.  Raises for lane counts the kernel refuses: not in [1, 31] and
    not whole warps up to 1024."""
    if not 1 <= n_lanes <= 1024 or (n_lanes > 32 and n_lanes % 32):
        raise ValueError(f"rans_decode_phase: n_lanes {n_lanes} is neither "
                         "in [1, 31] nor a multiple of 32 up to 1024")
    if n_lanes < 32:
        return 1
    group, b = decode_group(n_lanes), 1
    while n_lanes % b or n_lanes // b * group > _MAX_BLOCK:
        b *= 2
    return b


def kary_search_plain(cdf_at, cf, lo, v_lo, hi, v_hi, group: int,
                      n_steps: int):
    """K4's T-way slot search (``kary_search`` in rans_decode.cu), in plain
    PyTorch over a batch of lanes; the codec path does not call it.

    [lo, hi] brackets the slot with ``v_lo = cdf(lo) <= cf < v_hi =
    cdf(hi)``; ``cdf_at(k)`` evaluates the CDF at slots k (int32, one per
    lane).  Each of ``ceil(n_steps / log2 group)`` rounds evaluates the
    ``group - 1`` inner split points ``lo + span * t // group`` and keeps
    the sub-interval between the last point with cdf <= cf and the next.
    Neither lo nor hi is ever evaluated (the bisection's conventions for
    cdf(0) and cdf(hi) hold).  The CDF being strictly increasing, this ends
    on the bisection's slot whenever ``n_steps`` levels pin it.  Returns
    (lo, v_lo, hi, v_hi)."""
    bits = group.bit_length() - 1
    if group < 2 or 1 << bits != group:
        raise ValueError("kary_search_plain: group must be a power of two")
    for _ in range(-(-n_steps // bits)):
        span = hi - lo
        active = span > 1
        new_lo, new_vlo = lo, v_lo
        new_hi, new_vhi = hi, v_hi
        found = torch.ones_like(active)          # p_0 = lo: always <= cf
        for t in range(1, group):
            p = lo + (span.long() * t // group).to(lo.dtype)
            v = torch.where(p > lo, cdf_at(torch.where(active, p, lo)), v_lo)
            le = v <= cf
            # the first split point above cf closes the interval
            first_gt = found & ~le
            new_hi = torch.where(first_gt, p, new_hi)
            new_vhi = torch.where(first_gt, v, new_vhi)
            found = found & le
            new_lo = torch.where(found, p, new_lo)
            new_vlo = torch.where(found, v, new_vlo)
        lo = torch.where(active, new_lo, lo)
        v_lo = torch.where(active, new_vlo, v_lo)
        hi = torch.where(active, new_hi, hi)
        v_hi = torch.where(active, new_vhi, v_hi)
    return lo, v_lo, hi, v_hi


def decode_slot_plain(cf, group: int, n_steps: int, cols_s=None, row=None,
                      cdf_rows=None, max_value=None, offsets=None):
    """One decode step's (symbol, start, freq, esc) per lane by
    ``kary_search_plain``, as K4 computes it: parametric with ``cols_s``
    f32 [6, n] (m, b, A, C, B, L), else by integer rows ``row`` [n] of
    ``cdf_rows``.  The statement of K4's step that the tests hold against
    the bisection of ``rans_decode_phase_plain``."""
    cf = cf.to(torch.int32)
    lo = torch.zeros_like(cf)
    if cols_s is not None:
        pm, pb, pA, pC, pB, pL = cols_s
        mv = pL.to(torch.int32)
        lo, v_lo, hi, v_hi = kary_search_plain(
            lambda k: eval_cdf_plain(k, pm, pb, pA, pC, pB), cf, lo,
            torch.zeros_like(cf), mv, torch.full_like(cf, _MASK16), group,
            n_steps)
        esc = cf == _MASK16
        start = torch.where(esc, _MASK16, v_lo)
        freq = torch.where(esc, 1, v_hi - v_lo)
        return lo - ((mv - 1) >> 1), start, freq, esc
    row = row.long()
    mv = max_value[row]
    lo, v_lo, hi, v_hi = kary_search_plain(
        lambda k: cdf_rows[row, k.long()], cf, lo, torch.zeros_like(cf),
        mv + 1, torch.full_like(cf, 1 << 16), group, n_steps)
    return lo + offsets[row], v_lo, v_hi - v_lo, lo == mv


def rans_decode_phase(words, x, img_ptr, n_lanes: int, n_steps: int,
                      rows, tables: dict, parametric: bool):
    """K4 for CUDA tensors, the plain version for CPU tensors, at ``rows``
    int32 [S, B*n_lanes]: parametric (the rows' Gaussian constants
    selected from ``tables["row_params"]``, staged in each block's shared
    memory) or by the integer rows of ``tables["cdf_rows"]``.  A group of
    threads per lane searches the CDF T-ways (``decode_group``), and an
    image's lanes span a cluster of ``decode_blocks_per_image(n_lanes)``
    blocks; returns new carry tensors (the inputs are not modified).
    ``n_lanes`` is below 32 or a multiple of 32 up to 1024: the kernel's
    warp ballot names every lane of a full warp."""
    decode_blocks_per_image(n_lanes)          # raises for what K4 refuses
    if words.device.type == "cpu":
        return rans_decode_phase_plain(words, x, img_ptr, n_lanes, n_steps,
                                       rows, tables, parametric)
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("rans_decode_phase: inputs must be on a CUDA device")
    B = img_ptr.shape[0]
    BL = x.shape[0]
    if BL != B * n_lanes or x.dtype != torch.int64 \
            or img_ptr.dtype != torch.int32 or words.dtype != torch.int16:
        raise TypeError("rans_decode_phase: carry must be x int64 [B*n_lanes]"
                        ", img_ptr int32 [B]; words int16")
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != BL:
        raise ValueError("rans_decode_phase: rows must be int32 [S, BL]")
    S = rows.shape[0]
    if parametric:
        rp = tables["row_params"]
        if rp.dtype != torch.float32 or rp.dim() != 2 or rp.shape[1] != 6 \
                or not 1 <= rp.shape[0] <= MAX_ROWS:
            raise ValueError(f"rans_decode_phase: row_params must be f32 "
                             f"[<= {MAX_ROWS}, 6]")
        tabs = (rows, rp)
        tab_args = (rp.data_ptr(), rp.shape[0], None, 0, None, None)
    else:
        cdf_rows, max_value, offsets = (tables[k] for k in (
            "cdf_rows", "max_value", "offsets"))
        tabs = (rows, cdf_rows, max_value, offsets)
        if any(t.dtype != torch.int32 for t in tabs):
            raise TypeError("rans_decode_phase: row tables must be int32")
        tab_args = (None, 0, cdf_rows.data_ptr(), cdf_rows.shape[1],
                    max_value.data_ptr(), offsets.data_ptr())
    for t in (words, x, img_ptr) + tabs:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("rans_decode_phase: inputs must be contiguous "
                             "on one CUDA device")
    x_out = torch.empty_like(x)
    ptr_out = torch.empty_like(img_ptr)
    sym = torch.empty((S, BL), dtype=torch.int32, device=dev)
    esc = torch.empty((S, BL), dtype=torch.bool, device=dev)
    DECODE_KERNEL.launch(words.data_ptr(), words.numel(), x.data_ptr(),
                         img_ptr.data_ptr(), x_out.data_ptr(),
                         ptr_out.data_ptr(), sym.data_ptr(), esc.data_ptr(),
                         S, B, n_lanes, int(not parametric), rows.data_ptr(),
                         n_steps, *tab_args, stream_handle(words))
    return sym, esc, x_out, ptr_out


def make_decoder(words: torch.Tensor, n_steps: int, esc_values: torch.Tensor,
                 esc_begin: torch.Tensor, n_lanes: int):
    """Bind a format-v3/v4 word buffer (device_rans.py:169, fmt="global").

    ``words``: int16 (uint16 bits) [W], all images' blocks concatenated;
    ``esc_values`` int32 (all images' escape values), ``esc_begin`` int32
    [B] per-image offsets into it.  Returns (init, decode):
    ``init(img_begin) -> carry``; ``decode(carry, rows, tables,
    n_steps_row=None) -> (carry, symbols [S*B*n_lanes])`` in position
    order, escapes patched in from the side channel.  Without
    ``n_steps_row`` the phase decodes parametrically (``n_steps`` levels),
    with it by bisection over ``tables["cdf_rows"][rows]``."""
    if esc_values.numel() == 0:
        esc_values = torch.zeros(1, dtype=torch.int32, device=words.device)

    def init(img_begin):
        x, ptr = rans_init_global(words, img_begin, n_lanes)
        return x, ptr, torch.zeros_like(esc_begin)

    def decode(carry, rows, tables, n_steps_row=None):
        x, ptr, esc_count = carry
        parametric = n_steps_row is None
        sym, esc, x, ptr = rans_decode_phase(
            words, x, ptr, n_lanes, n_steps if parametric else n_steps_row,
            rows, tables, parametric)
        out, esc_count = patch_escapes(sym, esc, esc_count, esc_values,
                                       esc_begin, n_lanes)
        return (x, ptr, esc_count), out

    return init, decode


def patch_escapes(sym, esc, esc_count, esc_values, esc_begin, n_lanes: int):
    """Replace escaped positions of one decoded phase ([S, B*n_lanes]) with
    the side channel's values, numbered per image in position order
    (device_rans.py:345-356).  Returns (symbols [S*B*n_lanes] in position
    order, new per-image escape counts)."""
    S = sym.shape[0]
    B = esc_begin.shape[0]
    sym_i = sym.reshape(S, B, n_lanes).permute(1, 0, 2).reshape(B, -1)
    esc_i = esc.reshape(S, B, n_lanes).permute(1, 0, 2).reshape(B, -1)
    k = (torch.cumsum(esc_i.to(torch.int32), 1, dtype=torch.int32) - 1
         + (esc_count + esc_begin)[:, None])
    vals = esc_values[k.clamp(0, esc_values.numel() - 1).long()]
    sym_i = torch.where(esc_i, vals, sym_i)
    new_count = esc_count + esc_i.sum(1, dtype=torch.int32)
    return sym_i.reshape(B, S, n_lanes).permute(1, 0, 2).reshape(-1), new_count
