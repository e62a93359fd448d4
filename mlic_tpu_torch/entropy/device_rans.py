"""Interleaved rANS on the device (port of ``mlic_tpu/entropy/device_rans.py``).

L lockstep rans16 lanes per image (32-bit state, 16-bit renorm words,
16-bit probabilities).  Position order is step-major, image-major,
lane-minor: ``phase_order`` pads each phase to a lane multiple and lays it
out as [steps, B*n_lanes].  Stream format v3/v4 ("global emission order"):
per image, 2*n_lanes state words, then the renorm words in the decoder's
(step, lane) consumption order; out-of-support values (escapes) travel in
an int32 side channel.

Kernels here: K3 ``rans_encode_scan`` (replaces ``encode_scan_prepped``,
:525) and K4 ``rans_decode_phase`` (replaces the ``lax.scan`` of
``make_decoder(fmt="global")``, :169).  Their plain versions use int64
masked to 32 bits for the uint32 state.  16-bit words, starts and
frequencies are kept as int16 tensors holding uint16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from mlic_tpu_torch.entropy.parametric import eval_cdf, eval_cdf_plain
from mlic_tpu_torch.ops._build import KERNELS, stream_handle
from mlic_tpu_torch.ops.select_rows import select_rows

_RANS_L = 1 << 16
_MASK16 = (1 << 16) - 1
_MASK32 = (1 << 32) - 1
# Pad positions see the pad row's CDF [0, 2^16-1, 2^16] in every table
# family: symbol 0, start 0, freq 2^16-1.
_PAD_START = 0
_PAD_FREQM1 = (1 << 16) - 2
ENCODE_KERNEL = KERNELS["rans_encode_scan"]
DECODE_KERNEL = KERNELS["rans_decode_phase"]


def u16_bits(t: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 2^16) -> int16 tensor with the same 16 bits."""
    return (t.to(torch.int32) & _MASK16).to(torch.int16)


def parametric_device_tables(params: np.ndarray, cdf_lengths: np.ndarray,
                             offsets: np.ndarray, cdf_rows: np.ndarray,
                             device) -> dict:
    """Device tables (device_rans.py:97): ``row_params`` f32 [n, 6] for the
    analytic paths, the integer ``cdf_rows`` for the encoder's gathers and
    the z section, ``max_value`` (= length - 2) and ``offsets``."""
    i32 = torch.int32
    return {
        "row_params": torch.as_tensor(params, dtype=torch.float32,
                                      device=device),
        "max_value": torch.as_tensor(np.asarray(cdf_lengths) - 2, dtype=i32,
                                     device=device),
        "offsets": torch.as_tensor(offsets, dtype=i32, device=device),
        "cdf_rows": torch.as_tensor(cdf_rows, dtype=i32, device=device),
    }


def analytic_start_freq(sym: torch.Tensor, row: torch.Tensor,
                        row_params: torch.Tensor):
    """(start, freq-1, esc) per symbol from the analytic Gaussian CDF
    (device_rans.py:419): row constants by ``select_rows`` (K1), cdf at
    slot and slot+1 in one ``eval_cdf`` call (K2).  Returns int32, int32,
    bool in ``sym``'s shape."""
    m, b, A, C, Bc, Lf = select_rows(row.to(torch.int32).contiguous(),
                                     row_params)
    L = Lf.to(torch.int32)               # support size (exact in f32)
    off = -((L - 1) >> 1)
    v = sym.to(torch.int32) - off
    esc = (v < 0) | (v >= L)
    slot = torch.where(esc, L, v)
    both = eval_cdf(torch.stack([slot, slot + 1]), m, b, A, C, Bc)
    return both[0], both[1] - both[0] - 1, esc


def gather_start_freq(sym: torch.Tensor, row: torch.Tensor, tables: dict):
    """(start, freq-1, esc) by integer-table gathers (device_rans.py:468):
    the v4 z section's factorized-prior rows."""
    row = row.long()
    mv = tables["max_value"][row]
    v = sym.to(torch.int32) - tables["offsets"][row]
    esc = (v < 0) | (v >= mv)
    slot = torch.where(esc, mv, v).long()
    start = tables["cdf_rows"][row, slot]
    nxt = tables["cdf_rows"][row, slot + 1]
    return start, nxt - start - 1, esc


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
# K3: the encode scan
# --------------------------------------------------------------------------
def rans_encode_scan_plain(start16: torch.Tensor, freqm1: torch.Tensor):
    """Reverse scan over [S, L] uint16-bit (start, freq-1).  Returns
    (x int64 [L] final states, words int16 [S, L] (x & 0xffff before each
    step's emit test), emits bool [S, L])."""
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
    return x, u16_bits(words), emits


def rans_encode_scan(start16: torch.Tensor, freqm1: torch.Tensor):
    """K3 for CUDA tensors, the plain version for CPU tensors.
    start16, freqm1: int16 (uint16 bits) [S, L], contiguous."""
    if start16.device.type == "cpu":
        return rans_encode_scan_plain(start16, freqm1)
    if start16.device.type != "cuda" or freqm1.device != start16.device:
        raise ValueError("rans_encode_scan: inputs must share a CUDA device")
    if start16.dtype != torch.int16 or freqm1.dtype != torch.int16:
        raise TypeError("rans_encode_scan: inputs must be int16 (uint16 bits)")
    if (start16.dim() != 2 or start16.shape != freqm1.shape
            or not (start16.is_contiguous() and freqm1.is_contiguous())):
        raise ValueError("rans_encode_scan: inputs must be contiguous [S, L]")
    S, L = start16.shape
    dev = start16.device
    x = torch.empty(L, dtype=torch.int64, device=dev)
    words = torch.empty((S, L), dtype=torch.int16, device=dev)
    emits = torch.empty((S, L), dtype=torch.bool, device=dev)
    ENCODE_KERNEL.launch(start16.data_ptr(), freqm1.data_ptr(), x.data_ptr(),
                         words.data_ptr(), emits.data_ptr(), S, L,
                         stream_handle(start16))
    return x, words, emits


def compact_streams_global(x, words, emits, esc, sym, n_images: int) -> dict:
    """Format-v3/v4 compaction (device_rans.py:602): per-image word blocks
    [2*n_lanes state words (hi, lo per lane), renorm words in (step, lane)
    order], written by a cumsum and a scatter onto unique positions.

    Returns buf int16 [S*L + 2L] (uint16 bits; image b occupies
    [img_begin[b], img_begin[b] + img_n[b])), img_n int32 [B], ebuf int32
    (escape values, image-major, position order) and ecount int32 [B]."""
    S, L = emits.shape
    nl = L // n_images

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
                            cols=None, rows=None, cdf_rows=None,
                            max_value=None, offsets=None):
    """Decode S steps over B*n_lanes lanes (the plain version of K4).

    Parametric mode: ``cols`` f32 [6, S, B*n_lanes] (m, b, A, C, B, L) from
    ``select_rows``; ``n_steps``-level bisection on ``eval_cdf_plain``.
    Row-table mode: ``rows`` int32 [S, B*n_lanes] into the integer
    ``cdf_rows`` with ``max_value``/``offsets``.
    Returns (sym int32 [S, BL], esc bool [S, BL], x int64, img_ptr int32);
    escaped positions hold a placeholder symbol until the escape patch."""
    S = cols.shape[1] if cols is not None else rows.shape[0]
    BL = x.shape[0]
    dev = x.device
    sym = torch.empty((S, BL), dtype=torch.int32, device=dev)
    esc_out = torch.empty((S, BL), dtype=torch.bool, device=dev)
    for s in range(S):
        cf = (x & _MASK16).to(torch.int32)
        lo = torch.zeros_like(cf)
        v_lo = torch.zeros_like(cf)
        if cols is not None:
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
        if cols is not None:
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


def rans_decode_phase(words, x, img_ptr, n_lanes: int, n_steps: int,
                      cols=None, rows=None, cdf_rows=None, max_value=None,
                      offsets=None):
    """K4 for CUDA tensors, the plain version for CPU tensors.  One block
    per image, one thread per lane; returns new carry tensors (the inputs
    are not modified).  ``n_lanes`` is below 32 or a multiple of 32 up to
    1024: the kernel's warp ballot names every lane of a full warp."""
    if not 1 <= n_lanes <= 1024 or (n_lanes > 32 and n_lanes % 32):
        raise ValueError(f"rans_decode_phase: n_lanes {n_lanes} is neither "
                         "in [1, 31] nor a multiple of 32 up to 1024")
    if words.device.type == "cpu":
        return rans_decode_phase_plain(words, x, img_ptr, n_lanes, n_steps,
                                       cols, rows, cdf_rows, max_value,
                                       offsets)
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("rans_decode_phase: inputs must be on a CUDA device")
    B = img_ptr.shape[0]
    BL = x.shape[0]
    if BL != B * n_lanes or x.dtype != torch.int64 \
            or img_ptr.dtype != torch.int32 or words.dtype != torch.int16:
        raise TypeError("rans_decode_phase: carry must be x int64 [B*n_lanes]"
                        ", img_ptr int32 [B]; words int16")
    if cols is not None:
        if cols.dtype != torch.float32 or cols.dim() != 3 \
                or cols.shape[0] != 6 or cols.shape[2] != BL:
            raise ValueError("rans_decode_phase: cols must be f32 [6, S, BL]")
        S = cols.shape[1]
        tabs = (cols,)
    else:
        if rows.dtype != torch.int32 or rows.dim() != 2 \
                or rows.shape[1] != BL:
            raise ValueError("rans_decode_phase: rows must be int32 [S, BL]")
        S = rows.shape[0]
        tabs = (rows, cdf_rows, max_value, offsets)
        if any(t.dtype != torch.int32 for t in tabs):
            raise TypeError("rans_decode_phase: row tables must be int32")
    for t in (words, x, img_ptr) + tabs:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("rans_decode_phase: inputs must be contiguous "
                             "on one CUDA device")
    x_out = torch.empty_like(x)
    ptr_out = torch.empty_like(img_ptr)
    sym = torch.empty((S, BL), dtype=torch.int32, device=dev)
    esc = torch.empty((S, BL), dtype=torch.bool, device=dev)
    if cols is not None:
        tab_args = (cols.data_ptr(), n_steps, None, None, 0, None, None)
    else:
        tab_args = (None, n_steps, rows.data_ptr(), cdf_rows.data_ptr(),
                    cdf_rows.shape[1], max_value.data_ptr(),
                    offsets.data_ptr())
    DECODE_KERNEL.launch(words.data_ptr(), words.numel(), x.data_ptr(),
                         img_ptr.data_ptr(), x_out.data_ptr(),
                         ptr_out.data_ptr(), sym.data_ptr(), esc.data_ptr(),
                         S, B, n_lanes, *tab_args, stream_handle(words))
    return sym, esc, x_out, ptr_out


def make_decoder(words: torch.Tensor, n_steps: int, esc_values: torch.Tensor,
                 esc_begin: torch.Tensor, n_lanes: int):
    """Bind a format-v3/v4 word buffer (device_rans.py:169, fmt="global").

    ``words``: int16 (uint16 bits) [W], all images' blocks concatenated;
    ``esc_values`` int32 (all images' escape values), ``esc_begin`` int32
    [B] per-image offsets into it.  Returns (init, decode):
    ``init(img_begin) -> carry``; ``decode(carry, rows, tables,
    n_steps_row=None, pre_cols=None) -> (carry, symbols [S*B*n_lanes])``
    in position order, escapes patched in from the side channel.  With
    ``pre_cols`` the phase decodes parametrically, else by bisection over
    ``tables["cdf_rows"][rows]``."""
    if esc_values.numel() == 0:
        esc_values = torch.zeros(1, dtype=torch.int32, device=words.device)

    def init(img_begin):
        x, ptr = rans_init_global(words, img_begin, n_lanes)
        return x, ptr, torch.zeros_like(esc_begin)

    def decode(carry, rows, tables, n_steps_row=None, pre_cols=None):
        x, ptr, esc_count = carry
        if pre_cols is not None:
            sym, esc, x, ptr = rans_decode_phase(words, x, ptr, n_lanes,
                                                 n_steps, cols=pre_cols)
        else:
            sym, esc, x, ptr = rans_decode_phase(
                words, x, ptr, n_lanes, n_steps_row or n_steps, rows=rows,
                cdf_rows=tables["cdf_rows"], max_value=tables["max_value"],
                offsets=tables["offsets"])
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
