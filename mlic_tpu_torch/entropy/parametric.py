"""Analytic quantized-Gaussian CDFs (port of ``mlic_tpu/entropy/parametric.py``).

For a row with Gaussian scale sigma and integer support [-c, c]
(L = 2c + 1 slots plus one escape slot), with per-row f32 constants
m = 1/(sigma*sqrt 2), b = -(c + 0.5)*m, B = 2^16 - 1 - L,
A = B / (G(L) - G(0)), C = -G(0)*A and G(k) = 0.5*erfc(-(k*m + b)):

    cdf(k) = k + round(clip(G(k)*A + C, 0, B)),   k = 0 .. L + 1,

so cdf(0) = 0, cdf(L) = 2^16 - 1, cdf(L+1) = 2^16, strictly increasing,
and the escape is row-independent: slot L <=> cf == 2^16 - 1.

The port's integer tables are its own: ``torch.erfc``/CUDA ``erfcf`` and
XLA's erfc differ in the last ulp on some inputs, so a few table entries
differ by +-1 from the JAX package's.  What binds encoder and decoder is
that both evaluate ONE function -- ``cdf_eval`` of ``csrc/cdf.cuh`` on the
card, shared by K2 (``eval_cdf``), the encoder's prep K7 and the decoder
K4; ``eval_cdf_plain`` on the CPU -- and that ``update``
checks the table for rANS validity and re-evaluates every entry in decode
and encode shape (``self_check``, ``self_check_encode``).  Each check
returns the number of entries that differ; 0 passes.
"""

from __future__ import annotations

import numpy as np
import torch

from mlic_tpu_torch.ops._build import KERNELS, stream_handle

PRECISION = 16
TOTAL = 1 << PRECISION

_TAIL_MASS = 1e-9
KERNEL = KERNELS["eval_cdf"]


def gaussian_row_params(scale_table: np.ndarray, tail_mass: float = _TAIL_MASS,
                        pad_row: bool = True):
    """Per-row f32 constants (parametric.py:57), scipy in float64.

    Returns (params f32 [n(+1), 6], cdf_lengths int32 (= L + 2),
    offsets int32 (= -c)).  The pad row (m=1000, b=-500) puts all mass on
    slot 0: cdf = [0, 2^16-1, 2^16]."""
    from scipy import stats

    st = np.asarray(scale_table, np.float64)
    mult = -stats.norm.ppf(tail_mass / 2)
    centers = np.ceil(st * mult).astype(np.int64)
    L = 2 * centers + 1
    if int(L.max()) + 1 >= TOTAL:
        raise ValueError("support too wide for 16-bit totals")
    B = (TOTAL - 1.0) - L
    m = 1.0 / (st * np.sqrt(2.0))
    b = -(centers + 0.5) * m
    G0 = stats.norm.cdf((-centers.astype(np.float64) - 0.5) / st)
    GL = stats.norm.cdf((centers.astype(np.float64) + 0.5) / st)
    A = B / (GL - G0)
    C = -G0 * A
    params = np.stack([m, b, A, C, B, L.astype(np.float64)], axis=1)
    lengths = (L + 2).astype(np.int32)
    offsets = (-centers).astype(np.int32)
    if pad_row:
        Bp = float(TOTAL - 2)
        params = np.concatenate(
            [params, [[1000.0, -500.0, Bp, 0.0, Bp, 1.0]]])
        lengths = np.concatenate([lengths, [3]]).astype(np.int32)
        offsets = np.concatenate([offsets, [0]]).astype(np.int32)
    return params.astype(np.float32), lengths, offsets


def _erfc(x: torch.Tensor) -> torch.Tensor:
    """``torch.erfc`` computed on the calling thread when ``x`` lies on the
    CPU.  There it is MKL's vector math, split over torch's threads; one
    multi-threaded call has come back with one thread's share many ulp off
    (a table that failed its own self-checks), so that a table would
    depend on the thread count and on the call.  On one thread every entry
    is one function of its input."""
    if x.device.type != "cpu":
        return torch.erfc(x)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.erfc(x)
    finally:
        torch.set_num_threads(threads)


def eval_cdf_plain(k, m, b, A, C, B):
    """cdf(k), int32, same shape as k; the five f32 columns have n elements
    and element i of k uses column entry i % n.  The op sequence (separate
    mul and add, round half to even) is the kernel's (csrc/cdf.cuh)."""
    n = m.numel()
    kk = k.reshape(-1, n)
    m, b, A, C, B = (c.reshape(n) for c in (m, b, A, C, B))
    g = 0.5 * _erfc(-(kk.float() * m + b))
    raw = torch.minimum(torch.clamp(g * A + C, min=0.0), B)
    return (kk + torch.round(raw).to(torch.int32)).reshape(k.shape)


def eval_cdf(k, m, b, A, C, B):
    """K2 for CUDA tensors, the plain version for CPU tensors."""
    if k.device.type == "cpu":
        return eval_cdf_plain(k, m, b, A, C, B)
    cols = (m, b, A, C, B)
    n = m.numel()
    if k.device.type != "cuda" or any(c.device != k.device for c in cols):
        raise ValueError("eval_cdf: inputs must share a CUDA device")
    if k.dtype != torch.int32 or any(c.dtype != torch.float32 for c in cols):
        raise TypeError("eval_cdf: k must be int32 and the columns float32")
    if any(c.numel() != n for c in cols) or n == 0 or k.numel() % n:
        raise ValueError("eval_cdf: columns must have equal sizes dividing "
                         "k's size")
    if not (k.is_contiguous() and all(c.is_contiguous() for c in cols)):
        raise ValueError("eval_cdf: inputs must be contiguous")
    out = torch.empty_like(k)
    KERNEL.launch(k.data_ptr(), *(c.data_ptr() for c in cols), out.data_ptr(),
                  k.numel(), n, stream_handle(k))
    return out


def generate_tables(params: torch.Tensor, cdf_lengths: np.ndarray) -> np.ndarray:
    """Integer CDF table [n, max_len] (zero beyond each row's length),
    evaluated by ``eval_cdf`` on ``params``' device (parametric.py:113)."""
    n = params.shape[0]
    max_len = int(np.max(cdf_lengths))
    k = torch.arange(max_len, dtype=torch.int32, device=params.device)
    k = k[:, None].expand(max_len, n).contiguous()        # cols vary along n
    cols = params.t().contiguous()
    tab = eval_cdf(k, *cols[:5]).t().cpu().numpy()
    out = np.zeros((n, max_len), np.int32)
    for i in range(n):
        li = int(cdf_lengths[i])
        out[i, :li] = tab[i, :li]
    return out


def validate_tables(table: np.ndarray, cdf_lengths: np.ndarray) -> int:
    """rANS validity (parametric.py:134): the number of rows that break
    cdf[0]=0, cdf[-1]=2^16, cdf[L]=2^16-1 or strict increase."""
    bad = 0
    for i in range(table.shape[0]):
        row = table[i, :int(cdf_lengths[i])].astype(np.int64)
        if (row[0] != 0 or row[-1] != TOTAL or row[-2] != TOTAL - 1
                or np.any(np.diff(row) <= 0)):
            bad += 1
    return bad


def self_check(params: torch.Tensor, table: np.ndarray,
               cdf_lengths: np.ndarray, n_lanes: int = 512) -> int:
    """Decode-shaped re-evaluation of every valid (row, k) entry
    (parametric.py:147): the row constants come through ``select_rows``
    (K1) in [steps, n_lanes] layout, then ``eval_cdf``.  Returns the number
    of entries that differ from ``table``."""
    from mlic_tpu_torch.ops.select_rows import select_rows

    n, max_len = table.shape
    rows = np.repeat(np.arange(n, dtype=np.int32), max_len)
    ks = np.tile(np.arange(max_len, dtype=np.int32), n)
    valid = ks < np.asarray(cdf_lengths, np.int64)[rows]
    rows, ks = rows[valid], ks[valid]
    n_valid = len(rows)
    pad = (-n_valid) % n_lanes
    dev = params.device
    rows_t = torch.from_numpy(np.concatenate(
        [rows, np.zeros(pad, np.int32)])).to(dev).reshape(-1, n_lanes)
    ks_t = torch.from_numpy(np.concatenate(
        [ks, np.zeros(pad, np.int32)])).to(dev).reshape(-1, n_lanes)
    cols = select_rows(rows_t, params)
    got = eval_cdf(ks_t, *cols[:5]).reshape(-1)[:n_valid].cpu().numpy()
    return int(np.count_nonzero(got != table[rows, ks]))


def self_check_encode(params: torch.Tensor, table: np.ndarray,
                      cdf_lengths: np.ndarray) -> int:
    """Encode-shaped re-evaluation (parametric.py:190): the production
    prep ``device_rans.rans_encode_prep`` (K7 on the card) over every
    (row, slot) the encoder can see, against the table's start, frequency
    and escape slot.  Returns the number of (row, slot) entries that
    differ."""
    from mlic_tpu_torch.entropy.device_rans import rans_encode_prep

    n, max_len = table.shape
    lengths = np.asarray(cdf_lengths, np.int64)
    centers = (lengths - 3) // 2            # L = len - 2 = 2c + 1
    k = np.arange(max_len - 1, dtype=np.int64)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, max_len - 1))
    sym = -centers[:, None] + k[None, :]
    dev = params.device
    sym_t = torch.from_numpy(sym.astype(np.int32)).to(dev)
    _, y = rans_encode_prep(
        sym_t, torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(dev),
        sym_t.new_zeros((n, 0)), {"row_params": params})
    st, fm, esc = (a.cpu().numpy() for a in y)
    bad = 0
    for i in range(n):
        mv = int(lengths[i]) - 2
        kk = np.arange(mv + 1)
        bad += int(np.count_nonzero(
            (st[i, :mv + 1] != table[i, kk])
            | (fm[i, :mv + 1] + 1 != table[i, kk + 1] - table[i, kk])
            | (esc[i, :mv + 1] != (kk == mv))))
    return bad


def bisect_steps(cdf_lengths: np.ndarray) -> int:
    """Bisection depth that pins the slot in [0, max L] (parametric.py:231)."""
    max_L = max(int(np.max(np.asarray(cdf_lengths) - 2)), 2)
    return int(np.ceil(np.log2(max_L)))
