"""Bound and rounding primitives and checkerboard geometry, NCHW.

Port of ``mlic_tpu/ops/math.py:22-130``.  ``lower_bound`` carries the JAX
package's gradient rule; ``quantize_ste`` rounds with an identity
gradient.  The checkerboard functions act on
the last two (H, W) axes, so they take the port's NCHW tensors.  Anchor
positions are (even row, odd col) U (odd row, even col), i.e. (h + w) odd.
The squeeze/unsqueeze pair packs a checkerboard field into a dense
``[..., H, W//2]`` grid; W must be even.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    """``max(x, bound)`` whose gradient passes where ``x >= bound`` or where
    the incoming gradient would push x up (``g < 0``), and is 0 elsewhere
    (math.py:22-36).  ``torch.maximum`` would split the gradient at ties,
    where GDN's reparametrised parameters start."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x, bound)
        return torch.maximum(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, bound = ctx.saved_tensors
        return torch.where((x >= bound) | (g < 0), g, torch.zeros_like(g)), \
            None


def _like(x: torch.Tensor, bound) -> torch.Tensor:
    """``bound`` as a 0-d tensor of ``x``'s dtype on its device; a python
    number is filled in place there (a copy from the host would wait for
    the device's queue)."""
    if torch.is_tensor(bound):
        return bound.to(dtype=x.dtype, device=x.device)
    return torch.full((), bound, dtype=x.dtype, device=x.device)


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    """``max(x, bound)`` with the gradient rule of ``_LowerBound``; no
    gradient reaches ``bound``."""
    bound = _like(x, bound)
    if not torch.is_grad_enabled() or not x.requires_grad:
        return torch.maximum(x, bound)
    return _LowerBound.apply(x, bound.detach())


def upper_bound(x: torch.Tensor, bound) -> torch.Tensor:
    return -lower_bound(-x, -_like(x, bound))


def quantize_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient (math.py:39)."""
    return x + (torch.round(x) - x).detach()


def ckbd_mask(h: int, w: int, dtype=torch.float32, device=None):
    """[H, W] mask, 1 at anchor positions ((h+w) odd)."""
    hh = torch.arange(h, device=device)[:, None]
    ww = torch.arange(w, device=device)[None, :]
    return ((hh + ww) % 2 == 1).to(dtype)


def ckbd_anchor(y: torch.Tensor) -> torch.Tensor:
    """Zero out non-anchor positions."""
    return y * ckbd_mask(y.shape[-2], y.shape[-1], y.dtype, y.device)


def ckbd_nonanchor(y: torch.Tensor) -> torch.Tensor:
    m = ckbd_mask(y.shape[-2], y.shape[-1], y.dtype, y.device)
    return y * (1.0 - m)


def ckbd_split(y: torch.Tensor):
    return ckbd_anchor(y), ckbd_nonanchor(y)


def ckbd_merge(anchor: torch.Tensor, nonanchor: torch.Tensor):
    return anchor + nonanchor


def _pack_rows(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows 2k <- even[k], 2k+1 <- odd[k]."""
    *lead, h2, w2 = even.shape
    return torch.stack([even, odd], dim=-2).reshape(*lead, 2 * h2, w2)


def ckbd_anchor_squeeze(y: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H, W//2]: row 2k takes y[2k, 1::2], row 2k+1
    takes y[2k+1, 0::2]."""
    return _pack_rows(y[..., 0::2, 1::2], y[..., 1::2, 0::2])


def ckbd_nonanchor_squeeze(y: torch.Tensor) -> torch.Tensor:
    return _pack_rows(y[..., 0::2, 0::2], y[..., 1::2, 1::2])


def _interleave_cols(dense: torch.Tensor, zeros_first: bool) -> torch.Tensor:
    """[..., H2, W2] -> [..., H2, 2*W2] with zeros between the columns."""
    z = torch.zeros_like(dense)
    pair = [z, dense] if zeros_first else [dense, z]
    *lead, h2, w2 = dense.shape
    return torch.stack(pair, dim=-1).reshape(*lead, h2, 2 * w2)


def ckbd_anchor_unsqueeze(anchor: torch.Tensor) -> torch.Tensor:
    """[..., H, W//2] -> [..., H, W], inverse of ``ckbd_anchor_squeeze``."""
    even = _interleave_cols(anchor[..., 0::2, :], zeros_first=True)
    odd = _interleave_cols(anchor[..., 1::2, :], zeros_first=False)
    return _pack_rows(even, odd)


def ckbd_nonanchor_unsqueeze(nonanchor: torch.Tensor) -> torch.Tensor:
    even = _interleave_cols(nonanchor[..., 0::2, :], zeros_first=False)
    odd = _interleave_cols(nonanchor[..., 1::2, :], zeros_first=True)
    return _pack_rows(even, odd)
