"""Fused residual-block tail: kernel K5 and its plain version.

``act2(pointwise1x1(depthwise3x3(gelu(mid)))) + skip`` with ``act2`` = GDN
``y * rsqrt(beta + y^2 @ gamma)``, IGDN ``y * sqrt(...)`` or tanh-GELU: the
tail of every residual block of g_a and g_s.  Port of
``mlic_tpu/ops/pallas_fused_block.py`` (``fused_block_tail``); the switch is
the same environment variable, read at each call.

Layout: NCHW, as the port's modules are (the JAX function is NHWC).  The
kernel reads ``mid`` [B, C, H, W] and ``skip`` [B, N, H, W] as they lie and
writes ``out`` [B, N, H, W]; nothing is copied, padded or transposed, so the
wrapper refuses a tensor that is not contiguous instead of copying it.
Weights come in the modules' own layouts (depthwise [C, 1, 3, 3], pointwise
[N, C, 1, 1]); ``gamma`` [N, N] and ``beta`` [N] are GDN's EFFECTIVE
parameters (after the lower-bound reparametrisation), ``gamma[d, n]`` as in
``norm_n = sum_d y_d^2 gamma[d, n]``.

Any H, W, C and N are taken; the JAX function's "returns None where the
shapes do not tile" has no counterpart.  Widths whose tile needs more shared
memory than a block may have raise.  Forward only, like the TPU kernel.

Rounding (``dt`` = the dtype of ``mid``; nothing is rounded when it is f32):
gelu(mid) is computed in f32 and rounded; the 9 taps and the depthwise bias
accumulate in f32 and are rounded once; the weights of the depthwise conv,
the pointwise kernel and gamma are rounded to ``dt``; both contractions
accumulate in f32; the pointwise bias and beta stay f32; y, y*y, the (r)sqrt
factor, y*factor and the sum with skip are each rounded.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from mlic_tpu_torch.ops._build import KERNELS, stream_handle

KERNEL = KERNELS["fused_block_tail"]
ACTS = {"gdn": 0, "igdn": 1, "gelu": 2}


def use_fused_blocks() -> bool:
    """Opt-in: ``MLIC_FUSED_BLOCKS=1`` (the codec and eval paths; the kernel
    has no backward, so training never sets it)."""
    return os.environ.get("MLIC_FUSED_BLOCKS", "0") == "1"


def _check(mid, skip, dw_weight, dw_bias, pw_weight, pw_bias, gamma, beta,
           act):
    if act not in ACTS:
        raise ValueError(f"fused_block_tail: act must be one of {list(ACTS)}")
    if mid.dim() != 4:
        raise ValueError("fused_block_tail: mid must be [B, C, H, W]")
    b, c, h, w = mid.shape
    n = pw_weight.shape[0]
    if skip.dtype != mid.dtype:
        raise TypeError(f"fused_block_tail: skip is {skip.dtype}, mid is "
                        f"{mid.dtype}; they must match")
    if mid.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_block_tail: mid must be float32 or bfloat16")
    if tuple(skip.shape) != (b, n, h, w):
        raise ValueError(f"fused_block_tail: skip is {tuple(skip.shape)}, "
                         f"expected {(b, n, h, w)}")
    shapes = {"dw_weight": (dw_weight, (c, 1, 3, 3)), "dw_bias": (dw_bias, (c,)),
              "pw_weight": (pw_weight, (n, c, 1, 1)), "pw_bias": (pw_bias, (n,))}
    if act != "gelu":
        if gamma is None or beta is None:
            raise ValueError(f"fused_block_tail: act={act!r} needs gamma "
                             "and beta")
        shapes.update(gamma=(gamma, (n, n)), beta=(beta, (n,)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_block_tail: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")


def fused_block_tail_plain(mid, skip, dw_weight, dw_bias, pw_weight, pw_bias,
                           gamma=None, beta=None, act: str = "gdn"):
    """The function in plain PyTorch, with the kernel's rounding points."""
    _check(mid, skip, dw_weight, dw_bias, pw_weight, pw_bias, gamma, beta, act)
    dt = mid.dtype

    def r(t):                       # a weight as the kernel sees it
        return t.to(dt).float()

    g = F.gelu(mid.float(), approximate="tanh").to(dt)
    a = F.conv2d(g.float(), r(dw_weight), r(dw_bias), padding=1,
                 groups=mid.shape[1]).to(dt)
    h = F.conv2d(a.float(), r(pw_weight)) + pw_bias.float()[:, None, None]
    if act == "gelu":
        y = F.gelu(h, approximate="tanh").to(dt)
    else:
        y = h.to(dt)
        norm = F.conv2d((y * y).float(), r(gamma).t()[:, :, None, None])
        norm = norm + beta.float()[:, None, None]
        fac = torch.sqrt(norm) if act == "igdn" else torch.rsqrt(norm)
        y = y * fac.to(dt)
    return y + skip


def fused_block_tail(mid, skip, dw_weight, dw_bias, pw_weight, pw_bias,
                     gamma=None, beta=None, act: str = "gdn"):
    """K5 for CUDA tensors, the plain version for CPU tensors.

    mid [B, C, H, W] and skip [B, N, H, W]: one dtype, f32 or bf16, NCHW
    contiguous.  dw_weight [C, 1, 3, 3], dw_bias [C], pw_weight [N, C, 1, 1],
    pw_bias [N], and for gdn/igdn the effective gamma [N, N] and beta [N]:
    f32, contiguous.  Returns [B, N, H, W] of mid's dtype."""
    if mid.device.type == "cpu":
        return fused_block_tail_plain(mid, skip, dw_weight, dw_bias,
                                      pw_weight, pw_bias, gamma, beta, act)
    _check(mid, skip, dw_weight, dw_bias, pw_weight, pw_bias, gamma, beta, act)
    weights = [dw_weight, dw_bias, pw_weight, pw_bias]
    if act != "gelu":
        weights += [gamma, beta]
    tensors = [mid, skip] + weights
    if mid.device.type != "cuda" or any(t.device != mid.device
                                        for t in tensors):
        raise ValueError("fused_block_tail: all tensors must share one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in weights):
        raise TypeError("fused_block_tail: weights must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_block_tail: mid, skip and the weights must be "
                         "contiguous (NCHW); the kernel copies nothing")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_block_tail: the kernel is forward only; "
                           "call it under torch.no_grad()")
    b, c, h, w = mid.shape
    n = pw_weight.shape[0]
    out = torch.empty_like(skip)
    KERNEL.launch(mid.data_ptr(), skip.data_ptr(), out.data_ptr(),
                  dw_weight.data_ptr(), dw_bias.data_ptr(),
                  pw_weight.data_ptr(), pw_bias.data_ptr(),
                  gamma.data_ptr() if act != "gelu" else None,
                  beta.data_ptr() if act != "gelu" else None,
                  b, c, n, h, w, ACTS[act], int(mid.dtype == torch.bfloat16),
                  stream_handle(mid))
    return out
