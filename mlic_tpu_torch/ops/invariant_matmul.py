"""Batch-invariant f32 products of the entropy path: kernel K8 and its
plain version.

An image's entropy parameters must not depend on what else is in its
batch: a stream encoded in a batch is decoded alone (a container a file)
and must see the same floats.  On the card, cuBLAS and cuDNN choose their
kernel, and with it the order of a long reduction, by the problem's size,
so a product whose rows span the batch can round an image otherwise at
another batch size.  K8 (``csrc/invariant_matmul.cu``) computes each
output as one f32 FFMA chain over k = 0 .. K-1 from 0, the bias after, so
an image's rows are the same floats at every batch and under every tile
the launch picks, in one launch a product.

The products (JAX counterparts in ``mlic_tpu/models/context.py``):
``linear`` the local context's window fusion (:172), ``kt_v`` and
``ctx_q`` the linear attentions' contractions (:218-219), ``conv2d`` the
5x5 reprojections of the global contexts (:237, :272).

Dispatch, one rule for every product here:

================================================  ==========================
Case                                              What runs
================================================  ==========================
CUDA tensor, no gradient recorded (coding)        K8
A gradient recorded (training; its products       the batched PyTorch op
are never decoded), any device
CPU tensor, no gradient                           the plain version: the
                                                  same PyTorch op an image
                                                  at a time
any other device (the meta device of a FLOP       the batched PyTorch op
count, ``tools.macs``)
================================================  ==========================

bfloat16 takes two shapes, the analysis convolutions': a product of K
at most 4 (g_a's 1x1 convolutions over the image's three channels), and a
3x3 "SAME" convolution of stride 1 or 2 whose output channels N are a
multiple of 32, 64 or 96 and whose input channels are even (the dense
encoder's g_a.out and h_a at every width of the configurations: N 32,
96, 160, 192, 320).  Everything else is float32.

K8 never gives way to the plain version: a shape or type it does not
take (its C launch function's ``valid``: a convolution window other than
1, 3 or 5, say, or bfloat16 outside the two shapes above), a failed
build or a failed launch raises.  ``ROUTE`` other than "auto" forces one route
("kernel", "batched" or "plain") for every call: the smoke run sets it to
time and check K8 against the other two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mlic_tpu_torch.ops._build import KERNELS, stream_handle

KERNEL = KERNELS["invariant_matmul"]
ROUTE = "auto"
_LL4 = ctypes.c_longlong * 4


class Problem(ctypes.Structure):
    """``struct Problem`` of ``csrc/invariant_matmul.cu``."""
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("c", ctypes.c_void_p),
                ("a_s", _LL4), ("b_s", _LL4), ("c_s", _LL4),
                ("groups0", ctypes.c_int), ("groups1", ctypes.c_int),
                ("m", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
                ("window", ctypes.c_int), ("stride", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("bf16", ctypes.c_int)]


def route(*ts: torch.Tensor) -> str:
    """"kernel", "batched" or "plain" for a product of ``ts``, by the rule
    of the module's docstring (or ``ROUTE`` where it is not "auto")."""
    if ROUTE != "auto":
        return ROUTE
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return "batched"
    dev = ts[0].device.type
    if dev == "cuda":
        return "kernel"
    return "plain" if dev == "cpu" else "batched"


def per_image(fn, *xs):
    """``fn`` on each image (index of the first axis) alone, the results
    concatenated: what the plain version of every product is."""
    if xs[0].shape[0] == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


def _launch(a, b, bias, c, groups, mnk, a_s, b_s, c_s, window=0,
            stride=1, hw=(0, 0)) -> None:
    ts = [a, b, c] + ([] if bias is None else [bias])
    if any(t.device.type != "cuda" or t.device != c.device for t in ts):
        raise ValueError("invariant_matmul: operands must share a CUDA "
                         "device")
    if {t.dtype for t in ts} not in ({torch.float32}, {torch.bfloat16}):
        raise TypeError("invariant_matmul: operands must be all float32 or "
                        f"all bfloat16, got {[t.dtype for t in ts]}")
    if bias is not None and (bias.shape != (mnk[1],)
                             or not bias.is_contiguous()):
        raise ValueError(f"invariant_matmul: bias of shape "
                         f"{tuple(bias.shape)} for {mnk[1]} outputs")
    if min(mnk) < 1 or max(mnk) >= 2**31:
        raise ValueError(f"invariant_matmul: problem (M, N, K) = {mnk}")
    p = Problem(a.data_ptr(), b.data_ptr(),
                None if bias is None else bias.data_ptr(), c.data_ptr(),
                _LL4(*a_s), _LL4(*b_s), _LL4(*c_s), groups[0], groups[1],
                *mnk, window, stride, *hw, int(c.dtype == torch.bfloat16))
    KERNEL.launch(ctypes.addressof(p), stream_handle(c))


def _dispatch(fn, xs: tuple, kernel, params=()):
    """``fn(*xs)`` by the route of ``xs`` and ``params`` (weights):
    batched, an image at a time, or ``kernel()``."""
    r = route(*xs, *(t for t in params if t is not None))
    if r == "batched":
        return fn(*xs)
    if r == "plain":
        return per_image(fn, *xs)
    if r == "kernel":
        return kernel()
    raise ValueError(f"invariant_matmul: unknown route {r!r}")


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` over x [B, ..., K] (weight [N, K]),
    each image's rows batch-invariant: B problems of (rows an image) x N x
    K in one launch."""
    def kernel():
        b, k, n = x.shape[0], x.shape[-1], weight.shape[0]
        if weight.shape != (n, k):
            raise ValueError(f"linear: weight {tuple(weight.shape)} for "
                             f"K={k}")
        x2 = x.reshape(b, -1, k)
        m = x2.shape[1]
        out = torch.empty((b, m, n), dtype=x.dtype, device=x.device)
        _launch(x2, weight, bias, out, (b, 1), (m, n, k),
                (x2.stride(0), 0, x2.stride(1), x2.stride(2)),
                (0, 0, weight.stride(1), weight.stride(0)),
                (out.stride(0), 0, out.stride(1), out.stride(2)))
        return out.reshape(*x.shape[:-1], n)
    return _dispatch(lambda x1: F.linear(x1, weight, bias), (x,), kernel,
                     (weight, bias))


def kt_v(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bnhd,bnhe->bhde", k, v)``: B x heads problems of hd x hd x
    n in one launch."""
    def kernel():
        b, n, h, d = k.shape
        if v.shape[:3] != (b, n, h):
            raise ValueError(f"kt_v: k {tuple(k.shape)}, v {tuple(v.shape)}")
        out = torch.empty((b, h, d, v.shape[3]), dtype=k.dtype,
                          device=k.device)
        ks, vs, os_ = k.stride(), v.stride(), out.stride()
        _launch(k, v, None, out, (b, h), (d, v.shape[3], n),
                (ks[0], ks[2], ks[3], ks[1]), (vs[0], vs[2], vs[1], vs[3]),
                os_)
        return out
    return _dispatch(lambda k1, v1: torch.einsum("bnhd,bnhe->bhde", k1, v1),
                     (k, v), kernel)


def ctx_q(ctx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``einsum("bhde,bnhd->bnhe", ctx, q)``: B x heads problems of n x hd
    x hd in one launch.  K8's result is a [B, n, heads, hd] view of
    channel-first memory [B, heads, hd, n], so the 5x5 reprojection that
    follows the attention reads rows of pixels, with no copy between."""
    def kernel():
        b, n, h, d = q.shape
        e = ctx.shape[3]
        if ctx.shape[:3] != (b, h, d):
            raise ValueError(f"ctx_q: ctx {tuple(ctx.shape)}, q "
                             f"{tuple(q.shape)}")
        out = torch.empty((b, h, e, n), dtype=q.dtype, device=q.device)
        qs, os_ = q.stride(), out.stride()
        _launch(q, ctx, None, out, (b, h), (n, e, d),
                (qs[0], qs[2], qs[1], qs[3]), ctx.stride(),
                (os_[0], os_[1], os_[3], os_[2]))
        return out.permute(0, 3, 1, 2)
    return _dispatch(lambda c1, q1: torch.einsum("bhde,bnhd->bnhe", c1, q1),
                     (ctx, q), kernel)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, k // 2)``, a "SAME" convolution
    of odd window k over x [B, C, H, W] (any strides), weight
    [N, C, k, k]: B problems of (output pixels) x N x C*k*k in one launch;
    A is the window gather of x (a 1x1 window of stride 1 reads x in
    place)."""
    win = weight.shape[-1]

    def op(x1):
        return F.conv2d(x1, weight, bias, stride, win // 2)

    def kernel():
        b, c, hh, ww = x.shape
        n = weight.shape[0]
        if weight.shape != (n, c, win, win):
            raise ValueError(f"conv2d: weight {tuple(weight.shape)} for "
                             f"{c} channels (square windows only)")
        oh, ow = (hh - 1) // stride + 1, (ww - 1) // stride + 1
        w2 = weight.reshape(n, -1)
        out = torch.empty((b, n, oh, ow), dtype=x.dtype, device=x.device)
        xs = x.stride()
        b_s = (0, 0, w2.stride(1), w2.stride(0))
        c_s = (out.stride(0), 0, 1, oh * ow)
        if win == 1 and stride == 1 and xs[2] == ww * xs[3]:
            _launch(x, w2, bias, out, (b, 1), (hh * ww, n, c),
                    (xs[0], 0, xs[3], xs[1]), b_s, c_s)
        else:
            _launch(x, w2, bias, out, (b, 1), (oh * ow, n, c * win * win),
                    xs, b_s, c_s, window=win, stride=stride, hw=(hh, ww))
        return out
    return _dispatch(op, (x,), kernel, (weight, bias))
