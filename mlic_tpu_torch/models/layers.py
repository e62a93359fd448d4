"""NN layer primitives, NCHW (port of ``mlic_tpu/models/layers.py``).

Parameter names follow the flax modules (``weight``/``bias`` for flax's
``kernel``/``bias``, ``beta``/``gamma`` for GDN), so a flax tree maps onto
the state_dict by path (``mlic_tpu_torch/weights.py``).  Unlike flax,
torch modules need their input width at construction.  ``dtype`` is the
compute dtype (``None``: as the JAX module infers it); parameters are f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.ops import invariant_matmul as im
from mlic_tpu_torch.ops.fused_block import fused_block_tail, use_fused_blocks
from mlic_tpu_torch.ops.math import lower_bound


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.gelu`` is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """flax ``nn.Dense`` over the last axis; weight [out, in].  With
    ``invariant`` set, each image's rows batch-invariant
    (``ops/invariant_matmul``: K8 on the card when no gradient is
    recorded)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.invariant = False

    def forward(self, x):
        linear = im.linear if self.invariant else F.linear
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with symmetric ("SAME" for odd k) padding; OIHW.
    With ``invariant`` set, batch-invariant as ``Dense``'s."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, dtype=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.zeros(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(features))
        self.stride = stride
        self.dtype = dtype
        self.invariant = False

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if self.invariant:
            return im.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                             self.stride)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.weight.shape[-1] // 2)


class DepthwiseConv2D(nn.Module):
    """Depthwise kxk conv, symmetric padding (layers.py:23); weight
    [C, 1, k, k].  Computes in ``dtype`` or the input's dtype."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 dtype=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.zeros(channels, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.stride = stride
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.weight.shape[-1] // 2,
                        groups=self.weight.shape[0])


class PointwiseConv(nn.Module):
    """1x1 conv (layers.py:78); a strided 1x1 conv is subsampling.  With
    ``invariant`` set, batch-invariant as ``Conv2d``'s."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))
        self.stride = stride
        self.dtype = dtype
        self.invariant = False

    def forward(self, x):
        if self.stride != 1:
            x = x[..., ::self.stride, ::self.stride]
        dt = self.dtype or x.dtype
        conv = im.conv2d if self.invariant else F.conv2d
        return conv(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv1x1(in_ch: int, features: int, stride: int = 1, dtype=None):
    return PointwiseConv(in_ch, features, stride, dtype=dtype)


def conv5x5(in_ch: int, features: int, stride: int = 2, dtype=None):
    return Conv2d(in_ch, features, 5, stride, dtype=dtype)


class DepthwiseSeparableConv(nn.Module):
    """3x3 depthwise + 1x1 pointwise (layers.py:62)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.depth = DepthwiseConv2D(in_ch, kernel_size, stride, dtype)
        self.point = PointwiseConv(in_ch, features, dtype=dtype)

    def forward(self, x):
        return self.point(self.depth(x))


class Conv3x3(nn.Module):
    """conv3x3 factory: depthwise-separable (child ``dw``) or dense
    (child ``conv``), layers.py:115."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 depthwise: bool = True, dtype=None):
        super().__init__()
        if depthwise:
            self.dw = DepthwiseSeparableConv(in_ch, features, 3, stride, dtype)
        else:
            self.conv = Conv2d(in_ch, features, 3, stride, dtype)
        self.depthwise = depthwise

    def forward(self, x):
        return self.dw(x) if self.depthwise else self.conv(x)


class SubpelConv3x3(nn.Module):
    """3x3 conv to r^2 x channels + pixel shuffle in torch's (c, rh, rw)
    channel order (layers.py:139)."""

    def __init__(self, in_ch: int, features: int, upscale: int = 2,
                 dtype=None):
        super().__init__()
        self.conv = Conv2d(in_ch, features * upscale * upscale, 3, dtype=dtype)
        self.upscale = upscale

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.upscale)


class GDN(nn.Module):
    """Generalized divisive normalization (layers.py:158).

    ``dtype=None`` computes the norm in f32, casting the input in and out.
    ``dtype=bfloat16`` with a bf16 input is the mixed policy: x^2 and gamma
    rounded to bf16, contracted with f32 accumulation, beta and the
    (r)sqrt in f32, the factor cast back."""

    _OFFSET = 2.0 ** -18

    def __init__(self, channels: int, inverse: bool = False, dtype=None,
                 beta_min: float = 1e-6):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(channels))
        self.gamma = nn.Parameter(torch.zeros(channels, channels))
        self.inverse = inverse
        self.dtype = dtype
        self.beta_min = beta_min

    def _norm(self, sq: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
        # norm_c = sum_d x_d^2 gamma[d, c] + beta_c (flax einsum bhwd,dc)
        w = gamma.t().contiguous()[:, :, None, None]
        return F.conv2d(sq, w) + beta[:, None, None]

    def forward(self, x):
        gamma, beta = _gdn_effective(self)
        in_dtype = x.dtype
        if self.dtype is not None and x.dtype == self.dtype:
            norm = self._norm((x * x).float(),
                              gamma.to(self.dtype).float(), beta)
            factor = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
            return x * factor.to(in_dtype)
        x = x.float()
        norm = self._norm(x * x, gamma, beta)
        out = x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))
        return out.to(in_dtype)


def _gdn_effective(gdn: GDN):
    """GDN's effective (post-reparametrisation) gamma [d, c] and beta
    (layers.py:209)."""
    ped = gdn._OFFSET ** 2
    beta = lower_bound(gdn.beta, (gdn.beta_min + ped) ** 0.5) ** 2 - ped
    gamma = lower_bound(gdn.gamma, ped ** 0.5) ** 2 - ped
    return gamma, beta


def _fused_tail(mid, skip, conv: "Conv3x3", act: str, gdn: GDN | None = None):
    """The fused block tail (kernel K5) of a residual block, or None where
    the block keeps its unfused tail (layers.py:217): the switch is off, the
    block is a dense-conv twin, or GDN's dtype policy is not one the kernel
    computes (all-f32, or the bf16-mixed policy)."""
    if not (use_fused_blocks() and conv.depthwise):
        return None
    gamma = beta = None
    if act != "gelu":
        if not ((gdn.dtype is None and mid.dtype == torch.float32)
                or gdn.dtype == mid.dtype):
            return None
        gamma, beta = _gdn_effective(gdn)
    dw = conv.dw
    return fused_block_tail(mid, skip, dw.depth.weight, dw.depth.bias,
                            dw.point.weight, dw.point.bias, gamma, beta,
                            act=act)


class ResidualBlockWithStride(nn.Module):
    """conv3x3(s) - GELU - conv3x3 - GDN + 1x1 strided skip (layers.py:243)."""

    def __init__(self, in_ch: int, features: int, stride: int = 2,
                 depthwise: bool = True, dtype=None, gdn_dtype=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, stride, depthwise, dtype)
        self.conv2 = Conv3x3(features, features, 1, depthwise, dtype)
        self.gdn = GDN(features, dtype=gdn_dtype)
        if stride != 1 or in_ch != features:
            self.skip = conv1x1(in_ch, features, stride, dtype)
        else:
            self.skip = None

    def forward(self, x):
        mid = self.conv1(x)
        if self.skip is not None:
            x = self.skip(x)
        fused = _fused_tail(mid, x, self.conv2, "gdn", self.gdn)
        if fused is not None:
            return fused
        return self.gdn(self.conv2(gelu(mid))) + x


class ResidualBlockUpsample(nn.Module):
    """subpel - GELU - conv3x3 - IGDN + subpel skip (layers.py:271)."""

    def __init__(self, in_ch: int, features: int, upsample: int = 2,
                 depthwise: bool = True, dtype=None, gdn_dtype=None):
        super().__init__()
        self.subpel = SubpelConv3x3(in_ch, features, upsample, dtype)
        self.conv = Conv3x3(features, features, 1, depthwise, dtype)
        self.igdn = GDN(features, inverse=True, dtype=gdn_dtype)
        self.upsample = SubpelConv3x3(in_ch, features, upsample, dtype)

    def forward(self, x):
        mid = self.subpel(x)
        skip = self.upsample(x)
        fused = _fused_tail(mid, skip, self.conv, "igdn", self.igdn)
        if fused is not None:
            return fused
        return self.igdn(self.conv(gelu(mid))) + skip


class ResidualBlock(nn.Module):
    """conv3x3 - GELU - conv3x3 - GELU + skip (layers.py:297)."""

    def __init__(self, in_ch: int, features: int, depthwise: bool = True,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, 1, depthwise, dtype)
        self.conv2 = Conv3x3(features, features, 1, depthwise, dtype)
        self.skip = (conv1x1(in_ch, features, dtype=dtype)
                     if in_ch != features else None)

    def forward(self, x):
        mid = self.conv1(x)
        if self.skip is not None:
            x = self.skip(x)
        fused = _fused_tail(mid, x, self.conv2, "gelu")
        if fused is not None:
            return fused
        return gelu(self.conv2(gelu(mid))) + x


class MLP(nn.Module):
    """Linear - GELU - Linear over the last axis (layers.py:368)."""

    def __init__(self, in_features: int, hidden: int, features: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, features)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class ResidualBottleneck(nn.Module):
    """1x1 down - act - dense 3x3 - act - 1x1 up + skip (layers.py:320);
    the width must be even.  Unused by the MLIC++ transforms, kept for
    parity with the JAX package."""

    def __init__(self, features: int):
        super().__init__()
        n = features
        self.reduce = conv1x1(n, n // 2)
        self.conv = Conv2d(n // 2, n // 2, 3)
        self.expand = conv1x1(n // 2, n)

    def forward(self, x):
        out = gelu(self.conv(gelu(self.reduce(x))))
        return x + self.expand(out)


class AttentionBlock(nn.Module):
    """Cheng'20 sigmoid-gated dual-branch attention (layers.py:337): two
    branches of three residual units (1x1 down, GELU, ``Conv3x3``, GELU,
    1x1 up, GELU of the sum), the second projected by ``b_proj`` and gating
    the first.  Unused by the MLIC++ transforms."""

    def __init__(self, features: int, depthwise: bool = True):
        super().__init__()
        n = features
        for br in ("a", "b"):
            for i in range(3):
                name = f"{br}{i}"
                self.add_module(f"{name}_in", conv1x1(n, n // 2))
                self.add_module(f"{name}_mid",
                                Conv3x3(n // 2, n // 2, 1, depthwise))
                self.add_module(f"{name}_out", conv1x1(n // 2, n))
        self.b_proj = conv1x1(n, n)

    def _unit(self, h, name):
        out = gelu(getattr(self, f"{name}_in")(h))
        out = gelu(getattr(self, f"{name}_mid")(out))
        return gelu(h + getattr(self, f"{name}_out")(out))

    def forward(self, x):
        a = b = x
        for i in range(3):
            a = self._unit(a, f"a{i}")
            b = self._unit(b, f"b{i}")
        return x + a * torch.sigmoid(self.b_proj(b))
