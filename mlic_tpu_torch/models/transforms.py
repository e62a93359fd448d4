"""Analysis / synthesis transforms g_a, h_a, h_s, g_s, NCHW.

Port of ``mlic_tpu/models/transforms.py:24-135``, depthwise or dense,
with either synthesis head.  ``dtype`` is the compute dtype of
g_a/h_a/g_s; their outputs are cast back to f32.  ``gdn_dtype`` is the
GDN/IGDN policy of g_a and g_s: ``None`` computes the norm in f32 with
casts around it, the compute dtype is the mixed policy (``layers.GDN``).
h_s always runs in f32: it feeds the entropy parameters.

An image's latent must not depend on its batch (its streams coded in a
batch equal its streams coded alone).  The convolutions of g_a and h_a
whose reductions cuDNN was seen to order by the batch on the H100
(``tools.batch_contract``'s hooks, at batches 8 to 128 of MLICPP_S,
MLICPP_L and the small decoder) are marked ``invariant``, which runs them
through ``ops/invariant_matmul`` (K8 when coding on the card): the 1x1
convolutions over the image's three channels, and in a dense encoder (the
small decoder's, and every configuration built with ``depthwise=False``)
every 3x3 convolution from g_a's last stage on: the two residual blocks
at an eighth of the image's size (dense MLICPP_S ordered their sums by
the batch at batch 8), g_a's last and every one of h_a.
"""

from __future__ import annotations

from torch import nn

from mlic_tpu_torch.models.layers import (
    Conv3x3,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv3x3,
    gelu,
)


class AnalysisTransform(nn.Module):
    """g_a: image [B,3,H,W] -> latent [B,M,H/16,W/16]."""

    def __init__(self, N: int, M: int, depthwise: bool = True, dtype=None,
                 gdn_dtype=None):
        super().__init__()
        dw, dt, gdt = depthwise, dtype, gdn_dtype
        self.dtype = dtype
        self.rbs0 = ResidualBlockWithStride(3, N, 2, dw, dt, gdt)
        self.rb0 = ResidualBlock(N, N, dw, dt)
        self.rbs1 = ResidualBlockWithStride(N, N, 2, dw, dt, gdt)
        self.rb1 = ResidualBlock(N, N, dw, dt)
        self.rbs2 = ResidualBlockWithStride(N, N, 2, dw, dt, gdt)
        self.rb2 = ResidualBlock(N, N, dw, dt)
        self.out = Conv3x3(N, M, 2, dw, dt)
        self.rbs0.skip.invariant = True
        if dw:
            self.rbs0.conv1.dw.point.invariant = True
        else:
            for m in (self.rbs2.conv1, self.rbs2.conv2, self.rb2.conv1,
                      self.rb2.conv2, self.out):
                m.conv.invariant = True

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for m in (self.rbs0, self.rb0, self.rbs1, self.rb1, self.rbs2,
                  self.rb2, self.out):
            x = m(x)
        return x.float()


class HyperAnalysis(nn.Module):
    """h_a: latent -> hyper-latent, stride 4."""

    def __init__(self, M: int, N: int, depthwise: bool = True, dtype=None):
        super().__init__()
        dw, dt = depthwise, dtype
        self.dtype = dtype
        self.c0 = Conv3x3(M, N, 1, dw, dt)
        self.c1 = Conv3x3(N, N, 1, dw, dt)
        self.c2 = Conv3x3(N, N, 2, dw, dt)
        self.c3 = Conv3x3(N, N, 1, dw, dt)
        self.c4 = Conv3x3(N, N, 2, dw, dt)
        if not dw:
            for m in (self.c0, self.c1, self.c2, self.c3, self.c4):
                m.conv.invariant = True

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for m in (self.c0, self.c1, self.c2, self.c3):
            x = gelu(m(x))
        return self.c4(x).float()


class HyperSynthesis(nn.Module):
    """h_s: z_hat [B,N,h/4,w/4] -> hyper params [B,2M,h,w], f32."""

    def __init__(self, M: int, N: int, depthwise: bool = True):
        super().__init__()
        dw = depthwise
        self.c0 = Conv3x3(N, M, 1, dw)
        self.up0 = SubpelConv3x3(M, M, 2)
        self.c1 = Conv3x3(M, M * 3 // 2, 1, dw)
        self.up1 = SubpelConv3x3(M * 3 // 2, M * 3 // 2, 2)
        self.c2 = Conv3x3(M * 3 // 2, M * 2, 1, dw)

    def forward(self, x):
        for m in (self.c0, self.up0, self.c1, self.up1):
            x = gelu(m(x))
        return self.c2(x)


class SynthesisTransform(nn.Module):
    """g_s: latent [B,M,h,w] -> image [B,3,16h,16w].  ``old_head``
    (``SynthesisTransformOld``, transforms.py:95) maps M to N in the first
    block, through its 1x1 skip, instead of keeping M."""

    def __init__(self, N: int, M: int, depthwise: bool = True, dtype=None,
                 gdn_dtype=None, old_head: bool = False):
        super().__init__()
        dw, dt, gdt = depthwise, dtype, gdn_dtype
        self.dtype = dtype
        head = N if old_head else M
        self.rb0 = ResidualBlock(M, head, dw, dt)
        self.up0 = ResidualBlockUpsample(head, N, 2, dw, dt, gdt)
        self.rb1 = ResidualBlock(N, N, dw, dt)
        self.up1 = ResidualBlockUpsample(N, N, 2, dw, dt, gdt)
        self.rb2 = ResidualBlock(N, N, dw, dt)
        self.up2 = ResidualBlockUpsample(N, N, 2, dw, dt, gdt)
        self.rb3 = ResidualBlock(N, N, dw, dt)
        self.out = SubpelConv3x3(N, 3, 2, dt)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for m in (self.rb0, self.up0, self.rb1, self.up1, self.rb2, self.up2,
                  self.rb3, self.out):
            x = m(x)
        return x.float()
