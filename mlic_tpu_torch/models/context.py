"""MEM++ entropy-model context modules, NCHW.

Port of ``mlic_tpu/models/context.py:46-322``: the checkerboard local
window attention (``LocalContext``, in the JAX package's shifted-correlation
form with the anchor mask derived from the geometry on every call), the
channel context, the two linear-complexity global attentions, the entropy
parameter head and the latent residual prediction.  All f32: these feed
the entropy parameters that encode and decode must compute bit-identically,
and an image's must not depend on its batch (a container is decoded
alone).  The long products whose reduction order cuBLAS and cuDNN pick by
the batch on the card -- the window fusion, the linear attentions' two
contractions, the two 5x5 reprojections -- go through
``ops/invariant_matmul`` (kernel K8 on the card when no gradient is
recorded; the layers are marked ``invariant``); the rest is plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.models.layers import (
    MLP,
    Conv3x3,
    Dense,
    DepthwiseConv2D,
    conv1x1,
    conv5x5,
    gelu,
)
from mlic_tpu_torch.ops import invariant_matmul as im
from mlic_tpu_torch.ops.math import (
    ckbd_anchor,
    ckbd_anchor_squeeze,
    ckbd_mask,
    ckbd_nonanchor,
    ckbd_nonanchor_squeeze,
    ckbd_nonanchor_unsqueeze,
)


def extract_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B,H,W,C] -> [B,H,W,window^2,C] zero-padded sliding windows (NHWC,
    like ``nn.Unfold(window, padding=(window-1)//2)``)."""
    p = (window - 1) // 2
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, p, p, p, p))
    return torch.stack([xp[:, i:i + h, j:j + w, :]
                        for i in range(window) for j in range(window)], 3)


def window_anchor_map(h: int, w: int, window: int, device=None):
    """[H*W, window^2] float map: 1 where the window slot lands on an
    in-bounds anchor position (context.py:63)."""
    m = ckbd_mask(h, w, device=device)[None, :, :, None]
    return extract_windows(m, window).reshape(h * w, window * window)


def _relative_position_index(window: int) -> np.ndarray:
    """Swin-style [w^2, w^2] index into a (2w-1)^2 bias table
    (context.py:70)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _correlation_index(window: int) -> np.ndarray:
    """[w^2, w^2]: for query slot u and key slot v, the index of the shifted
    correlation (v - u) among the (2w-1)^2 offsets."""
    P = window - 1
    offs = [(i, j) for i in range(window) for j in range(window)]
    return np.asarray([[(vy - uy + P) * (2 * P + 1) + (vx - ux + P)
                        for vy, vx in offs] for uy, ux in offs], np.int64)


class LocalContext(nn.Module):
    """Masked window attention over the decoded anchor half of a slice.

    Input [B,C,H,W] (non-anchor positions zero); output the spatial context
    [B,2C,H,W] for the non-anchor phase.  The per-window logits are
    assembled from the (2w-1)^2 shifted correlations of q and k, as in the
    JAX package (context.py:111-141)."""

    def __init__(self, dim: int, window_size: int = 5, num_heads: int = 2,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        win = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = Dense(dim, 3 * dim)
        self.rel_pos_table = nn.Parameter(
            torch.zeros((2 * win - 1) ** 2, num_heads))
        self.fusion = Dense(win * win * dim, 2 * dim)
        self.fusion.invariant = True
        self.proj = Dense(2 * dim, 2 * dim)
        self.norm2 = nn.LayerNorm(2 * dim, eps=1e-6)
        self.mlp = MLP(2 * dim, int(2 * dim * mlp_ratio), 2 * dim)
        self.register_buffer(
            "rel_idx", torch.from_numpy(_relative_position_index(win)),
            persistent=False)
        self.register_buffer(
            "corr_idx", torch.from_numpy(_correlation_index(win)),
            persistent=False)

    def forward(self, x):
        b, c, h, w = x.shape
        win = self.window_size
        ws2 = win * win
        heads = self.num_heads
        hd = c // heads
        L = h * w
        x = x.permute(0, 2, 3, 1)
        qkv = self.qkv(self.norm1(x)).reshape(b, h, w, 3, c)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

        wrad = win // 2
        P = win - 1
        H2, W2 = h + 2 * wrad, w + 2 * wrad
        qe = F.pad(q * hd ** -0.5, (0, 0, wrad, wrad, wrad, wrad))
        ke = F.pad(k, (0, 0, wrad + P, wrad + P, wrad + P, wrad + P))
        qe_h = qe.reshape(b, H2, W2, heads, hd)
        G = torch.stack([
            (qe_h * ke[:, dy:dy + H2, dx:dx + W2, :]
             .reshape(b, H2, W2, heads, hd)).sum(-1)
            for dy in range(2 * P + 1) for dx in range(2 * P + 1)], -1)

        # logits[p, u, v] = G[p + u, delta(v - u)]
        offs = [(i, j) for i in range(win) for j in range(win)]
        attn = torch.stack([G[:, uy:uy + h, ux:ux + w][..., self.corr_idx[u]]
                            for u, (uy, ux) in enumerate(offs)], 4)
        attn = attn.reshape(b, L, heads, ws2, ws2)
        bias = self.rel_pos_table[self.rel_idx.reshape(-1)].reshape(
            ws2, ws2, heads)
        attn = attn + bias.permute(2, 0, 1)[None, None]
        a = window_anchor_map(h, w, win, x.device)
        attn = attn + (-100.0 * (1.0 - a[:, :, None] * a[:, None, :]))[
            None, :, None]
        attn = torch.softmax(attn, dim=-1)

        ve = F.pad(v, (0, 0, wrad, wrad, wrad, wrad))
        vs = torch.stack([ve[:, vy:vy + h, vx:vx + w, :].reshape(
            b, L, heads, hd) for vy, vx in offs], 3)     # [b,L,heads,ws2,hd]
        out = torch.matmul(attn, vs)                      # [b,L,heads,ws2,hd]
        out = out.permute(0, 1, 3, 2, 4).reshape(b, L, ws2 * c)
        # Per-window fusion conv(k=win) == Dense over the flattened window,
        # (i*w + j)*C + c order.
        out = self.proj(self.fusion(out))
        out = out + self.mlp(self.norm2(out))
        return out.reshape(b, h, w, 2 * c).permute(0, 3, 1, 2)


class ChannelContext(nn.Module):
    """Decoded slices -> channel context [B,4*out,H,W] (context.py:179)."""

    def __init__(self, in_ch: int, out_dim: int, hidden=(192, 128),
                 depthwise: bool = True):
        super().__init__()
        self.c0 = Conv3x3(in_ch, hidden[0], 1, depthwise)
        self.c1 = Conv3x3(hidden[0], hidden[1], 1, depthwise)
        self.c2 = Conv3x3(hidden[1], out_dim * 4, 1, depthwise)

    def forward(self, x):
        return self.c2(gelu(self.c1(gelu(self.c0(x)))))


class _QKVConv(nn.Module):
    """1x1 conv + 3x3 depthwise conv (context.py:195)."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.pw = conv1x1(in_ch, dim)
        self.dw = DepthwiseConv2D(dim, 3)

    def forward(self, x):
        return self.dw(self.pw(x))


def _linear_attention(q, k, v, num_heads: int):
    """softmax(K over space)^T V, then times softmax(Q over head channels).
    q, k, v: [B, N, C] -> [B, N, C] (context.py:206); the two contractions
    batch-invariant (K8)."""
    b, n, c = q.shape
    hd = c // num_heads
    q = torch.softmax(q.reshape(b, n, num_heads, hd), dim=3)
    k = torch.softmax(k.reshape(b, n, num_heads, hd), dim=1)
    v = v.reshape(b, n, num_heads, hd)
    return im.ctx_q(im.kt_v(k, v), q).reshape(b, n, c)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B,H*W,C] (NHWC token order)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


class LinearGlobalInterContext(nn.Module):
    """Global attention across previously decoded slices (context.py:223)."""

    def __init__(self, dim: int, out_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.queries = _QKVConv(dim, dim)
        self.keys = _QKVConv(dim, dim)
        self.values = _QKVConv(dim, dim)
        mid = out_dim * 3 // 2
        self.reprojection = conv5x5(dim, mid, 1)
        self.reprojection.invariant = True
        self.mlp0 = conv1x1(mid, out_dim * 2)
        self.mlp1 = DepthwiseConv2D(out_dim * 2, 3)
        self.mlp2 = conv1x1(out_dim * 2, out_dim)
        self.skip = conv1x1(mid, out_dim)

    def forward(self, x):
        b, c, h, w = x.shape
        att = _linear_attention(_tokens(self.queries(x)), _tokens(self.keys(x)),
                                _tokens(self.values(x)), self.num_heads)
        att = self.reprojection(att.reshape(b, h, w, c).permute(0, 3, 1, 2))
        mlp = self.mlp2(gelu(self.mlp1(gelu(self.mlp0(att)))))
        return self.skip(att) + mlp


class LinearGlobalIntraContext(nn.Module):
    """Non-anchor queries of the previous slice attend to its anchor keys,
    with the current anchor as values, on the packed half-width grids
    (context.py:247)."""

    def __init__(self, dim: int, num_heads: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.queries = _QKVConv(dim, dim)
        self.keys = _QKVConv(dim, dim)
        self.values = _QKVConv(dim, dim)
        self.reprojection = conv5x5(dim, dim * 2, 1)
        self.reprojection.invariant = True
        self.mlp0 = conv1x1(dim * 2, dim * 4)
        self.mlp1 = DepthwiseConv2D(dim * 4, 3)
        self.mlp2 = conv1x1(dim * 4, dim * 2)

    def forward(self, x_prev, x_anchor):
        b, c, h, w = x_prev.shape
        q = _tokens(ckbd_nonanchor_squeeze(self.queries(ckbd_nonanchor(x_prev))))
        k = _tokens(ckbd_anchor_squeeze(self.keys(ckbd_anchor(x_prev))))
        v = _tokens(ckbd_anchor_squeeze(self.values(x_anchor)))
        att = _linear_attention(q, k, v, self.num_heads)
        att = ckbd_nonanchor_unsqueeze(
            att.reshape(b, h, w // 2, c).permute(0, 3, 1, 2))
        att = self.reprojection(att)
        mlp = self.mlp2(gelu(self.mlp1(gelu(self.mlp0(att)))))
        return att + mlp


class EntropyParameters(nn.Module):
    """Fused contexts -> (scales, means) (context.py:281)."""

    def __init__(self, in_ch: int, out_dim: int):
        super().__init__()
        self.c0 = conv1x1(in_ch, 320)
        self.c1 = conv1x1(320, 256)
        self.c2 = conv1x1(256, 128)
        self.c3 = conv1x1(128, out_dim)

    def forward(self, x):
        return self.c3(gelu(self.c2(gelu(self.c1(gelu(self.c0(x)))))))


class LatentResidualPrediction(nn.Module):
    """0.5*tanh-bounded rounding-residual prediction (context.py:297):
    three convolutions to widths 224, 128, ``out_dim``, or with
    ``old_wide`` (the small decoder's ``LatentResidualPredictionOld``)
    four, narrowing from ``in_ch`` to ``out_dim`` in even quarters."""

    def __init__(self, in_ch: int, out_dim: int, depthwise: bool = True,
                 old_wide: bool = False):
        super().__init__()
        if old_wide:
            diff = abs(out_dim - in_ch)
            dims = [in_ch - diff // 4, in_ch - diff // 2,
                    in_ch - diff * 3 // 4, out_dim]
        else:
            dims = [224, 128, out_dim]
        self.n_convs = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"c{i}", Conv3x3(in_ch, d, 1, depthwise))
            in_ch = d

    def forward(self, x):
        for i in range(self.n_convs):
            if i:
                x = gelu(x)
            x = getattr(self, f"c{i}")(x)
        return 0.5 * torch.tanh(x)
