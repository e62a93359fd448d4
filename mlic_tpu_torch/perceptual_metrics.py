"""LPIPS and DISTS perceptual metrics, eval-side (port of
``mlic_tpu/perceptual_metrics.py``; reference ``MLIC++/utils/metrics.py:
13-53``).

* ``LPIPSVgg``: five VGG16 stages, channel-unit-normalized feature
  differences squared, learned 1x1 linear heads (clamped to >= 0 at use,
  as the lpips package clamps them at load), spatial and stage sum (Zhang
  et al. 2018, the vgg variant).
* ``DISTS``: VGG16 with L2 pooling instead of max pooling, six feature
  groups (the input and five stages), global texture and structure
  statistics weighted by learned ``alpha``/``beta`` (Ding et al. 2020).

No pretrained weights are in the repository and none is fetched:
``init_lpips``/``init_dists`` draw seeded weights from the flax
initializers' families, ``weights.metric_from_flax`` carries the JAX
package's parameter trees over, and ``load_lpips_weights`` /
``load_dists_weights`` read local torch files (a torchvision VGG16
``features`` state_dict and the metric's own heads or alpha/beta).  Scores
mean something only with the real weights.

Images are NHWC in [0, 1]; both metrics return [B].  The trunk here has
five stages and, for DISTS, L2 pooling, so it is a second trunk beside
``perceptual.Vgg16Features`` (four stages, max pooling).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.device import resolve_device

# VGG16 conv widths per stage (through relu5_3).
STAGES5 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))
# those convolutions' indexes in torchvision's ``vgg16().features``
TORCHVISION_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# LPIPS input normalization (lpips.ScalingLayer; inputs in [-1, 1]).
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)
# DISTS input normalization (ImageNet mean/std; inputs in [0, 1]).
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_names() -> list:
    """``conv{stage}_{index}``, the flax module's names, in order."""
    return [f"conv{s + 1}_{c + 1}" for s, ws in enumerate(STAGES5)
            for c in range(len(ws))]


def _hamming_window() -> torch.Tensor:
    """The 3x3 Hamming^2 window of DISTS's L2 pooling, summing to 1."""
    win = np.hamming(3).astype(np.float32)
    k2 = np.outer(win, win)
    return torch.from_numpy((k2 / k2.sum()).astype(np.float32))


class Vgg16Stages(nn.Module):
    """The VGG16 ``features`` trunk through relu5_3, returning each
    stage's last post-ReLU map (NCHW).  ``l2_pool``: between stages a
    Hamming^2-weighted depthwise 3x3 convolution of x^2 at stride 2, then
    sqrt (DISTS); else 2x2 max pooling (LPIPS)."""

    def __init__(self, l2_pool: bool = False):
        super().__init__()
        cin = 3
        for name, width in zip(conv_names(), (w for ws in STAGES5
                                              for w in ws)):
            setattr(self, name, nn.Conv2d(cin, width, 3, padding=1))
            cin = width
        self.l2_pool = l2_pool
        self.register_buffer("window", _hamming_window(), persistent=False)

    def _pool(self, x):
        if not self.l2_pool:
            return F.max_pool2d(x, 2)
        c = x.shape[1]
        k = self.window.to(x.dtype).expand(c, 1, 3, 3)
        y = F.conv2d(x * x, k, stride=2, padding=1, groups=c)
        return torch.sqrt(torch.clamp(y, min=1e-12))

    def forward(self, x) -> list:
        names = iter(conv_names())
        feats = []
        for si, widths in enumerate(STAGES5):
            if si:
                x = self._pool(x)
            for _ in widths:
                x = F.relu(getattr(self, next(names))(x))
            feats.append(x)
        return feats


def _unit_normalize(f):
    return f * torch.rsqrt(torch.sum(f * f, 1, keepdim=True) + 1e-10)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


class LPIPSVgg(nn.Module):
    """LPIPS distance with the VGG trunk and learned linear heads
    ``lin{i}`` [C, 1] (the flax layout)."""

    def __init__(self):
        super().__init__()
        self.vgg = Vgg16Stages()
        for i, ws in enumerate(STAGES5):
            self.register_parameter(f"lin{i}",
                                    nn.Parameter(torch.zeros(ws[-1], 1)))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE),
                             persistent=False)

    def _norm_in(self, x):
        return ((2.0 * _nchw(x) - 1.0) - self.shift[:, None, None]) \
            / self.scale[:, None, None]

    def forward(self, a, b):
        """a, b: [B,H,W,3] in [0,1].  Returns [B] distances."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self.vgg(self._norm_in(a)),
                                         self.vgg(self._norm_in(b)))):
            d = torch.square(_unit_normalize(xa) - _unit_normalize(xb))
            w = torch.clamp(getattr(self, f"lin{i}")[:, 0], min=0.0)
            total = total + torch.mean(
                torch.sum(d * w[None, :, None, None], 1), (1, 2))
        return total


class DISTS(nn.Module):
    """DISTS score: 1 - the weighted structure/texture similarity, over
    the input and the five stages of the L2-pooled trunk; ``alpha`` and
    ``beta`` [sum of the widths] (the flax layout)."""

    def __init__(self):
        super().__init__()
        self.vgg = Vgg16Stages(l2_pool=True)
        n = 3 + sum(ws[-1] for ws in STAGES5)
        self.alpha = nn.Parameter(torch.zeros(n))
        self.beta = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD),
                             persistent=False)

    def forward(self, a, b):
        """a, b: [B,H,W,3] in [0,1].  Returns [B] scores (0 = identical)."""
        na = (_nchw(a) - self.mean[:, None, None]) / self.std[:, None, None]
        nb = (_nchw(b) - self.mean[:, None, None]) / self.std[:, None, None]
        fa = [na] + self.vgg(na)
        fb = [nb] + self.vgg(nb)
        w_sum = torch.sum(self.alpha) + torch.sum(self.beta)
        c1 = c2 = 1e-6
        score = 0.0
        off = 0
        for xa, xb in zip(fa, fb):
            c = xa.shape[1]
            al = self.alpha[off:off + c] / w_sum
            be = self.beta[off:off + c] / w_sum
            off += c
            mu_a = torch.mean(xa, (2, 3))
            mu_b = torch.mean(xb, (2, 3))
            var_a = torch.mean(xa * xa, (2, 3)) - mu_a * mu_a
            var_b = torch.mean(xb * xb, (2, 3)) - mu_b * mu_b
            cov = torch.mean(xa * xb, (2, 3)) - mu_a * mu_b
            s_mean = (2.0 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b
                                                 + c1)
            s_var = (2.0 * cov + c2) / (var_a + var_b + c2)
            score = score + torch.sum(al * s_mean + be * s_var, -1)
        return 1.0 - score


def _init_trunk(generator: torch.Generator, prefix: str = "vgg.") -> dict:
    """flax ``nn.Conv``'s initializers: lecun_normal kernels, zero biases."""
    from mlic_tpu_torch.weights import lecun_normal
    out, cin = {}, 3
    for name, width in zip(conv_names(), (w for ws in STAGES5 for w in ws)):
        out[f"{prefix}{name}.weight"] = lecun_normal((width, cin, 3, 3),
                                                     generator)
        out[f"{prefix}{name}.bias"] = torch.zeros(width)
        cin = width
    return out


def init_lpips(generator: torch.Generator) -> dict:
    """Seeded LPIPSVgg state_dict: the trunk as flax initializes it, the
    heads uniform in [0, 0.1) (``nn.initializers.uniform(0.1)``)."""
    sd = _init_trunk(generator)
    for i, ws in enumerate(STAGES5):
        sd[f"lin{i}"] = torch.rand(ws[-1], 1, generator=generator) * 0.1
    return sd


def init_dists(generator: torch.Generator) -> dict:
    """Seeded DISTS state_dict: the trunk as flax initializes it, alpha
    and beta 0.1."""
    sd = _init_trunk(generator)
    n = 3 + sum(ws[-1] for ws in STAGES5)
    sd["alpha"] = torch.full((n,), 0.1)
    sd["beta"] = torch.full((n,), 0.1)
    return sd


def _load_vgg_trunk(path: str) -> dict:
    """torchvision VGG16 state_dict file (``features.{i}.weight``/``bias``)
    -> the trunk's entries of a metric's state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for name, idx in zip(conv_names(), TORCHVISION_CONV_INDEX):
        out[f"vgg.{name}.weight"] = sd[f"features.{idx}.weight"].float()
        out[f"vgg.{name}.bias"] = sd[f"features.{idx}.bias"].float()
    return out


def load_lpips_weights(state_dict: dict, vgg_features_path: str,
                       lpips_lin_path: str) -> dict:
    """A copy of an LPIPSVgg ``state_dict`` with the trunk from a local
    torchvision VGG16 file and the heads from the lpips package's
    ``vgg.pth`` (``lin{i}.model.1.weight`` [1, C, 1, 1] -> [C, 1])."""
    out = dict(state_dict)
    out.update(_load_vgg_trunk(vgg_features_path))
    lin = torch.load(lpips_lin_path, map_location="cpu", weights_only=True)
    for i in range(len(STAGES5)):
        out[f"lin{i}"] = lin[f"lin{i}.model.1.weight"][:, :, 0, 0].t() \
            .float().contiguous()
    return out


def load_dists_weights(state_dict: dict, dists_path: str,
                       vgg_features_path: str | None = None) -> dict:
    """A copy of a DISTS ``state_dict`` with ``alpha`` and ``beta`` from the
    official ``weights.pt`` ([1, sum C, 1, 1] each) and, where given, the
    trunk from a torchvision VGG16 file (the official repository builds its
    trunk from torchvision, so the tensors are the same)."""
    sd = torch.load(dists_path, map_location="cpu", weights_only=True)
    out = dict(state_dict)
    out["alpha"] = sd["alpha"].reshape(-1).float()
    out["beta"] = sd["beta"].reshape(-1).float()
    if vgg_features_path:
        out.update(_load_vgg_trunk(vgg_features_path))
    return out


def _metric_fn(model: nn.Module, state_dict: dict, device):
    model.load_state_dict(state_dict)
    model = model.to(resolve_device(device)).eval()

    def fn(a, b):
        with torch.no_grad():
            return model(a, b)
    return fn


def lpips_fn(state_dict: dict, device=None):
    """``(a, b) -> [B]`` LPIPS distances on ``device`` (the card unless
    ``"cpu"``)."""
    return _metric_fn(LPIPSVgg(), state_dict, device)


def dists_fn(state_dict: dict, device=None):
    """``(a, b) -> [B]`` DISTS scores on ``device`` (the card unless
    ``"cpu"``)."""
    return _metric_fn(DISTS(), state_dict, device)
