"""Image quality metrics on tensors: PSNR, SSIM, MS-SSIM (port of
``mlic_tpu/metrics.py``).  MS-SSIM follows Wang et al. 2003 (5 scales, 11x11
Gaussian window, sigma 1.5), the construction pytorch-msssim implements.

Public functions take NHWC tensors ``[B,H,W,C]``, as the JAX package's do,
and return 0-dim tensors on the inputs' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    mse = torch.mean(torch.square(a - b))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / torch.sum(g)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian blur, per channel.  x: [B,C,H,W]."""
    c, k = x.shape[1], kernel.shape[0]
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)


def _ssim_components(a, b, kernel, data_range):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _blur(a, kernel)
    mu_b = _blur(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # E[x^2] - mu^2 cancels in f32 on constant regions: variances come out
    # slightly negative and push cs above 1.  True variances are
    # nonnegative and |cov| <= sqrt(var_a * var_b): clamp both.
    sigma_aa = torch.clamp(_blur(a * a, kernel) - mu_aa, min=0.0)
    sigma_bb = torch.clamp(_blur(b * b, kernel) - mu_bb, min=0.0)
    sigma_ab = _blur(a * b, kernel) - mu_ab
    bound = torch.sqrt(sigma_aa * sigma_bb)
    sigma_ab = torch.minimum(torch.maximum(sigma_ab, -bound), bound)
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    a, b = _nchw(a), _nchw(b)
    s, _ = _ssim_components(a, b, _gaussian_kernel(device=a.device),
                            data_range)
    return torch.mean(s)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of [B,C,H,W], odd dims edge-padded to even first."""
    h, w = x.shape[2], x.shape[3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
    return F.avg_pool2d(x, 2)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    """Multi-scale SSIM over 5 scales; inputs [B,H,W,C], H,W >= 176."""
    a, b = _nchw(a), _nchw(b)
    kernel = _gaussian_kernel(device=a.device)
    last = len(_MSSSIM_WEIGHTS) - 1
    values = []
    for i in range(last + 1):
        s, cs = _ssim_components(a, b, kernel, data_range)
        values.append(torch.mean(s if i == last else cs))
        if i < last:
            a, b = _downsample2(a), _downsample2(b)
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=a.device)
    return torch.prod(torch.clamp(torch.stack(values), 1e-6, 1.0) ** weights)
