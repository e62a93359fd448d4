"""Rate-distortion losses (port of ``mlic_tpu/loss.py``; reference
``MLIC++/loss/rd_loss.py``).

bpp = sum(log2 likelihoods) / (-B·H·W); loss = λ·255²·MSE + bpp (mse,
charbonnier) or λ·(1 − MS-SSIM) + bpp.  ``output["x_hat"]`` and ``target``
are NHWC images in [0, 1]; the likelihood tensors may have any layout.
"""

from __future__ import annotations

import math

import torch

from mlic_tpu_torch.metrics import ms_ssim


def bpp_loss(likelihoods: dict, num_pixels: int) -> torch.Tensor:
    total = 0.0
    for lk in likelihoods.values():
        total = total + torch.sum(torch.log(lk)) / (-math.log(2) * num_pixels)
    return total


def charbonnier(x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt(torch.square(x - y) + eps ** 2))


def rate_distortion_loss(output: dict, target: torch.Tensor, lmbda,
                         metric: str = "mse") -> dict:
    b, h, w, _ = target.shape
    out = {"bpp_loss": bpp_loss(output["likelihoods"], b * h * w)}
    if metric == "mse":
        out["mse_loss"] = torch.mean(torch.square(output["x_hat"] - target))
        out["loss"] = lmbda * 255.0 ** 2 * out["mse_loss"] + out["bpp_loss"]
    elif metric == "ms-ssim":
        out["ms_ssim_loss"] = 1.0 - ms_ssim(output["x_hat"], target, 1.0)
        out["loss"] = lmbda * out["ms_ssim_loss"] + out["bpp_loss"]
    elif metric == "charbonnier":
        out["charbonnier_loss"] = charbonnier(output["x_hat"], target)
        out["loss"] = (lmbda * 255.0 ** 2 * out["charbonnier_loss"]
                       + out["bpp_loss"])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return out


def rate_distortion_loss_per_sample(output: dict, target: torch.Tensor, lmbda,
                                    metric: str = "mse") -> dict:
    """Per-sample variant for dataset statistics (reference
    ``rd_loss.py:61-98``); the likelihoods' batch axis is their first."""
    if metric != "mse":
        raise ValueError("per-sample loss supports metric='mse'")
    b, h, w, _ = target.shape
    bpp = 0.0
    for lk in output["likelihoods"].values():
        bpp = bpp + torch.sum(torch.log(lk).reshape(b, -1), 1) / (
            -math.log(2) * h * w)
    mse = torch.mean(torch.square(output["x_hat"] - target), dim=(1, 2, 3))
    return {"bpp_loss": bpp, "mse_loss": mse,
            "loss": lmbda * 255.0 ** 2 * mse + bpp}
