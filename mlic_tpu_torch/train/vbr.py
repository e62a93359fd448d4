"""Multi-rate training of the VBR models: MGDA with a Frank-Wolfe min-norm
solver (port of ``mlic_tpu/train/vbr.py``; reference ``VBRTrainer``,
``MLIC++/playground/compression_trainer.py:333-730``).

One step runs a forward and a backward per gain level on the same batch
and the same z noise, with the loss ``RD(lambda_s) + aux``.  Each level's
gradient is laid into a row of one flat [levels, parameters] buffer,
``Gain`` first.  The Gram matrix of the shared part (every parameter but
``Gain``, the quantiles included) gives the min-norm weights ``alpha``;
the update takes ``alpha . g`` for the shared parameters and the sum over
levels for ``Gain``, then clips and steps both optimizers as
``trainer.train_step`` does.  Every parameter gets a gradient, zero where a
level's loss does not reach it (``Gain`` unless ``cfg.train_gain``,
QuantABCD unless ``quant_offset``), so AdamW's decay moves it as optax's
does in the JAX step.
"""

from __future__ import annotations

import functools

import torch

from mlic_tpu_torch.loss import rate_distortion_loss
from mlic_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    _to_batch,
    apply_gradients,
)


def frank_wolfe_minnorm(gram: torch.Tensor, n_iters: int = 20) -> torch.Tensor:
    """The min-norm point of the gradients' convex hull given their Gram
    matrix: Frank-Wolfe with the exact line search (vbr.py:28), on the
    Gram matrix's device with no host synchronization."""
    n = gram.shape[0]
    alpha = torch.full((n,), 1.0 / n, dtype=gram.dtype, device=gram.device)
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    for _ in range(n_iters):
        direction = eye[torch.argmin(gram @ alpha)] - alpha
        denom = direction @ gram @ direction
        gamma = torch.clamp(-(alpha @ gram @ direction) / (denom + 1e-12),
                            0.0, 1.0)
        gamma = torch.where(denom <= 1e-12, 0.0, gamma)
        alpha = alpha + gamma * direction
    return alpha


def z_noise(model, x: torch.Tensor, generator) -> torch.Tensor:
    """One draw of the bottleneck's uniform noise in [-1/2, 1/2), laid out
    [N, B*H/64*W/64] for images x [B,H,W,3] with H, W multiples of 64."""
    b, h, w, _ = x.shape
    return torch.rand((model.cfg.N, b * (h // 64) * (w // 64)),
                      generator=generator, device=x.device) - 0.5


def vbr_train_step(state: TrainState, batch, cfg: TrainConfig,
                   gradnorm: str = "none",
                   noise: torch.Tensor | None = None) -> dict:
    """One MGDA update over every level of ``state.model`` (vbr.py:57).
    ``gradnorm="loss"`` scales each level's shared gradient by 1/loss_s
    (MGDA-UB) before the Gram matrix and the combination.  ``noise``
    overrides the generator's draw (tests).  Returns device tensors:
    ``loss`` and ``bpp_loss`` (means over levels), ``loss_per_level``,
    ``bpp_per_level``, ``alpha`` and ``grad_norm``."""
    if gradnorm not in ("none", "loss"):
        raise ValueError(f"unknown gradnorm {gradnorm!r}")
    model = state.model
    gain = model.mmo_parameters()["gain"]
    params = dict(model.named_parameters())
    params = [params[n] for n in gain] + [p for n, p in params.items()
                                         if n not in gain]
    n_gain = sum(p.numel() for p in params[:len(gain)])
    x = _to_batch(batch, params[0].device)
    if noise is None:
        noise = z_noise(model, x, state.generator)
    n_levels = len(model.cfg.lmbda)
    flat = torch.zeros((n_levels, sum(p.numel() for p in params)),
                       device=x.device)
    losses, bpps = [], []
    for s in range(n_levels):
        out = model(x, True, noise, s=s)
        rd = rate_distortion_loss(out, x, model.cfg.lmbda[s], cfg.metric)
        grads = torch.autograd.grad(rd["loss"] + model.aux_loss(), params,
                                    allow_unused=True)
        flat[s] = torch.cat([torch.zeros(p.numel(), device=x.device)
                             if g is None else g.reshape(-1)
                             for p, g in zip(params, grads)])
        losses.append(rd["loss"].detach())
        bpps.append(rd["bpp_loss"].detach())
    losses, bpps = torch.stack(losses), torch.stack(bpps)
    shared = flat[:, n_gain:]
    if gradnorm == "loss":
        shared.mul_(1.0 / torch.clamp(losses, min=1e-6)[:, None])
    alpha = frank_wolfe_minnorm(shared @ shared.T)
    combined = torch.cat([flat[:, :n_gain].sum(0), alpha @ shared])
    offset = 0
    for p in params:
        p.grad = combined[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    norm = apply_gradients(state, cfg)
    return {"loss": losses.mean(), "bpp_loss": bpps.mean(),
            "loss_per_level": losses, "bpp_per_level": bpps, "alpha": alpha,
            "grad_norm": norm.detach()}


def make_vbr_train_step(gradnorm: str = "none"):
    """``vbr_train_step`` with ``gradnorm`` bound: a step function with
    ``trainer.train_step``'s signature ``(state, batch, cfg, noise=None)``."""
    return functools.partial(vbr_train_step, gradnorm=gradnorm)
