"""Optimizers of the training step (port of ``mlic_tpu/train/optimizers.py``).

The parameters split as in the reference (``MLIC++/utils/optimizers.py``):
the factorized prior's ``quantiles`` go to an auxiliary Adam, everything
else to the main optimizer.  One backward of RD + aux loss serves both:
the aux loss reaches only the quantiles (the density parameters are
detached there) and the RD loss gives them exactly zero gradient.

The arithmetic is optax's, where optax and torch differ in their defaults:
the main gradients are clipped by their global norm as
``optax.clip_by_global_norm`` does (scaled by ``max_norm / norm`` only when
``norm > max_norm``; torch's ``clip_grad_norm_`` adds 1e-6 and always
scales), AdamW decays by optax's 1e-4 (torch's default is 1e-2), and a
schedule gives the learning rate of update ``count`` (0 for the first) as
optax evaluates it before it increments its count.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import torch
from torch import nn

from mlic_tpu_torch.weights import flax_keystr

ADAMW_WEIGHT_DECAY = 1e-4      # optax.adamw's default


def param_labels(model: nn.Module) -> dict:
    """'aux' for the entropy bottleneck's quantiles, 'main' for the rest."""
    return {name: "aux" if name.split(".")[-1] == "quantiles" else "main"
            for name, _ in model.named_parameters()}


def frozen_names(model: nn.Module, pattern: str | None) -> set:
    """Names of the parameters whose flax path
    (``"['g_a']['conv_0']['kernel']"``) the regex ``pattern`` matches: the
    leaves the JAX package's ``freeze`` masks."""
    if not pattern:
        return set()
    rx = re.compile(pattern)
    return {name for name, p in model.named_parameters()
            if rx.search(flax_keystr(name, p.ndim))}


def make_optimizers(model: nn.Module, learning_rate: float = 1e-4,
                    aux_learning_rate: float = 1e-3, optimizer: str = "adam",
                    frozen: set = frozenset()):
    """(main, aux) torch optimizers.  Main: Adam, AdamW (weight decay
    1e-4) or SGD with momentum 0.9 over the main parameters that are not
    ``frozen``; aux: Adam over the quantiles.  A frozen parameter is in
    neither, so it keeps its value; its gradient still counts in the main
    clipping norm, as under the JAX package's ``freeze``."""
    labels = param_labels(model)
    main = [p for n, p in model.named_parameters()
            if labels[n] == "main" and n not in frozen]
    aux = [p for n, p in model.named_parameters()
           if labels[n] == "aux" and n not in frozen]
    if optimizer == "adam":
        main_opt = torch.optim.Adam(main, lr=learning_rate)
    elif optimizer == "adamw":
        main_opt = torch.optim.AdamW(main, lr=learning_rate,
                                     weight_decay=ADAMW_WEIGHT_DECAY)
    elif optimizer == "sgd":
        main_opt = torch.optim.SGD(main, lr=learning_rate, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return main_opt, torch.optim.Adam(aux, lr=aux_learning_rate)


def main_parameters(model: nn.Module) -> list:
    """Every main parameter, frozen ones included (the clipping set)."""
    labels = param_labels(model)
    return [p for n, p in model.named_parameters() if labels[n] == "main"]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over ``tensors`` (``optax.global_norm``),
    a device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    where their global norm exceeds ``max_norm`` (``optax.
    clip_by_global_norm``); returns the norm before clipping.  Stays on
    the device: no host synchronization."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Callable[[int], float]:
    """``optax.piecewise_constant_schedule(base_lr, {m: gamma})``: the rate
    at update ``count`` is ``base_lr`` times ``gamma`` for every milestone
    ``m <= count``."""
    ms = sorted(int(m) for m in milestones)

    def schedule(count: int) -> float:
        lr = base_lr
        for m in ms:
            if count >= m:
                lr *= gamma
        return lr
    return schedule


def lr_schedule(learning_rate: float, lr_milestones: Sequence[int] = (),
                warmup_steps: int = 0) -> Callable[[int], float]:
    """The main learning rate of update ``count`` (trainer.py:59-70): a
    linear warmup from 0 over ``warmup_steps`` updates (``optax.
    linear_schedule``), then the milestones, which stay absolute update
    indices (``optax.join_schedules`` with shifted milestones)."""
    after = multistep_lr(learning_rate, lr_milestones)
    if not warmup_steps:
        return after

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return -learning_rate * frac + learning_rate
        return after(count)
    return schedule


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
