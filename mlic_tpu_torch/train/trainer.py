"""The training loop (port of ``mlic_tpu/train/trainer.py``; reference
``MLIC++/utils/training.py:48-121``, ``playground/train.py:203-256``).

One ``train_step`` runs the training forward, one backward of the RD loss
plus the aux loss, clips the main gradients by their global norm and
updates both parameter groups (``train/optimizers.py``).  The transforms
compute in the model's ``transform_dtype`` (bf16 under ``bfloat16_mixed``)
with f32 master parameters; the entropy path stays f32.  The z noise comes
from the state's ``torch.Generator`` on the training device, so a run and
its resume from a checkpoint draw the same noise.  One device: data
parallelism waits for the port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.eval import pad_to_multiple
from mlic_tpu_torch.loss import rate_distortion_loss
from mlic_tpu_torch.metrics import ms_ssim
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus
from mlic_tpu_torch.train.optimizers import (
    clip_by_global_norm_,
    frozen_names,
    global_norm,
    lr_schedule,
    main_parameters,
    make_optimizers,
    set_learning_rate,
)


@dataclasses.dataclass
class TrainConfig:
    lmbda: float = 0.0483
    metric: str = "mse"                # mse | ms-ssim | charbonnier
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    clip_max_norm: float = 1.0
    optimizer: str = "adam"
    lr_milestones: tuple = ()          # update indices of the 10x decays
    warmup_steps: int = 0              # linear warmup (reference warmup.py)
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    """The model and what its updates carry: both optimizers, the number
    of updates done, and the noise generator."""
    model: MLICPlusPlus
    main_opt: torch.optim.Optimizer
    aux_opt: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def create_train_state(model: MLICPlusPlus, cfg: TrainConfig, device=None,
                       freeze: str | None = None) -> TrainState:
    """Move ``model`` (with its weights loaded) to ``device`` (CUDA unless
    the caller asks for the CPU) and build its optimizers; ``freeze`` is a
    regex over flax parameter paths whose parameters stay fixed."""
    dev = resolve_device(device)
    model.to(dev).train()
    main_opt, aux_opt = make_optimizers(
        model, cfg.learning_rate, cfg.aux_learning_rate, cfg.optimizer,
        frozen_names(model, freeze))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return TrainState(model, main_opt, aux_opt, 0, gen)


def _to_batch(batch, device) -> torch.Tensor:
    """A batch [B,H,W,3] (uint8, or float in [0, 1]) on ``device``, f32;
    uint8 crosses to the device at a byte a channel."""
    x = torch.as_tensor(np.ascontiguousarray(batch)).to(device,
                                                        non_blocking=True)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def _update(state: TrainState, cfg: TrainConfig, loss: torch.Tensor):
    """One backward of ``loss`` and one update of both groups at the
    schedule's rate; returns the main gradients' global norm.  Every
    gradient is cleared first, a frozen parameter's too: it is in neither
    optimizer but counts in the clipping norm, which must see this step's
    gradients only."""
    state.model.zero_grad(set_to_none=True)
    loss.backward()
    return apply_gradients(state, cfg)


def apply_gradients(state: TrainState, cfg: TrainConfig) -> torch.Tensor:
    """Clip the main gradients the parameters hold by their global norm,
    step both optimizers at the schedule's rate and count the update;
    returns the norm before clipping."""
    main = main_parameters(state.model)
    if cfg.clip_max_norm:
        norm = clip_by_global_norm_(main, cfg.clip_max_norm)
    else:
        norm = global_norm(p.grad for p in main if p.grad is not None)
    set_learning_rate(state.main_opt, lr_schedule(
        cfg.learning_rate, cfg.lr_milestones, cfg.warmup_steps)(state.step))
    state.main_opt.step()
    state.aux_opt.step()
    state.step += 1
    return norm


def train_step(state: TrainState, batch, cfg: TrainConfig,
               noise: torch.Tensor | None = None) -> dict:
    """One update from the RD loss plus the aux loss (trainer.py:79-104).
    Returns the step's metrics as device scalars (no host
    synchronization).  ``noise`` overrides the generator's draw (tests)."""
    model = state.model
    x = _to_batch(batch, next(model.parameters()).device)
    out = model(x, True, noise, state.generator)
    rd = rate_distortion_loss(out, x, cfg.lmbda, cfg.metric)
    aux = model.aux_loss()
    norm = _update(state, cfg, rd["loss"] + aux)
    metrics = {k: v.detach() for k, v in rd.items()}
    metrics["aux_loss"] = aux.detach()
    metrics["grad_norm"] = norm.detach()
    return metrics


def dual_train_step(state: TrainState, batch, cfg: TrainConfig) -> dict:
    """Two-pass recompression step (trainer.py:107-137; reference
    ``train_one_epoch_dual``): pass 1 on the image at lambda, pass 2 on the
    detached, clipped reconstruction judged against the original at
    lambda/2; one backward of both plus the aux loss."""
    model = state.model
    x = _to_batch(batch, next(model.parameters()).device)
    out1 = model(x, True, None, state.generator)
    rd1 = rate_distortion_loss(out1, x, cfg.lmbda, cfg.metric)
    again = torch.clamp(out1["x_hat"].detach(), 0.0, 1.0)
    out2 = model(again, True, None, state.generator)
    rd2 = rate_distortion_loss(out2, x, cfg.lmbda * 0.5, cfg.metric)
    aux = model.aux_loss()
    _update(state, cfg, rd1["loss"] + rd2["loss"] + aux)
    metrics = {f"first_{k}": v.detach() for k, v in rd1.items()}
    metrics.update({k: v.detach() for k, v in rd2.items()})
    metrics["aux_loss"] = aux.detach()
    return metrics


@torch.no_grad()
def eval_step(model: MLICPlusPlus, batch, cfg: TrainConfig,
              s: int | None = None) -> dict:
    """Eval forward (rounded z) of a batch: RD metrics, PSNR and x_hat
    (trainer.py:170-182).  A VBR model evaluates at gain level ``s``
    with that level's lambda (without one, its forward's default level
    and ``cfg.lmbda``)."""
    x = _to_batch(batch, next(model.parameters()).device)
    if s is None:
        out, lmbda = model(x, False), cfg.lmbda
    else:
        out, lmbda = model(x, False, s=s), model.cfg.lmbda[s]
    rd = rate_distortion_loss(out, x, lmbda, cfg.metric)
    mse = torch.mean(torch.square(out["x_hat"] - x))
    rd["psnr"] = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
    rd["x_hat"] = out["x_hat"]
    return rd


class Trainer:
    """The epoch loop (trainer.py:185-275; reference ``BaseTrainer``)."""

    def __init__(self, model: MLICPlusPlus, cfg: TrainConfig, device=None,
                 freeze: str | None = None, log_fn=print):
        self.model = model
        self.cfg = cfg
        self.log = log_fn
        self.state = create_train_state(model, cfg, device, freeze)

    def fit_epoch(self, batches: Iterable, log_freq: int = 20) -> dict:
        """Train on every batch; logs every ``log_freq`` steps and returns
        the last logged metrics as floats."""
        last, metrics = {}, None
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            metrics = train_step(self.state, batch, self.cfg)
            if (i + 1) % log_freq == 0:
                last = {k: float(v) for k, v in metrics.items()}
                dt = (time.perf_counter() - t0) / log_freq
                self.log(f"step {self.state.step} | {dt * 1e3:.0f} ms/it | "
                         + " ".join(f"{k}={v:.4f}"
                                    for k, v in sorted(last.items())))
                t0 = time.perf_counter()
        if metrics is None:
            raise ValueError("fit_epoch received an empty batch iterable")
        return last or {k: float(v) for k, v in metrics.items()}

    def evaluate(self, images: Iterable[np.ndarray]) -> dict:
        """Full-image validation (reference ``test_one_epoch``): each image
        ([H,W,3] or [1,H,W,3] float in [0, 1]) padded to a multiple of 64,
        the eval forward, PSNR and MS-SSIM (images of at least 176 px) on
        the unpadded pixels, bpp over the true pixel count.  Returns the
        means and ``per_image`` rows."""
        model = self.model
        was_training = model.training
        model.eval()
        totals, rows = {}, []
        try:
            for img in images:
                x = np.asarray(img, np.float32)
                if x.ndim == 3:
                    x = x[None]
                h, w = x.shape[1:3]
                padded, _ = pad_to_multiple(x)
                out = eval_step(model, padded, self.cfg)
                x_hat = out["x_hat"][:, :h, :w]
                ref = torch.from_numpy(x).to(x_hat.device)
                mse = float(torch.mean(torch.square(x_hat - ref)))
                psnr = 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))
                msssim = (float(ms_ssim(x_hat, ref)) if min(h, w) >= 176
                          else float("nan"))
                bpp = float(out["bpp_loss"]) * (
                    padded.shape[1] * padded.shape[2]) / (h * w)
                row = {"psnr": psnr, "ms_ssim": msssim, "bpp": bpp,
                       "loss": float(out["loss"])}
                rows.append(row)
                for k, v in row.items():
                    if not np.isnan(v):
                        totals[k] = totals.get(k, 0.0) + v
        finally:
            model.train(was_training)
        means = {k: v / max(len(rows), 1) for k, v in totals.items()}
        means["per_image"] = rows
        return means

