"""Training CLI (port of ``tools/train.py``; reference
``MLIC++/playground/train.py`` and ``config/args.py``).

    python -m mlic_tpu_torch.tools.train --model MLICPP_S --dataset DIR \\
        --lambda 0.0483 --metrics mse --batch-size 8 --steps 100000
    python -m mlic_tpu_torch.tools.train --cpu --model MLICPP_TINY \\
        --synthetic --steps 3 --batch-size 2 --patch-size 64
    python -m mlic_tpu_torch.tools.train --model MLICPP_S_VBR --vbr \\
        --pretrained ckpts/bench_default --synthetic

``--vbr`` trains a VBR model at all its gain levels at once (MGDA,
``train/vbr.py``; ``--vbr-gradnorm loss`` scales each level by 1/loss) and
``--train-gain`` lets gradients reach its ``Gain`` vector.
Runs on the CUDA card unless ``--cpu`` is given.  ``--synthetic`` (or no
``--dataset``) trains on smooth waves or a dead-leaves pool.
``--pretrained`` warm-starts from an orbax directory of the JAX package
(e.g. ``ckpts/bench_default``) or a torch file of the port; ``--resume``
continues from the newest checkpoint in ``<ckpt-dir>/<exp-name>``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

_WAITING = ("Not ported yet (they wait for their modules): --augment "
            "(data/autoaugment), --patch-milestones, --test-dataset and "
            "--save-recon.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MLIC++ training (PyTorch)",
                                epilog=_WAITING)
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--dataset", default=None, help="training image folder")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-kind", default="waves",
                   choices=["waves", "dead_leaves"],
                   help="dataset-free source: smooth waves (smoke tests) or "
                        "a dead-leaves pool (natural-image surrogate for RD)")
    p.add_argument("--pool-size", type=int, default=512,
                   help="dead-leaves pool: number of pre-rendered images")
    p.add_argument("--pool-image-size", type=int, default=320)
    p.add_argument("--exp-name", default="mlic_tpu_torch")
    p.add_argument("--lambda", dest="lmbda", type=float, default=0.0483)
    p.add_argument("--metrics", default="mse",
                   choices=["mse", "ms-ssim", "charbonnier"])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--clip-max-norm", type=float, default=1.0)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adamw", "sgd"])
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-freq", type=int, default=20)
    p.add_argument("--ckpt-dir", default="./ckpts")
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="orbax checkpoint directory of the JAX package or a "
                        "torch file of the port to warm-start from (partial, "
                        "shape-filtered load)")
    p.add_argument("--freeze", default=None,
                   help="regex over flax parameter paths "
                        "(\"['g_a']['rbs0']...\"); matching parameters stay "
                        "fixed (reference frezze_some_layers)")
    p.add_argument("--val-every", type=int, default=0,
                   help="full-image validation every N steps (0 = off)")
    p.add_argument("--val-images", type=int, default=4)
    p.add_argument("--dual", action="store_true",
                   help="two-pass recompression training")
    p.add_argument("--vbr", action="store_true",
                   help="VBR multi-rate (MGDA) training of a VBR model")
    p.add_argument("--train-gain", action="store_true",
                   help="let gradients flow into the Gain vector (the "
                        "reference detaches it; ModelConfig.train_gain)")
    p.add_argument("--vbr-gradnorm", default="none", choices=["none", "loss"],
                   help="MGDA-UB per-level gradient normalization (1/loss)")
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"],
                   help="compute dtype of g_a/h_a/g_s (the entropy path "
                        "stays f32); default bfloat16_mixed on the card, "
                        "float32 with --cpu")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (plain PyTorch)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the last step's metrics (floats) and the step."""
    args = parse_args(argv)
    from mlic_tpu_torch.data.folder import (
        ImageFolderDataset,
        dead_leaves_pool,
        pool_batches,
        synthetic_batches,
    )
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops.fused_block import use_fused_blocks
    from mlic_tpu_torch.train.trainer import (
        TrainConfig,
        create_train_state,
        dual_train_step,
        eval_step,
        train_step,
    )
    from mlic_tpu_torch.train.vbr import make_vbr_train_step
    from mlic_tpu_torch.utils.checkpoint import CheckpointManager, load_matching
    from mlic_tpu_torch.utils.logger import MetricsWriter
    from mlic_tpu_torch.weights import init_params, load_checkpoint

    if use_fused_blocks():
        raise SystemExit("MLIC_FUSED_BLOCKS=1: the fused block tail is "
                         "forward-only and cannot train; unset it")
    if args.transform_dtype is None:
        args.transform_dtype = "float32" if args.cpu else "bfloat16_mixed"
    if args.vbr and args.dual:
        raise SystemExit("--vbr and --dual are separate training steps")
    model = get_model(args.model, args.transform_dtype,
                      **({"train_gain": True} if args.train_gain else {}))
    if args.vbr and not model.cfg.vbr:
        raise SystemExit(f"--vbr needs a VBR model; {args.model} is not one")
    model.load_state_dict(init_params(
        model, torch.Generator().manual_seed(args.seed)))
    if args.pretrained:
        state_dict, taken = load_matching(model.state_dict(),
                                          load_checkpoint(args.pretrained))
        model.load_state_dict(state_dict)
        print(f"warm-started {len(taken)} of {len(state_dict)} parameters "
              f"from {args.pretrained}", flush=True)
    cfg = TrainConfig(
        lmbda=args.lmbda, metric=args.metrics, learning_rate=args.learning_rate,
        aux_learning_rate=args.aux_learning_rate,
        clip_max_norm=args.clip_max_norm, optimizer=args.optimizer,
        lr_milestones=tuple(args.lr_milestones),
        warmup_steps=args.warmup_steps, seed=args.seed)
    state = create_train_state(model, cfg, "cpu" if args.cpu else None,
                               args.freeze)
    if args.vbr:
        step_fn = make_vbr_train_step(args.vbr_gradnorm)
    else:
        step_fn = dual_train_step if args.dual else train_step

    work_dir = os.path.join(args.ckpt_dir, args.exp_name)
    ckpt = CheckpointManager(work_dir)
    if args.resume and ckpt.latest_tag() is not None:
        tag = ckpt.latest_tag()
        try:
            ckpt.restore(tag, state)
        except ValueError as e:
            # The optimizers' groups differ (another --freeze): the weights
            # and the step, with fresh optimizer moments.
            print(f"strict resume failed ({e}); weights-only restore with "
                  "fresh optimizer state", flush=True)
            ckpt.restore(tag, state, params_only=True)
        print(f"resumed from step {state.step}", flush=True)
    writer = MetricsWriter(os.path.join(work_dir, "logs"))

    pool = None
    synthetic = args.synthetic or not args.dataset
    if synthetic and args.synthetic_kind == "dead_leaves":
        pool = dead_leaves_pool(args.pool_size, args.pool_image_size,
                                seed=args.seed)
    n_steps = max(args.steps - state.step, 0)
    seed = args.seed + state.step
    if pool is not None:
        batches = pool_batches(pool, args.batch_size, args.patch_size,
                               n_steps, seed=seed + 1)
    elif synthetic:
        batches = synthetic_batches(args.batch_size, args.patch_size,
                                    n_steps, seed=seed)
    else:
        batches = ImageFolderDataset(args.dataset, args.patch_size,
                                     seed=seed).batches(args.batch_size,
                                                        n_steps)

    val_images = []
    if args.val_every:
        if pool is not None:
            vp = dead_leaves_pool(args.val_images, args.pool_image_size,
                                  seed=args.seed + 7919)
            val_images = [v.astype(np.float32) / 255.0 for v in vp]
        else:
            val_images = [next(synthetic_batches(1, 256, 1,
                                                 seed=args.seed + 7919 + i))
                          for i in range(args.val_images)]

    def validate(step: int):
        state.model.eval()
        rows = []
        for img in val_images:
            out = eval_step(state.model, img[None] if img.ndim == 3 else img,
                            cfg)
            rows.append((float(out["psnr"]), float(out["bpp_loss"])))
        state.model.train()
        psnr = sum(r[0] for r in rows) / max(len(rows), 1)
        bpp = sum(r[1] for r in rows) / max(len(rows), 1)
        print(f"val @ {step}: psnr={psnr:.3f} bpp={bpp:.4f}", flush=True)
        writer.write(step, {"psnr": psnr, "bpp": bpp}, prefix="val/")

    last = {}
    t0 = time.perf_counter()
    for batch in batches:
        metrics = step_fn(state, batch, cfg)
        step = state.step
        if step % args.log_freq == 0 or step == args.steps:
            last = _scalars(metrics)
            dt = (time.perf_counter() - t0) / args.log_freq
            print(f"step {step} | {dt * 1e3:.0f} ms/it | " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(last.items())), flush=True)
            writer.write(step, last, prefix="train/")
            t0 = time.perf_counter()
        if args.val_every and step % args.val_every == 0:
            validate(step)
            t0 = time.perf_counter()
        if step % args.ckpt_every == 0 or step == args.steps:
            ckpt.save(str(step), state, loss=float(metrics["loss"]))
            print(f"saved checkpoint_{step}", flush=True)
    writer.close()
    return {"step": state.step, **last}


def _scalars(metrics: dict) -> dict:
    """Metrics as floats; a per-level vector ``v`` becomes ``v_0``,
    ``v_1``, ..."""
    out = {}
    for k, v in metrics.items():
        if v.numel() == 1:
            out[k] = float(v)
        else:
            out.update({f"{k}_{i}": float(e) for i, e in enumerate(v)})
    return out


if __name__ == "__main__":
    main()
