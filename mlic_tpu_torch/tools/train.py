"""Training CLI (port of ``tools/train.py``; reference
``MLIC++/playground/train.py`` and ``config/args.py``).

    python -m mlic_tpu_torch.tools.train --model MLICPP_S --dataset DIR \\
        --lambda 0.0483 --metrics mse --batch-size 8 --steps 100000 \\
        --augment autoaugment --patch-milestones 80000:512
    python -m mlic_tpu_torch.tools.train --cpu --model MLICPP_TINY \\
        --synthetic --steps 3 --batch-size 2 --patch-size 64
    python -m mlic_tpu_torch.tools.train --model MLICPP_S_VBR --vbr \\
        --pretrained ckpts/bench_default --synthetic
    torchrun --nproc_per_node=4 -m mlic_tpu_torch.tools.train ...

``--vbr`` trains a VBR model at all its gain levels at once (MGDA,
``train/vbr.py``; ``--vbr-gradnorm loss`` scales each level by 1/loss) and
``--train-gain`` lets gradients reach its ``Gain`` vector.
Runs on the CUDA card unless ``--cpu`` is given.  ``--synthetic`` (or no
``--dataset``) trains on smooth waves or a dead-leaves pool; ``--augment
autoaugment`` runs the reference's AutoAugment on ``--dataset`` images.
``--patch-milestones STEP:SIZE ...`` switches the crop size at each STEP
(the reference's 256 -> 512 recipe): the batch stream is rebuilt there.
``--val-every N`` validates on ``--test-dataset`` (else a held-out
synthetic set) and ``--save-recon`` writes the reconstructions to
``<ckpt-dir>/<exp-name>/val/step{N}_img{i}.png``.
``--pretrained`` warm-starts from an orbax directory of the JAX package
(e.g. ``ckpts/bench_default``) or a torch file of the port; ``--resume``
continues from the newest checkpoint in ``<ckpt-dir>/<exp-name>``.

Data parallelism: under torchrun (``WORLD_SIZE`` set) each process joins
the process group (NCCL on the cards, gloo with ``--cpu``) and takes card
``LOCAL_RANK``.  ``--batch-size`` is the global batch: each process steps
on its slice (a synthetic batch is drawn whole and sliced; a folder's
files are shared out by process), and the gradients are averaged over the
processes (``train/trainer.py``).  Process 0 alone logs, validates and
writes checkpoints and reconstructions.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MLIC++ training (PyTorch)")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--dataset", default=None, help="training image folder")
    p.add_argument("--test-dataset", default=None,
                   help="validation image folder (--val-every)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--augment", default=None, choices=["autoaugment"],
                   help="augmentation of --dataset images (the reference's "
                        "AutoAugment, train.py:82)")
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
    p.add_argument("--save-recon", action="store_true",
                   help="write the validation reconstructions as PNGs")
    p.add_argument("--patch-milestones", nargs="*", default=[],
                   help="STEP:SIZE pairs; at STEP the training crop size "
                        "becomes SIZE (the reference's 256 -> 512 recipe)")
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


def _patch_schedule(args) -> list:
    """[(first step, patch size), ...] sorted, the first at step 0
    (tools/train.py:90)."""
    sched = [(0, args.patch_size)]
    for item in args.patch_milestones:
        s, sz = item.split(":")
        sched.append((int(s), int(sz)))
    return sorted(sched)


def _patch_at(sched: list, step: int) -> int:
    """The patch size of ``step`` under ``sched`` (tools/train.py:99)."""
    size = sched[0][1]
    for s, sz in sched:
        if step >= s:
            size = sz
    return size


def main(argv=None) -> dict:
    """Train; returns the last logged metrics (floats) and the step."""
    args = parse_args(argv)
    from mlic_tpu_torch.data.folder import (
        ImageFolderDataset,
        dead_leaves_pool,
        list_images,
        load_image,
        pool_batches,
        synthetic_batches,
    )
    from mlic_tpu_torch.eval import pad_to_multiple
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops.fused_block import use_fused_blocks
    from mlic_tpu_torch.parallel.mesh import (
        init_from_env,
        is_distributed,
        local_batch_slice,
        process_count,
        process_index,
    )
    from mlic_tpu_torch.train.trainer import (
        TrainConfig,
        create_train_state,
        dual_train_step,
        eval_step,
        save_png,
        train_step,
    )
    from mlic_tpu_torch.train.vbr import make_vbr_train_step
    from mlic_tpu_torch.utils.checkpoint import CheckpointManager, load_matching
    from mlic_tpu_torch.utils.logger import MetricsWriter
    from mlic_tpu_torch.utils.misc import (
        AverageMeter,
        Config,
        get_system_info_str,
    )
    from mlic_tpu_torch.weights import init_params, load_checkpoint

    if use_fused_blocks():
        raise SystemExit("MLIC_FUSED_BLOCKS=1: the fused block tail is "
                         "forward-only and cannot train; unset it")
    if args.transform_dtype is None:
        args.transform_dtype = "float32" if args.cpu else "bfloat16_mixed"
    if args.vbr and args.dual:
        raise SystemExit("--vbr and --dual are separate training steps")
    device = "cpu" if args.cpu else None
    joined = not is_distributed() and init_from_env(device)
    lead = process_index() == 0
    local = local_batch_slice(args.batch_size)
    if lead:
        print(get_system_info_str(), flush=True)
    if lead and is_distributed():
        print(f"process group: backend {torch.distributed.get_backend()}, "
              f"{process_count()} processes, {local.stop - local.start} "
              "images a process", flush=True)
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
        if lead:
            print(f"warm-started {len(taken)} of {len(state_dict)} "
                  f"parameters from {args.pretrained}", flush=True)
    cfg = TrainConfig(
        lmbda=args.lmbda, metric=args.metrics, learning_rate=args.learning_rate,
        aux_learning_rate=args.aux_learning_rate,
        clip_max_norm=args.clip_max_norm, optimizer=args.optimizer,
        lr_milestones=tuple(args.lr_milestones),
        warmup_steps=args.warmup_steps, seed=args.seed)
    state = create_train_state(model, cfg, device, args.freeze)
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
        if lead:
            print(f"resumed from step {state.step}", flush=True)
    writer = MetricsWriter(os.path.join(work_dir, "logs")) if lead else None
    if lead:
        Config(vars(args)).to_json(os.path.join(work_dir, "config.json"))

    pool = None
    synthetic = args.synthetic or not args.dataset
    if synthetic and args.synthetic_kind == "dead_leaves":
        pool = dead_leaves_pool(args.pool_size, args.pool_image_size,
                                seed=args.seed)

    def make_batches(patch: int, n_steps: int, seed: int):
        """This process's batches: a synthetic global batch sliced, or
        its share of the folder's files at its share of the batch."""
        if pool is not None:
            gen = pool_batches(pool, args.batch_size, patch, n_steps,
                               seed=seed + 1)
        elif synthetic:
            gen = synthetic_batches(args.batch_size, patch, n_steps,
                                    seed=seed)
        else:
            return ImageFolderDataset(
                args.dataset, patch, process_index=process_index(),
                process_count=process_count(), seed=seed,
                augment=args.augment).batches(local.stop - local.start,
                                              n_steps)
        return (b[local] for b in gen)

    val_images = []
    if args.val_every and lead:
        if args.test_dataset:
            val_images = [pad_to_multiple(
                load_image(f).astype(np.float32)[None] / 255.0)[0]
                for f in list_images(args.test_dataset)[:args.val_images]]
        elif pool is not None:
            vp = dead_leaves_pool(args.val_images, args.pool_image_size,
                                  seed=args.seed + 7919)
            val_images = [v.astype(np.float32) / 255.0 for v in vp]
        else:
            val_images = [next(synthetic_batches(1, 256, 1,
                                                 seed=args.seed + 7919 + i))
                          for i in range(args.val_images)]

    def validate(step: int):
        state.model.eval()
        psnr, bpp = AverageMeter(), AverageMeter()
        for i, img in enumerate(val_images):
            out = eval_step(state.model, img[None] if img.ndim == 3 else img,
                            cfg)
            psnr.update(out["psnr"])
            bpp.update(out["bpp_loss"])
            print(f"  val[{i}] psnr={psnr.val:.3f} bpp={bpp.val:.4f}")
            if args.save_recon:
                save_png(out["x_hat"][0], os.path.join(
                    work_dir, "val", f"step{step}_img{i}.png"))
        state.model.train()
        print(f"val @ {step}: psnr={psnr.avg:.3f} bpp={bpp.avg:.4f}",
              flush=True)
        writer.write(step, {"psnr": psnr.avg, "bpp": bpp.avg}, prefix="val/")

    sched = _patch_schedule(args)
    last = {}
    while state.step < args.steps:
        patch = _patch_at(sched, state.step)
        nxt = min([s for s, _ in sched if s > state.step] + [args.steps])
        if lead:
            print(f"patch {patch} from step {state.step}", flush=True)
        t0 = time.perf_counter()
        for batch in make_batches(patch, nxt - state.step,
                                  args.seed + state.step):
            metrics = step_fn(state, batch, cfg)
            step = state.step
            if step % args.log_freq == 0 or step == args.steps:
                last = _scalars(metrics)
                dt = (time.perf_counter() - t0) / args.log_freq
                if lead:
                    print(f"step {step} | {dt * 1e3:.0f} ms/it | " + " ".join(
                        f"{k}={v:.4f}" for k, v in sorted(last.items())),
                        flush=True)
                    writer.write(step, last, prefix="train/")
                t0 = time.perf_counter()
            if lead and args.val_every and step % args.val_every == 0:
                validate(step)
                t0 = time.perf_counter()
            if lead and (step % args.ckpt_every == 0 or step == args.steps):
                ckpt.save(str(step), state, loss=float(metrics["loss"]))
                print(f"saved checkpoint_{step}", flush=True)
    if writer is not None:
        writer.close()
    if joined:
        torch.distributed.destroy_process_group()
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
