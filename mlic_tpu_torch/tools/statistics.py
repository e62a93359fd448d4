"""Per-image codec statistics to a CSV (port of ``tools/statistics.py``;
the reference's ``EXPTrainer`` statistics run,
``MLIC++/playground/compression_trainer.py:739-930``).

    python -m mlic_tpu_torch.tools.statistics --dataset DIR --out stats.csv \\
        [--model MLICPP_S] [--checkpoint ckpts/bench_default] [--cpu]
    torchrun --nproc_per_node=N -m mlic_tpu_torch.tools.statistics ...

Runs the RD forward (rounded quantization) on every image of a folder,
padded to a multiple of 64, and writes one row an image: name, bpp (the
per-sample rate over the padded extent, as the JAX tool), PSNR and
MS-SSIM (images of at least 176 px; else NaN) on the unpadded pixels,
and prints their means.
Under torchrun each process takes ``files[rank::world]`` and the rows are
gathered to process 0 (``gather_rows`` over
``parallel.mesh.process_allgather``), which writes the CSV.  Runs on the
CUDA card unless ``--cpu`` is given; without ``--checkpoint`` the weights
are seeded random ones.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch


def gather_rows(rows, files_all, pid, pcount, allgather):
    """Every process's rows, rebuilt on each process in process order
    (tools/statistics.py:91).  The names are not sent: every process
    shares the files out round-robin the same way, so each can tell who
    measured what.  Shards differ in length by at most one; the shorter
    ones are padded with NaN rows."""
    maxn = (len(files_all) + pcount - 1) // pcount
    vals = np.full((maxn, 3), np.nan, np.float32)
    for i, r in enumerate(rows):
        vals[i] = (r["bpp"], r["psnr"], r["ms_ssim"])
    gathered = np.asarray(allgather(vals))  # [pcount, maxn, 3]
    out = []
    for p in range(pcount):
        names = [os.path.basename(f) for f in files_all[p::pcount]]
        for i, name in enumerate(names):
            b, ps, ms = (float(x) for x in gathered[p, i])
            out.append({"name": name, "bpp": b, "psnr": ps, "ms_ssim": ms})
    return out


@torch.no_grad()
def image_rows(model, files, lmbda: float, device) -> list:
    """The statistics rows of ``files`` through ``model`` on ``device``."""
    from mlic_tpu_torch.data.folder import load_image
    from mlic_tpu_torch.eval import crop_to, pad_to_multiple
    from mlic_tpu_torch.loss import rate_distortion_loss_per_sample
    from mlic_tpu_torch.metrics import ms_ssim, psnr
    rows = []
    for path in files:
        img = load_image(path).astype(np.float32) / 255.0
        padded, hw = pad_to_multiple(img[None])
        x = torch.from_numpy(padded).to(device)
        out = model(x, False)
        rd = rate_distortion_loss_per_sample(out, x, lmbda)
        x_hat = crop_to(out["x_hat"], hw)
        ref = torch.from_numpy(img[None]).to(device)
        rows.append({
            "name": os.path.basename(path),
            "bpp": float(rd["bpp_loss"][0]),
            "psnr": float(psnr(x_hat, ref)),
            "ms_ssim": float(ms_ssim(x_hat, ref)) if min(hw) >= 176
            else float("nan"),
        })
        print(rows[-1], flush=True)
    return rows


def main(argv=None) -> list:
    """Write the CSV (process 0); returns the rows this process holds:
    every image's on process 0, its own elsewhere."""
    p = argparse.ArgumentParser(description="per-image codec statistics")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--dataset", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--out", default="stats.csv")
    p.add_argument("--lambda", dest="lmbda", type=float, default=0.0483)
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"])
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from mlic_tpu_torch.data.folder import list_images
    from mlic_tpu_torch.device import resolve_device
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.parallel.mesh import (
        init_from_env,
        is_distributed,
        process_allgather,
        process_count,
        process_index,
    )
    from mlic_tpu_torch.utils.checkpoint import load_matching
    from mlic_tpu_torch.utils.misc import pretty_print_dict
    from mlic_tpu_torch.weights import init_params, load_checkpoint

    device = "cpu" if args.cpu else None
    joined = not is_distributed() and init_from_env(device)
    dev = resolve_device(device)
    model = get_model(args.model, args.transform_dtype)
    state = init_params(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        state, _ = load_matching(state, load_checkpoint(args.checkpoint))
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()

    files_all = list_images(args.dataset)
    pid, pcount = process_index(), process_count()
    rows = image_rows(model, files_all[pid::pcount], args.lmbda, dev)
    if pcount > 1:
        mine = rows
        rows = gather_rows(rows, files_all, pid, pcount, process_allgather)
    if joined:
        torch.distributed.destroy_process_group()
    if pid != 0:
        return mine
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["name", "bpp", "psnr",
                                               "ms_ssim"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}", flush=True)
    means = {f"mean {k}": float(np.mean([r[k] for r in rows] or [np.nan]))
             for k in ("bpp", "psnr", "ms_ssim")}
    print(pretty_print_dict(means), flush=True)
    return rows


if __name__ == "__main__":
    main()
