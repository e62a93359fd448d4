"""An RD curve from trained checkpoints through the real codec (port of
``tools/rd_curve.py``).

For each (checkpoint, lambda): load the weights (an orbax directory of the
JAX package, read by ``utils.checkpoint.read_orbax``, or a torch file),
build the tables (``Codec.update``), round-trip a held-out image set through
real bitstream files with ``eval.evaluate_codec`` (which raises unless each
decoded file reproduces the encoder's reconstruction) and record the
measured bpp, PSNR and MS-SSIM.  The JSON feeds ``tools.bdrate``.

    python -m mlic_tpu_torch.tools.rd_curve --model MLICPP_S \\
        --ckpts ckpts/bench_default --lambdas 0.0483 --out rd_s.json \\
        [--backend steps|device|fused] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from mlic_tpu_torch.codec import BACKENDS, Codec
from mlic_tpu_torch.eval import evaluate_codec
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools.rd_vbr import holdout_images
from mlic_tpu_torch.weights import load_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RD curve through the real codec")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--ckpts", nargs="+", required=True,
                   help="orbax checkpoint directories or torch weights "
                        "files, one per lambda")
    p.add_argument("--lambdas", nargs="+", type=float, required=True)
    p.add_argument("--out", required=True, help="output curve JSON")
    p.add_argument("--images", default=None,
                   help="eval image folder; default: held-out dead-leaves")
    p.add_argument("--n-images", type=int, default=8)
    p.add_argument("--image-size", type=int, default=320)
    p.add_argument("--backend", default="steps", choices=BACKENDS,
                   help="'steps' (default) writes the reference's single "
                        "streams (~8 bytes of overhead); the device formats "
                        "pay bytes a lane, which distorts low-rate points "
                        "of small images")
    p.add_argument("--save-dir", default="./runs/rd_eval")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if len(args.ckpts) != len(args.lambdas):
        raise ValueError("one lambda a checkpoint")
    images = holdout_images(args)
    model = get_model(args.model)
    points = []
    for ckpt, lmbda in zip(args.ckpts, args.lambdas):
        print(f"=== lambda={lmbda} ckpt={ckpt}", flush=True)
        model.load_state_dict(load_checkpoint(ckpt), strict=True)
        codec = Codec(model, device="cpu" if args.cpu else None,
                      backend=args.backend)
        t0 = time.perf_counter()
        codec.update()
        print(f"tables built in {time.perf_counter() - t0:.1f}s", flush=True)
        res = evaluate_codec(codec, images,
                             os.path.join(args.save_dir, f"l{lmbda}"))
        res["lambda"] = lmbda
        points.append(res)
        print(f"lambda={lmbda}: bpp={res['bpp']:.4f} psnr={res['psnr']:.3f} "
              f"ms-ssim={res['ms_ssim']:.5f}", flush=True)

    def finite(v):         # MS-SSIM is NaN below 176 pixels: null in JSON
        return round(float(v), 6) if np.isfinite(v) else None

    points.sort(key=lambda r: r["bpp"])
    curve = {
        "psnr": [round(r["psnr"], 4) for r in points],
        "bpp": [round(r["bpp"], 6) for r in points],
        "ms_ssim": [finite(r["ms_ssim"]) for r in points],
        "lambda": [r["lambda"] for r in points],
        "enc_time": [round(r["enc_time"], 4) for r in points],
        "dec_time": [round(r["dec_time"], 4) for r in points],
        "n_images": points[0]["n_images"] if points else 0,
        "eval_set": args.images
        or f"dead_leaves({args.n_images}x{args.image_size},seed=7919)",
        "backend": args.backend, "device": str(codec.device),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(curve, f, indent=2, allow_nan=False)
    print(json.dumps(curve))
    return curve


if __name__ == "__main__":
    main()
