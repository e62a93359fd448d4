"""VBR rate-distortion sweep (port of ``tools/rd_vbr.py``): one model,
every gain level and continuous rates between them, through real files.

    python -m mlic_tpu_torch.tools.rd_vbr --checkpoint DIR --out FILE.json \\
        [--model MLICPP_S_VBR] [--images DIR] [--interp 2] \\
        [--backend device|steps|fused] [--cpu]

Evaluates the VBR model at every level ``s`` (reference ``test_model_vbr``,
``utils/testing.py:427-571``) with ``eval.evaluate_codec``, which requires
each decoded file to reproduce the encoder's reconstruction bit for bit,
then at ``--interp`` continuous gains, the geometric midpoints of the
largest adjacent gains, coded through ``inputscale``.  Writes the curve
(sorted by gain) as strict JSON and prints it; raises if the rate is not
monotone in the gain, and warns if PSNR is not.  ``--checkpoint`` is an
orbax directory or a torch file, taken by ``load_matching`` (a fixed-rate
checkpoint serves its VBR twin, Gain at its initial values); without it
the weights are seeded random ones.  Images: ``--images`` (padded to
multiples of 64) or ``--n-images`` dead-leaves frames of ``--image-size``
(seed 7919, as the JAX tool).  Runs on the CUDA card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from mlic_tpu_torch.codec import BACKENDS, Codec
from mlic_tpu_torch.data.folder import dead_leaves_pool, list_images, load_image
from mlic_tpu_torch.eval import evaluate_codec, pad_to_multiple
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import init_params, load_checkpoint


def holdout_images(args) -> list:
    """[1, H, W, 3] float frames in [0, 1] (rd_curve.py:55)."""
    if args.images:
        return [pad_to_multiple(load_image(p).astype(np.float32)[None]
                                / 255.0)[0]
                for p in list_images(args.images)[:args.n_images]]
    pool = dead_leaves_pool(args.n_images, args.image_size, seed=7919)
    return [f.astype(np.float32)[None] / 255.0 for f in pool]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="VBR RD sweep through the real "
                                "codec (PyTorch)")
    p.add_argument("--model", default="MLICPP_S_VBR")
    p.add_argument("--checkpoint", "--ckpt", default=None,
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--out", required=True)
    p.add_argument("--images", default=None)
    p.add_argument("--n-images", type=int, default=6)
    p.add_argument("--image-size", type=int, default=320)
    p.add_argument("--interp", type=int, default=2,
                   help="continuous-rate points (geometric midpoints of "
                        "adjacent gains), coded through inputscale")
    p.add_argument("--backend", default="device", choices=BACKENDS)
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"])
    p.add_argument("--save-dir", default="./runs/rd_vbr_eval")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    model = get_model(args.model, args.transform_dtype)
    if not model.cfg.vbr:
        raise ValueError(f"{args.model} is not a variable-bitrate model")
    state = init_params(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        state, _ = load_matching(state, load_checkpoint(args.checkpoint))
    model.load_state_dict(state, strict=True)
    codec = Codec(model, device="cpu" if args.cpu else None,
                  backend=args.backend)
    codec.update()
    images = holdout_images(args)

    gains = model.Gain.detach().abs().cpu().numpy()
    points = []
    for s in range(len(gains)):
        res = evaluate_codec(codec, images,
                             os.path.join(args.save_dir, f"s{s}"), s=s)
        res.update(level=s, gain=float(gains[s]),
                   lmbda=model.cfg.lmbda[s], kind="level")
        points.append(res)
        print(f"s={s} gain={gains[s]:.4f}: bpp={res['bpp']:.4f} "
              f"psnr={res['psnr']:.3f}", flush=True)
    order = np.argsort(gains)
    top = order[-args.interp - 1:] if args.interp else []
    mids = [float(np.sqrt(gains[a] * gains[b]))
            for a, b in zip(top[:-1], top[1:])]
    for k, isc in enumerate(mids):
        res = evaluate_codec(codec, images,
                             os.path.join(args.save_dir, f"i{k}"), s=0,
                             inputscale=isc)
        res.update(level=None, gain=isc, lmbda=None, kind="inputscale")
        points.append(res)
        print(f"inputscale={isc:.4f}: bpp={res['bpp']:.4f} "
              f"psnr={res['psnr']:.3f}", flush=True)

    # A larger gain quantizes finer: more bits and a better image, on the
    # levels and the interpolated points alike.
    pts = sorted(points, key=lambda r: r["gain"])
    bpps = [r["bpp"] for r in pts]
    psnrs = [r["psnr"] for r in pts]
    mono_rate = all(b2 >= b1 - 1e-4 for b1, b2 in zip(bpps, bpps[1:]))
    mono_psnr = all(p2 >= p1 - 0.05 for p1, p2 in zip(psnrs, psnrs[1:]))

    def finite(v):         # MS-SSIM is NaN below 176 pixels: null in JSON
        return float(v) if np.isfinite(v) else None

    curve = {
        "psnr": psnrs, "bpp": bpps,
        "ms_ssim": [finite(r["ms_ssim"]) for r in pts],
        "gain": [r["gain"] for r in pts], "level": [r["level"] for r in pts],
        "kind": [r["kind"] for r in pts],
        "enc_time": [r["enc_time"] for r in pts],
        "dec_time": [r["dec_time"] for r in pts],
        "monotone_rate": mono_rate, "monotone_psnr": mono_psnr,
        "model": args.model, "checkpoint": args.checkpoint,
        "backend": args.backend, "device": str(codec.device),
        "eval_set": args.images
        or f"dead_leaves({args.n_images}x{args.image_size},seed=7919)",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(curve, f, indent=2, allow_nan=False)
    print(json.dumps(curve))
    if not mono_psnr:
        print("WARNING: PSNR not monotone in the gain", file=sys.stderr)
    if not mono_rate:
        raise AssertionError(f"rate not monotone in the gain: {bpps}")
    return curve


if __name__ == "__main__":
    main()
