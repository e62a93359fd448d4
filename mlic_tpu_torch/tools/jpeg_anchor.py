"""Classical-codec RD anchors, JPEG or WebP through PIL, on the held-out
evaluation set (port of ``tools/jpeg_anchor.py``).

The reference's published anchors (Kodak, Tecnick, CLIC) were made on
images that are not in the repository, so a BD-rate against them compares
different content.  This tool codes the same held-out images the RD
sweeps evaluate (``tools.rd_curve``, ``tools.rd_vbr``) at a ladder of
qualities and writes the curve in their JSON form, so ``tools.bdrate``
compares like with like.  PSNR and MS-SSIM are the port's
``metrics.psnr`` / ``ms_ssim``, on the card unless ``--cpu``.

    python -m mlic_tpu_torch.tools.jpeg_anchor --out rd_jpeg.json
    python -m mlic_tpu_torch.tools.jpeg_anchor --codec webp --out rd_webp.json
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
import torch

from mlic_tpu_torch.data.folder import dead_leaves_pool, list_images, load_image
from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.metrics import ms_ssim, psnr


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Classical-codec RD anchor")
    p.add_argument("--out", required=True)
    p.add_argument("--codec", choices=("jpeg", "webp"), default="jpeg")
    p.add_argument("--images", default=None, help="eval image folder "
                   "(default: the RD sweep's held-out dead-leaves set)")
    p.add_argument("--n-images", type=int, default=8)
    p.add_argument("--image-size", type=int, default=320)
    p.add_argument("--qualities", nargs="+", type=int,
                   default=[10, 20, 35, 50, 65, 80, 92])
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from PIL import Image

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    if args.images:
        imgs = [load_image(p) for p in list_images(args.images)[:args.n_images]]
    else:
        imgs = list(dead_leaves_pool(args.n_images, args.image_size,
                                     seed=7919))
    fmt = {"jpeg": "JPEG", "webp": "WEBP"}[args.codec]

    points = []
    for q in args.qualities:
        bpp_sum = psnr_sum = ms_sum = 0.0
        ms_n = 0          # images large enough for the 5-scale pyramid
        for img in imgs:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format=fmt, quality=q)
            n_bits = 8 * buf.getbuffer().nbytes
            dec = np.asarray(Image.open(buf).convert("RGB"))
            a = torch.from_numpy(img.astype(np.float32) / 255.0)[None].to(dev)
            b = torch.from_numpy(dec.astype(np.float32) / 255.0)[None].to(dev)
            bpp_sum += n_bits / (img.shape[0] * img.shape[1])
            psnr_sum += float(psnr(a, b))
            if min(img.shape[:2]) >= 176:
                ms_sum += float(ms_ssim(a, b))
                ms_n += 1
        n = len(imgs)
        points.append({"quality": q, "bpp": bpp_sum / n, "psnr": psnr_sum / n,
                       "ms_ssim": ms_sum / ms_n if ms_n else None})
        print(f"q={q}: bpp={points[-1]['bpp']:.4f} "
              f"psnr={points[-1]['psnr']:.3f}", flush=True)

    points.sort(key=lambda r: r["bpp"])
    curve = {
        "psnr": [round(r["psnr"], 4) for r in points],
        "bpp": [round(r["bpp"], 6) for r in points],
        "ms_ssim": [None if r["ms_ssim"] is None else round(r["ms_ssim"], 6)
                    for r in points],
        "quality": [r["quality"] for r in points],
        "codec": {"jpeg": "JPEG (PIL, 4:2:0)", "webp": "WebP (PIL)"}[args.codec],
        "eval_set": args.images
        or f"dead_leaves({args.n_images}x{args.image_size},seed=7919)",
        "device": str(dev),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(curve, f, indent=2, allow_nan=False)
    print(json.dumps(curve))
    return curve


if __name__ == "__main__":
    main()
