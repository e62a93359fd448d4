"""Offline evaluation CLI (port of ``tools/test.py``).

    python -m mlic_tpu_torch.tools.test --dataset DIR [--model MLICPP_S]
        [--checkpoint FILE] [--save-dir DIR] [--transform-dtype NAME]
        [--level S] [--backend device|steps|fused] [--cpu]

Compresses every image of a folder to a real bitstream file, decompresses it
and reports bpp, PSNR, MS-SSIM and the encode and decode wall-clock.  Runs
on the CUDA card unless ``--cpu`` is given.  ``--checkpoint`` is an orbax
directory of the JAX package (e.g. ``ckpts/bench_default``, the trained
MLICPP_S) or a torch file of the port (``weights.load_checkpoint``);
without it the weights are seeded random ones, which exercise the codec
but compress nothing.  ``--level`` codes a VBR model (e.g. MLICPP_S_VBR)
at that gain level and writes the VBR header; without it a VBR model codes
at level 0, as the reference CLI does.
``--backend`` picks the codec's backend: ``device`` (format v4, both rANS
directions on the card; the port's default; format v3 under
``MLIC_UNIFIED_Z=0``) or the reference's host-coded ``steps`` / ``fused``
streams (the JAX CLI's default is ``steps``).
``MLIC_FUSED_BLOCKS=1`` in the environment selects the fused block-tail
kernel in g_a and g_s.  The codec picks its rANS lane count from the first
image's size (``Codec(n_lanes="auto")``), as the reference CLI does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mlic_tpu_torch.codec import BACKENDS, Codec
from mlic_tpu_torch.data.folder import list_images, load_image
from mlic_tpu_torch.eval import evaluate_codec
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import init_params, load_checkpoint


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="MLIC++ codec evaluation (PyTorch)")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--dataset", required=True, help="image folder (e.g. Kodak)")
    p.add_argument("--checkpoint", default=None,
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--save-dir", default="./runs/eval")
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"])
    p.add_argument("--level", type=int, default=None, help="VBR gain level")
    p.add_argument("--backend", default="device", choices=BACKENDS,
                   help="device: format v4 on the card (the port's "
                        "default); steps or fused: the reference's "
                        "host-coded streams (the JAX CLI's default: steps)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    files = list_images(args.dataset)
    if not files:
        raise FileNotFoundError(f"no images under {args.dataset}")
    model = get_model(args.model, args.transform_dtype)
    if args.checkpoint:
        state = load_checkpoint(args.checkpoint)
    else:
        state = init_params(model, torch.Generator().manual_seed(0))
    model.load_state_dict(state, strict=True)
    codec = Codec(model, device="cpu" if args.cpu else None,
                  backend=args.backend)
    codec.update()
    images = (load_image(f).astype(np.float32) / 255.0 for f in files)
    results = evaluate_codec(codec, images, args.save_dir, s=args.level)
    print("avg:", {k: round(v, 5) if isinstance(v, float) else v
                   for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
