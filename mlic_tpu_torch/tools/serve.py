"""Batch serving CLI (port of ``tools/serve.py``): pipelined compress
(and, with ``--verify``, decompress) of an image stream.

    python -m mlic_tpu_torch.tools.serve --synthetic --n 32 --batch 8 \\
        --out DIR [--checkpoint ckpts/bench_default] [--verify] \\
        [--transform-dtype bfloat16] [--cpu]
    python -m mlic_tpu_torch.tools.serve --images DIR --verify
    python -m mlic_tpu_torch.tools.serve --synthetic --sharded --verify

Drives the device backend's two-deep pipeline -- ``Codec.roundtrip_stream``
with ``--verify``, else ``compress_begin`` of batch i+1 queued before
``compress_end`` of batch i -- over a folder of images cropped to
``--size`` or a synthetic dead-leaves stream, writes one container an
image in the eval format (header (H, W), then the body: what
``eval.decompress_one_image`` and ``tools/decode.py`` read), and prints
one JSON line: images, img/s, bpp, the tables the codec codes with
(``parametric``, ``analytic_enc_rows``: a fallback of ``update`` shows
there), the shards, and the device with, on the card, its name and power
limit (``nvidia-smi``).  ``--sharded`` serves through
``parallel.serving.ShardedCodec`` over every visible card (the CPU with
``--cpu``), one replica a card, the batch split evenly over them.  It is
the counterpart of the JAX package's mesh serving, not a way to scale
out: one host thread issues every replica's launches and the path is
bound by the host, so it serves slower than one card does (PERF.md).
The first batch warms up both directions and is not timed.  Runs on the
CUDA card unless ``--cpu`` is given.  ``--checkpoint`` is an orbax
directory of the JAX package or a torch file, taken by
``load_matching``; without it the weights are seeded random ones.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.data.folder import dead_leaves_pool, list_images, load_image
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.parallel.serving import ShardedCodec
from mlic_tpu_torch.utils import bitstream
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import init_params, load_checkpoint


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (v.strip() for v in out.split(","))
    return {"name": name, "power_limit": limit}


def _frames(args, h: int, w: int):
    """(frames uint8 [H, W, 3] of exactly the static size, names)."""
    if args.images:
        frames, names = [], []
        for path in list_images(args.images):
            a = load_image(path)[:h, :w]
            if a.shape[:2] == (h, w):
                frames.append(a)
                names.append(os.path.splitext(os.path.basename(path))[0])
        return frames, names
    pool = dead_leaves_pool(args.n, h, seed=1303, width=w)
    return list(pool), [f"frame{i:04d}" for i in range(len(pool))]


def _write(out_dir, names, k: int, batch: int, enc: dict, hw) -> None:
    """Per-image containers in the eval format (serve.py:138)."""
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    for j in range(batch):
        strings = [[enc["strings"][0][j]], [enc["strings"][1][j]]]
        with open(os.path.join(out_dir, names[k * batch + j] + ".bin"),
                  "wb") as f:
            bitstream.write_uints(f, hw)
            bitstream.write_body(f, enc["shape"], strings)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="MLIC++ pipelined serving "
                                "(PyTorch)")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--checkpoint", "--ckpt", default=None,
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--images", default=None, help="directory of images")
    p.add_argument("--synthetic", action="store_true",
                   help="serve synthetic dead-leaves frames")
    p.add_argument("--n", type=int, default=16, help="synthetic frame count")
    p.add_argument("--size", type=int, nargs=2, default=(512, 768),
                   metavar=("H", "W"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--out", default=None, help="write .bin containers here")
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"])
    p.add_argument("--verify", action="store_true",
                   help="decode every batch and check the reconstruction")
    p.add_argument("--sharded", action="store_true",
                   help="one codec replica on each visible card, the batch "
                        "split over them; slower than one card, as one "
                        "host thread issues every replica's launches")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if not args.images and not args.synthetic:
        p.error("one of --images or --synthetic is needed")
    h, w = args.size
    if h % 64 or w % 64:
        p.error("serve takes sizes that are multiples of 64")

    frames, names = _frames(args, h, w)
    n = len(frames) // args.batch * args.batch
    if n == 0:
        raise ValueError("not enough images of the size for one batch")
    model = get_model(args.model, args.transform_dtype)
    state = init_params(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        state, _ = load_matching(state, load_checkpoint(args.checkpoint))
    model.load_state_dict(state, strict=True)
    if args.sharded:
        devices = (["cpu"] if args.cpu else
                   [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        codec = ShardedCodec(model, devices, n_lanes=args.lanes,
                             encode_recon=args.verify)
    else:
        codec = Codec(model, n_lanes=args.lanes,
                      device="cpu" if args.cpu else None,
                      encode_recon=args.verify)
        devices = [codec.device]
    codec.update()
    batches = [np.stack(frames[k:k + args.batch])
               for k in range(0, n, args.batch)]

    warm = codec.compress(batches[0])           # both directions, untimed
    if args.verify:
        codec.decompress(warm["strings"], warm["shape"])
    total_bits = 0
    t0 = time.perf_counter()
    if args.verify:
        for k, (enc, dec) in enumerate(codec.roundtrip_stream(batches)):
            total_bits += 8 * sum(len(s) for g in enc["strings"] for s in g)
            if not torch.equal(dec["x_hat"], enc["x_hat"]):
                raise AssertionError(f"batch {k}: the decoder's x_hat is "
                                     "not the encoder's")
            _write(args.out, names, k, args.batch, enc, (h, w))
    else:
        hnd = codec.compress_begin(batches[0])
        for k in range(len(batches)):
            nxt = (codec.compress_begin(batches[k + 1])
                   if k + 1 < len(batches) else None)
            enc = codec.compress_end(hnd)
            total_bits += 8 * sum(len(s) for g in enc["strings"] for s in g)
            _write(args.out, names, k, args.batch, enc, (h, w))
            hnd = nxt
        for d in devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
    elapsed = time.perf_counter() - t0
    out = {"images": n, "img_s": n / elapsed,
           "bpp": total_bits / (n * h * w), "verify": args.verify,
           "sharded": args.sharded, "shards": len(devices),
           "parametric": codec.parametric,
           "analytic_enc_rows": codec.analytic_enc_rows,
           "device": str(codec.device)}
    if codec.device.type == "cuda":
        out.update(card())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
