"""Standalone decoder CLI (port of ``tools/decode.py``; reference
``MLIC++/submit/decode.py``).

    python -m mlic_tpu_torch.tools.decode --model MLICPP_M_SMALL_DEC \\
        --bitstream-dir DIR --output-dir DIR [--checkpoint decoder.pt] \\
        [--vbr] [--cpu]

Decodes every ``.bin``/``.bit`` file of the directory (the container of
``eval.compress_one_image``; with ``--vbr`` the header that records the
gain level) through ``eval.decompress_one_image`` and writes one PNG each.
Each file is decoded as its streams say: format v4 on the device, or the
reference's host-coded streams (those of the ``steps`` and ``fused``
backends, the JAX eval CLI's default) through the host coder.
Runs on the CUDA card unless ``--cpu`` is given; ``MLIC_FUSED_BLOCKS=1``
selects the fused block tail (K5) in g_s.

The weights: the model is built by ``get_model`` and its state taken from
``--checkpoint`` (a decoder-only torch file of ``extract_decoder``, a full
torch file or an orbax directory) by ``load_matching``.  Every leaf outside
``g_a`` and ``h_a`` must be in the checkpoint with its shape, or the CLI
refuses it; the encoder's leaves may be absent and then keep their
construction values, which decoding never reads.  Without
``--checkpoint`` the weights are seeded random ones, as in
``tools/test.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.eval import decompress_one_image
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools.extract_decoder import is_encoder
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import init_params, load_checkpoint


def decoder_state(model, checkpoint: str) -> dict:
    """The model's state with every decoder leaf taken from
    ``checkpoint``; raises when one is missing or has another shape."""
    merged, taken = load_matching(model.state_dict(),
                                  load_checkpoint(checkpoint))
    missing = sorted(set(merged) - set(taken) - {
        k for k in merged if is_encoder(k)})
    if missing:
        raise ValueError(f"{checkpoint}: {len(missing)} decoder leaves "
                         f"missing or of another shape, e.g. {missing[:3]}")
    return merged


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="MLIC++ standalone decoder "
                                "(PyTorch)")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--bitstream-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="decoder-only or full torch file, or orbax directory")
    p.add_argument("--transform-dtype", default=None,
                   choices=["float32", "bfloat16", "bfloat16_mixed"])
    p.add_argument("--vbr", action="store_true",
                   help="the files carry the VBR header (gain level)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    from PIL import Image

    model = get_model(args.model, args.transform_dtype)
    if args.checkpoint:
        state = decoder_state(model, args.checkpoint)
    else:
        state = init_params(model, torch.Generator().manual_seed(0))
    model.load_state_dict(state, strict=True)
    codec = Codec(model, device="cpu" if args.cpu else None)
    codec.update()
    os.makedirs(args.output_dir, exist_ok=True)
    out = {}
    for name in sorted(os.listdir(args.bitstream_dir)):
        if not name.endswith((".bin", ".bit")):
            continue
        dec = decompress_one_image(
            codec, os.path.join(args.bitstream_dir, name), vbr=args.vbr)
        img = np.clip(dec["x_hat"][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        dst = os.path.join(args.output_dir,
                           os.path.splitext(name)[0] + ".png")
        Image.fromarray(img).save(dst)
        out[name] = dec["x_hat"]
        print(f"{name} -> {dst} ({dec['dec_time'] * 1e3:.1f} ms)")
    return out


if __name__ == "__main__":
    main()
