"""Stream-format A/B (port of ``tools/ab_stream_format.py``): format v3
(z coded on the host into a z string of its own) against v4 (z inline,
both rANS directions on the device).

    python -m mlic_tpu_torch.tools.ab_stream_format [--batch 128] \\
        [--seg 3] [--reps 4] [--checkpoint ckpts/bench_default | --seeded] \\
        [--model MLICPP_S] [--size 512 768] [--lanes 512] [--cpu]

One model under ``bfloat16`` transforms, two device codecs at ``--lanes``
lanes without the encode-side synthesis (``MLIC_UNIFIED_Z`` 0 and 1 when
each is made), the same frames (24 dead-leaves frames, repeated to fill a
batch).  Each of ``--reps`` rounds runs one pipelined segment
(``Codec.roundtrip_stream`` over ``--seg`` batches) of each format, in two
regimes: staged (the frames already on the device) and
host upload (the frames in host memory); alternating the formats within a
round cancels drift of the machine.  Every segment's round trip must be
bit-exact (the decoder's y_hat the encoder's).  Prints one JSON line:
img/s per format and segment, the paired v4/v3 ratios, bpp per format,
the tables each codec codes with (``parametric``, ``analytic_enc_rows``:
a fallback of ``update`` shows there), and the device with, on the card, its name and power limit.  Runs on the
CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.data.folder import dead_leaves_pool
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools.serve import card
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import init_params, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORMATS = ("v3", "v4")
POOL = 24                       # distinct frames, as the JAX tool's


def make_codec(model, fmt: str, lanes: int, device) -> Codec:
    """A device codec of format ``fmt``: ``MLIC_UNIFIED_Z`` set while it is
    made, then restored."""
    saved = os.environ.get("MLIC_UNIFIED_Z")
    os.environ["MLIC_UNIFIED_Z"] = "1" if fmt == "v4" else "0"
    try:
        codec = Codec(model, n_lanes=lanes, device=device,
                      encode_recon=False)
    finally:
        if saved is None:
            os.environ.pop("MLIC_UNIFIED_Z")
        else:
            os.environ["MLIC_UNIFIED_Z"] = saved
    codec.update()
    return codec


def segment(codec, batches) -> tuple:
    """One pipelined segment: (seconds, bits written, bit-exact).  The
    equality of each batch's y_hat is kept on the device and read once
    at the end, so that checking it does not drain the pipeline."""
    same, bits = [], 0
    if codec.device.type == "cuda":
        torch.cuda.synchronize(codec.device)
    t0 = time.perf_counter()
    for enc, dec in codec.roundtrip_stream(batches):
        bits += 8 * sum(len(s) for g in enc["strings"] for s in g)
        same.append((enc["y_hat"] == dec["y_hat"]).all())
    exact = bool(torch.stack(same).all())
    return time.perf_counter() - t0, bits, exact


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="MLIC++ stream format v3 "
                                "against v4 (PyTorch)")
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--checkpoint", default=os.path.join(REPO, "ckpts",
                                                        "bench_default"),
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--seeded", action="store_true",
                   help="seeded random weights instead of --checkpoint")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seg", type=int, default=3, help="batches a segment")
    p.add_argument("--reps", type=int, default=4,
                   help="segments of each format in each regime")
    p.add_argument("--size", type=int, nargs=2, default=(512, 768),
                   metavar=("H", "W"))
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    h, w = args.size
    device = "cpu" if args.cpu else None

    model = get_model(args.model, "bfloat16")
    state = init_params(model, torch.Generator().manual_seed(0))
    if not args.seeded:
        state, _ = load_matching(state, load_checkpoint(args.checkpoint))
    model.load_state_dict(state, strict=True)
    codecs = {f: make_codec(model, f, args.lanes, device) for f in FORMATS}
    dev = codecs["v4"].device

    pool = dead_leaves_pool(POOL, h, seed=1303, width=w)
    host = [pool[[(k * args.batch + i) % len(pool)
                  for i in range(args.batch)]] for k in range(args.seg + 1)]
    staged = [torch.from_numpy(b).to(dev) for b in host]
    for f in FORMATS:                           # warm-up, untimed
        segment(codecs[f], staged[:2])

    img_s = {r: {f: [] for f in FORMATS} for r in ("staged", "host_upload")}
    bpp, exact = {}, True
    n_img = args.seg * args.batch
    for _ in range(args.reps):
        for regime, batches in (("staged", staged[1:]),
                                ("host_upload", host[1:])):
            for f in FORMATS:
                secs, bits, ok = segment(codecs[f], batches)
                img_s[regime][f].append(n_img / secs)
                bpp[f] = bits / (n_img * h * w)
                exact = exact and ok
    out = {"model": args.model, "seeded": args.seeded,
           "transform_dtype": "bfloat16", "batch": args.batch,
           "batches_a_segment": args.seg, "segments": args.reps,
           "size": [h, w], "lanes": args.lanes, "bpp": bpp,
           "bit_exact": exact,
           "tables": {f: {"parametric": c.parametric,
                          "analytic_enc_rows": c.analytic_enc_rows}
                      for f, c in codecs.items()},
           "device": str(dev)}
    for regime, by_fmt in img_s.items():
        ratios = [b / a for a, b in zip(by_fmt["v3"], by_fmt["v4"])]
        out[regime] = {**{f: {"median": float(np.median(v)), "all": v}
                          for f, v in by_fmt.items()},
                       "v4_over_v3_paired": ratios,
                       "v4_over_v3_median": float(np.median(ratios))}
    if dev.type == "cuda":
        out.update(card())
    print(json.dumps(out))
    if not exact:
        raise AssertionError("a segment's round trip was not bit-exact")
    return out


if __name__ == "__main__":
    main()
