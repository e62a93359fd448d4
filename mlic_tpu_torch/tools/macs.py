"""Decoder MACs and parameters of a configuration (port of
``tools/macs.py``).

Counts the operations of the decoder-only proxy
``MLICPlusPlus.net_decoder_forward`` at 1920x1088 with
``torch.utils.flop_counter.FlopCounterMode`` and prints GMACs (FLOPs / 2),
as the reference's deepspeed ``get_macs`` (``MLIC++/utils/testing.py:
311-331``) does.  FlopCounterMode counts convolutions and matrix products
(mm, addmm, bmm, baddbmm), not elementwise work, where the JAX tool's XLA
``cost_analysis`` counts every flop: the two counts differ by that
elementwise share (``PARITY_GMACS`` holds the JAX tool's numbers).

The count runs on the ``meta`` device (shapes only, no memory, no
arithmetic) wherever the caller runs it; on the card (the default) the
forward also runs for real on seeded weights and its milliseconds are
timed with CUDA events.

    python -m mlic_tpu_torch.tools.macs --model MLICPP_L --dense
    python -m mlic_tpu_torch.tools.macs --model MLICPP_TINY --height 128 \\
        --width 128 --cpu
"""

from __future__ import annotations

import argparse
import json

import torch

from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.models.registry import get_model

# The JAX tool's counts at 1920x1088 (PARITY.md:9-12): XLA cost analysis,
# every flop counted.
PARITY_GMACS = {("MLICPP_S", None): 205.73,
                ("MLICPP_M_SMALL_DEC", None): 186.65,
                ("MLICPP_L", False): 1617.28,
                ("MLICPP_L", None): 757.18}


def _model(name: str, depthwise: bool | None):
    return get_model(name) if depthwise is None else \
        get_model(name, depthwise=depthwise)


def param_count(name: str, depthwise: bool | None = None) -> int:
    """Parameters of the configuration (built on the meta device)."""
    with torch.device("meta"):
        model = _model(name, depthwise)
    return sum(p.numel() for p in model.parameters())


def decoder_flops(name: str, h: int = 1088, w: int = 1920,
                  depthwise: bool | None = None) -> int:
    """FLOPs of ``net_decoder_forward`` on a [1, h, w, 3] image, counted
    by FlopCounterMode on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = _model(name, depthwise)
        x = torch.zeros(1, h, w, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.net_decoder_forward(x)
    return counter.get_total_flops()


def forward_ms(name: str, h: int, w: int, depthwise: bool | None,
               device, reps: int = 5) -> float:
    """Milliseconds of one ``net_decoder_forward`` on the card, seeded
    weights, by CUDA events over ``reps`` calls after one warm-up."""
    from mlic_tpu_torch.weights import init_params
    model = _model(name, depthwise)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    model = model.to(device).eval()
    x = torch.zeros(1, h, w, 3, device=device)
    with torch.no_grad():
        model.net_decoder_forward(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            model.net_decoder_forward(x)
        end.record()
        torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def decoder_cost(name: str, h: int = 1088, w: int = 1920,
                 depthwise: bool | None = None, device=None) -> dict:
    """GMACs, GFLOPs and parameters of the decoder of ``name``; on a CUDA
    ``device`` also the forward's ms and the card's name."""
    device = resolve_device(device)
    flops = decoder_flops(name, h, w, depthwise)
    out = {"model": name, "resolution": f"{w}x{h}",
           "gflops": flops / 1e9, "gmacs": flops / 2e9,
           "params_m": param_count(name, depthwise) / 1e6,
           "counter": "torch FlopCounterMode (conv, mm, bmm)"}
    parity = PARITY_GMACS.get((name, depthwise)) if (h, w) == (1088, 1920) \
        else None
    out["parity_gmacs_xla"] = parity
    if device.type == "cuda":
        out["forward_ms"] = forward_ms(name, h, w, depthwise, device)
        out["device"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--dense", action="store_true",
                   help="normal convs (depthwise=False), the published "
                        "MLIC++ weights' variant")
    p.add_argument("--cpu", action="store_true",
                   help="count only, no forward on the card")
    args = p.parse_args(argv)
    out = decoder_cost(args.model, args.height, args.width,
                       depthwise=False if args.dense else None,
                       device="cpu" if args.cpu else None)
    if args.dense:
        out["convs"] = "dense"
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
