"""Time of each NN module of a configuration at the serving latent shapes
(port of ``tools/profile_modules.py``).

Times each module class alone, with the instance counts a codec pass uses
(per slice: LocalContext once, the entropy parameters and the LRPs twice,
the global intra context from the second slice on), so that work on the
kernels goes where the time is.  Each call is timed by itself: CUDA events
around it, then a synchronize, the median over ``PM_REPS`` calls after a
warm-up (on the CPU the host clock).  Seeded random weights: the time
depends on the shapes, not the values.

    python -m mlic_tpu_torch.tools.profile_modules          (on the card)
    PM_MODEL=MLICPP_TINY PM_BATCH=1 PM_REPS=1 PM_HEIGHT=64 PM_WIDTH=64 \\
        python -m mlic_tpu_torch.tools.profile_modules --cpu

Environment: PM_MODEL (MLICPP_S), PM_BATCH (8), PM_REPS (10), PM_HEIGHT /
PM_WIDTH (512 x 768).  Prints one JSON line, the modules by time a pass.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.models.config import model_config
from mlic_tpu_torch.models.context import (
    ChannelContext,
    EntropyParameters,
    LatentResidualPrediction,
    LinearGlobalInterContext,
    LinearGlobalIntraContext,
    LocalContext,
)
from mlic_tpu_torch.models.transforms import (
    AnalysisTransform,
    HyperAnalysis,
    HyperSynthesis,
    SynthesisTransform,
)
from mlic_tpu_torch.weights import init_params


def seeded(module: torch.nn.Module, device, seed: int = 0):
    """``module`` with seeded weights (the flax initializers' families), on
    ``device``, in eval mode."""
    module.load_state_dict(init_params(module,
                                       torch.Generator().manual_seed(seed)))
    return module.to(device).eval()


def latents(cfg, B: int, H: int, W: int, device, seed: int = 0) -> dict:
    """Seeded NCHW inputs at the codec's shapes: the image, y, z, a slice."""
    g = torch.Generator().manual_seed(seed)
    h, w = H // 16, W // 16

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device)

    return {"x": randn(B, 3, H, W), "y": randn(B, cfg.M, h, w),
            "z": randn(B, cfg.N, h // 4, w // 4),
            "slice": randn(B, cfg.slice_ch, h, w), "h": h, "w": w,
            "randn": randn}


def transform_cases(cfg, t: dict, device):
    """(label, module, args, calls a pass) of the four transforms."""
    N, M = cfg.N, cfg.M
    return [
        ("g_a (AnalysisTransform)", seeded(AnalysisTransform(N, M), device),
         (t["x"],), 1),
        ("h_a (HyperAnalysis)", seeded(HyperAnalysis(M, N), device),
         (t["y"],), 1),
        ("h_s (HyperSynthesis)", seeded(HyperSynthesis(M, N), device),
         (t["z"],), 1),
        ("g_s (SynthesisTransform)", seeded(SynthesisTransform(N, M),
                                            device), (t["y"],), 1),
    ]


def context_cases(cfg, t: dict, device, widths=None):
    """(label, module, args, calls a pass) of the context modules; the
    channel and inter contexts at the slice indexes ``widths`` (default:
    the first and the last that have them)."""
    M, S, C = cfg.M, cfg.slice_num, cfg.slice_ch
    B, h, w = t["slice"].shape[0], t["h"], t["w"]
    randn = t["randn"]
    out = [("LocalContext",
            seeded(LocalContext(C, window_size=cfg.context_window), device),
            (t["slice"],), S)]
    for i in widths or sorted({1, S - 1}):
        cat = randn(B, C * i, h, w)
        out.append((f"ChannelContext[i={i}]",
                     seeded(ChannelContext(C * i, C), device), (cat,), 1))
        out.append((f"GlobalInter[i={i}]", seeded(LinearGlobalInterContext(
            C * i, 2 * C, max(C * i // 32, 1)), device), (cat,), 1))
    out.append(("GlobalIntra", seeded(LinearGlobalIntraContext(C), device),
                (t["slice"], t["slice"]), S - 1))
    ep_in = 2 * M + 10 * C
    out.append(("EntropyParameters(widest)",
                seeded(EntropyParameters(ep_in, 2 * C), device),
                (randn(B, ep_in, h, w),), 2 * S))
    lrp_in = M + S * C
    out.append(("LRP(widest)",
                seeded(LatentResidualPrediction(lrp_in, C), device),
                (randn(B, lrp_in, h, w),), 2 * S))
    return out


def call_ms(fn, reps: int, device) -> float:
    """Median ms of one call of ``fn``, each timed alone after a warm-up:
    CUDA events and a synchronize on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def row(label: str, ms: float, count: int) -> dict:
    print(f"{label:36s} {ms:9.3f} ms x{count} = {ms * count:9.3f} ms/pass",
          flush=True)
    return {"module": label, "ms_per_call": ms, "calls_per_pass": count,
            "ms_per_pass": ms * count}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="time of each module")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    name = os.environ.get("PM_MODEL", "MLICPP_S")
    B = int(os.environ.get("PM_BATCH", "8"))
    reps = int(os.environ.get("PM_REPS", "10"))
    H = int(os.environ.get("PM_HEIGHT", "512"))
    W = int(os.environ.get("PM_WIDTH", "768"))
    cfg = model_config(name)
    t = latents(cfg, B, H, W, device)
    rows = []
    with torch.no_grad():
        for label, mod, inputs, count in (transform_cases(cfg, t, device)
                                          + context_cases(cfg, t, device)):
            rows.append(row(label, call_ms(lambda: mod(*inputs), reps,
                                           device), count))
    rows.sort(key=lambda r: -r["ms_per_pass"])
    out = {"model": name, "batch": B, "reps": reps, "latent": [t["h"], t["w"]],
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "modules": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
