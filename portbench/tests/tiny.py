"""A throwaway cell at a size the CPU holds: MLICPP_TINY on seeded weights,
64x64 frames in batches of 2, written as files into a copy of the
benchmark's folder, as a later change would add its own.

The tiny configuration has no checkpoint in the repository: ``patches``
gives the harness's loaders (the program's and the reference's) weights
drawn from a seed in its place, and a CPU run's device reading and
profiled activity."""

from __future__ import annotations

import json
import math
import os
import shutil
import types

import torch

from portbench.paths import BENCH

CONFIG = {"name": "tiny", "source": "test", "reference": "mlicpp",
          "model": {"program_name": "MLICPP_TINY", "N": 32, "M": 64,
                    "slice_num": 2, "context_window": 5, "depthwise": True,
                    "transform_dtype": "bfloat16"},
          "checkpoint": "seeded-11", "lanes": 16,
          # set from the CPU's readings at this size: a sound run reads
          # y_flips 0.2-0.5% and x_gap 0.04-0.07, y_gap 2.4e-7, rate_gap
          # 0.10-0.40 (4 seeds); the control 3.5-4.8%, 0.56-0.85 and
          # 2.5e-4; the scales doubled rate_gap 3.39-3.72
          "limits": {"y_roundtrip": 0, "z_flips": 2.0, "y_flips": 1.5,
                     "y_gap": 1e-5, "x_gap": 0.2, "rate_gap": 2.0}}
SEED = 11


def mix(loop: str) -> dict:
    return {"loop": loop, "batch": 2, "height": 64, "width": 64,
            "disks": 30, "pool_batches": 8, "warm_batches": 2,
            "trace_batches": 3,
            "stage_batches": 2, "sample_batches": 2, "sample_images": 2}


PER_LAYER = {
    "bulk": (("stage_ms.host", "ms"), ("stage_ms.analyze", "ms"),
             ("stage_ms.synthesize", "ms"), ("stage_ms.encode_pass", "ms"),
             ("stage_ms.entropy_decode", "ms"),
             ("stage_ms.rans_encode", "ms"), ("k8_roofline", "%"),
             ("rans_roofline", "%"), ("device_idle", "%"), ("mfu", "%")),
    "request": (("stage_ms.analyze.request", "ms"),
                ("stage_ms.encode_pass.request", "ms"),
                ("stage_ms.rans_encode.request", "ms"),
                ("stage_ms.assemble.request", "ms"),
                ("stage_ms.parse.request", "ms"),
                ("stage_ms.entropy_decode.request", "ms"),
                ("stage_ms.synthesize.request", "ms"),
                ("k8_roofline.encode", "%"), ("k8_roofline.decode", "%"),
                ("rans_roofline.encode", "%"), ("rans_roofline.decode", "%"),
                ("device_idle.encode", "%"), ("device_idle.decode", "%"),
                ("mfu.encode", "%"), ("mfu.decode", "%"))}
# metrics a CPU run has nothing to read for: no device kernel in its trace
DEVICE_ONLY = ("k8_roofline", "rans_roofline", "k8_roofline.encode",
               "k8_roofline.decode", "rans_roofline.encode",
               "rans_roofline.decode")


def bench(cells: dict) -> dict:
    """A BENCHMARK.json of ``cells`` ({name: loop}); the bulk cells report
    the throughput, the request cells the two tails."""
    req = [n for n, loop in cells.items() if loop == "request"]
    bulk = [n for n, loop in cells.items() if loop == "bulk"]
    return {
        "workloads": [{"name": n, "config": "tiny", "traffic": f"tiny_{loop}",
                       "chips": 1} for n, loop in cells.items()],
        "end_to_end": [
            {"name": "roundtrip_img_s", "unit": "img/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": bulk},
            {"name": "encode_ms_p90", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock", "workloads": req},
            {"name": "decode_ms_p90", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock", "workloads": req},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": n, "unit": u, "better": "lower",
                       "source": "device_trace", "layer": "test",
                       "moves": "roundtrip_img_s" if loop == "bulk" else
                       "decode_ms_p90",
                       "workloads": [c for c, lp in cells.items()
                                     if lp == loop]}
                      for loop, names in PER_LAYER.items()
                      for n, u in names]}


def make_base(tmp: str) -> str:
    """A copy of the benchmark's folder with the tiny configuration and
    its two mixes added as files."""
    base = os.path.join(tmp, "portbench")
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(base, "configs", "tiny.json"), "w") as f:
        json.dump(CONFIG, f)
    for loop in ("bulk", "request"):
        with open(os.path.join(base, "traffic", f"tiny_{loop}.json"),
                  "w") as f:
            json.dump(mix(loop), f)
    return base


def args(workload: str, trace: int = 0, seed: int = 2**31 + 4099,
         seconds: float = 1.0):
    return types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace)


def seeded_weights(model, seed: int) -> dict:
    """Weights drawn from ``seed``: {state_dict name: float32 CPU tensor},
    in the program's layout; ``reference_params`` gives the same tensors
    in the reference's."""
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    ped = (2.0 ** -18) ** 2
    out = {}
    for name, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if name.startswith("entropy_bottleneck."):
            if leaf.startswith("matrix_"):
                v = torch.full(shape, math.log(math.expm1(
                    1.0 / 10.0 ** 0.2 / shape[1])))
            elif leaf.startswith("bias_"):
                v = torch.rand(shape, generator=gen) - 0.5
            elif leaf == "quantiles":
                v = torch.tensor([-10.0, 0.0, 10.0]).reshape(1, 1, 3).repeat(
                    shape[0], 1, 1)
            else:
                v = torch.zeros(shape)
        elif leaf == "beta":
            v = torch.full(shape, math.sqrt(1.0 + ped))
        elif leaf == "gamma":
            v = torch.sqrt(0.1 * torch.eye(shape[0]) + ped)
        elif leaf == "rel_pos_table":
            v = 0.02 * torch.randn(shape, generator=gen)
        elif leaf == "weight" and len(shape) == 1:        # LayerNorm
            v = torch.ones(shape)
        elif leaf == "weight":
            fan_in = math.prod(shape[1:])
            v = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        else:
            v = 0.01 * torch.randn(shape, generator=gen)
        out[name] = v.float()
    return out


def reference_params(state_dict: dict, device) -> dict:
    """The program's state_dict names and layouts -> the reference's
    (checkpoint paths; ``weight`` is a ``kernel``, or a LayerNorm's
    ``scale``)."""
    out = {}
    for name, t in state_dict.items():
        *parents, leaf = name.split(".")
        if leaf == "weight":
            leaf = "scale" if t.dim() == 1 else "kernel"
        out["/".join(parents + [leaf])] = t.to(device)
    return out


def tiny_state(seed: int = SEED) -> dict:
    from mlic_tpu_torch.models.registry import get_model
    return seeded_weights(get_model("MLICPP_TINY"), seed)


def patches() -> list:
    """[(module, attribute, value)]: the tiny configuration's weights for
    the program's and the reference's loaders, the CPU's device reading,
    the profiler on the host's activity."""
    from portbench import codec_sut, core
    from portbench.reference import mlicpp
    state = tiny_state()
    return [(codec_sut, "load_weights", lambda cfg: state),
            (mlicpp, "load_params",
             lambda path, device: reference_params(state, device)),
            (core, "device_info", lambda device, chips: {
                "platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}),
            (core, "PROFILED", "CPU")]


def install() -> None:
    """Apply ``patches`` for the life of the process."""
    for mod, name, value in patches():
        setattr(mod, name, value)
