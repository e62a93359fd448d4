"""One run of one cell: set-up, the measured window (or the traced
stretch), the comparison with the reference, and the result line.

The cell's files are found by name (``cells.py``).  The mix's loop
(``loops/<loop>.py``) drives the window and names the system under test
and the comparison (its ``SUT`` and ``JUDGE``, modules of ``portbench/``;
``codec_sut`` and ``judge`` where it names none): a ``SUT`` module has
``make(config, device, seed)``, whose object has ``device``, ``sync()``,
``name_spans(spans)`` and ``stages(pool, n)``; a ``JUDGE`` module has
``keeper(sut, pool, mix, seed, n_batches)``, whose object the loop calls
with each batch and whose ``close()`` and ``observed()`` give the kept
records and what the per-layer metrics read of them, ``compare(kept,
config, device)`` and ``reference_model(config, device)``.
"""

from __future__ import annotations

import gc
import importlib
import subprocess
import sys
import time

import torch

from portbench import frames
from portbench.cells import load_cell, metric_reader
from portbench.paths import BENCH

FORBIDDEN = ("jax", "jaxlib", "flax", "mlic_tpu")
# the profiler records the device's activity only: recording every host
# op would slow the host enough to starve the card in a host-bound cell
PROFILED = "CUDA"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_info(device, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": power_limit()}


def parts(loop) -> tuple:
    """(system-under-test module, comparison module) that ``loop`` names."""
    return (importlib.import_module(
                "portbench." + getattr(loop, "SUT", "codec_sut")),
            importlib.import_module(
                "portbench." + getattr(loop, "JUDGE", "judge")))


def traced(sut, judge, pool, mix, config, loop, seed, per_layer,
           base: str = BENCH) -> tuple:
    """The traced run's stretch: ``trace_batches`` batches of the normal
    loop under ``torch.profiler`` (the sample is drawn among them), the
    same count unprofiled for the time a batch and a direction, and
    ``stage_batches`` serial round trips by stage.  Returns (the loop's
    result, kept records, per-layer metrics, device busy_s and window_s,
    breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import Trace
    n = int(mix["trace_batches"])
    keep = judge.keeper(sut, pool, mix, seed, n)
    spans = []
    sut.name_spans(spans)
    with profile(activities=[getattr(ProfilerActivity, PROFILED)]) as prof:
        w0 = time.time_ns()
        res = loop.run(sut, pool, mix, batches=n, keep=keep)
        w1 = time.time_ns()
    kept = keep.close()
    trace = Trace(prof, spans, w0, w1, res["seconds"])
    del prof
    plain = loop.run(sut, pool, mix, batches=n)
    obs = {"config": config, "mix": mix, "trace": trace, "batches": n,
           "reference": lambda: judge.reference_model(
               config, torch.device("cpu")),
           "roundtrip_s": plain["seconds"] / n,
           "direction_s": plain.get("direction_s", {}),
           "stages": sut.stages(pool, int(mix["stage_batches"])),
           **keep.observed()}
    metrics = {}
    for m in per_layer:
        value = metric_reader(m["name"], base)(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": trace.top_ops(), "idle_gaps":
                 trace.idle_gaps()}
    return res, kept, metrics, (trace.busy_s, trace.window_s), breakdown


def run_cell(args, t_start: float, device=None, bench=None,
             base: str = BENCH) -> dict:
    """Run cell ``args.workload`` once; returns the result line's dict,
    or raises.  ``device`` None means the card (checked by ``run.py``);
    ``bench`` and ``base`` as ``load_cell`` takes them."""
    cell, config, mix, e2e, per_layer = load_cell(args.workload, bench, base)
    device = torch.device("cuda" if device is None else device)
    torch.set_grad_enabled(False)
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    sut_mod, judge = parts(loop)
    sut = sut_mod.make(config, device, args.seed)
    pool = frames.pool(mix, args.seed, device)
    t = time.perf_counter()
    loop.warm(sut, pool, mix)
    sut.sync()
    warm_s = (time.perf_counter() - t) / int(mix["warm_batches"])
    setup_s = time.perf_counter() - t_start
    busy = breakdown = None
    if args.trace:
        res, kept, metrics, busy, breakdown = traced(
            sut, judge, pool, mix, config, loop, args.seed, per_layer, base)
    else:
        n_min = max(1, int(0.5 * args.seconds / max(warm_s, 1e-3)))
        keep = judge.keeper(sut, pool, mix, args.seed, n_min)
        res = loop.run(sut, pool, mix, seconds=args.seconds, keep=keep)
        kept = keep.close()
        values = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]} for m in e2e}
    dev = device_info(device, int(cell["chips"]))
    if busy is not None:
        dev["busy_s"], dev["window_s"] = busy
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX side were loaded: {found}")
    del sut, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = judge.compare(kept, config, device)
    out = {"correct": correct, "attempted": res["images"], "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
