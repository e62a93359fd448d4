"""Readings for the limits of the comparison: one cell's program over many
seeds, and the control on some of them, in one process.

    python3 portbench/calibrate.py --workload S.bulk128 \
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11 \
        --seconds 3

For each seed it makes that seed's frames, runs a short window of the
cell's own loop at its own batch and frame size, and judges the sampled
images as a run does; for each control seed it also judges the control
(the reference in lower precision) on the same frames; for each fault
seed it runs the window again with a fault planted in the program for
each factor of ``--scale-factors``: the scale half of every
entropy-parameters output multiplied by it in both directions (wrong CDF
rows that encoder and decoder share: y_hat and x_hat stay exact, the
rate moves).  One JSON
line a seed, then the largest reading of each number over the program's
seeds and the smallest over the control's and the fault's.  Not run by
the benchmark's own runs; the set-up is shared so that a dozen seeds
cost one set-up.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--scale-factors", default="2,0.5")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import cells
    cell, config, mix, _, _ = cells.load_cell(args.workload)
    cells.apply_env(config)
    import torch

    from portbench import core, frames
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    sut_mod, judge = core.parts(loop)
    dev = torch.device("cuda")
    sut = sut_mod.make(config, dev, 0)
    ref = judge.reference_model(config, dev)
    control = judge.reference_model(config, dev, ref.p,
                                    judge.reference_module(config).CONTROL)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    flt = {int(s) for s in args.fault_seeds.split(",") if s}
    factors = [float(f) for f in args.scale_factors.split(",") if f]
    worst, best_ctl, best_flt = {}, {}, {}

    def scaled(factor):
        def hook(module, inputs, out):
            c = out.shape[1] // 2
            return torch.cat([out[:, :c] * factor, out[:, c:]], 1)
        return hook

    def window(pool, seed):
        keep = judge.keeper(sut, pool, mix, seed, 2)
        res = loop.run(sut, pool, mix, seconds=args.seconds, keep=keep)
        return res, keep.close()
    for seed in seeds:
        pool = frames.pool(mix, seed, dev)
        loop.warm(sut, pool, mix)
        t = time.perf_counter()
        res, kept = window(pool, seed)
        row = {"seed": seed, "images": res["images"],
               "window_s": res["seconds"], "program": judge.judge(kept, ref)}
        if seed in ctl:
            row["control"] = judge.judge(judge.control_outputs(
                kept, control), ref)
            for k, v in row["control"].items():
                best_ctl[k] = min(best_ctl.get(k, v), v)
        for f in factors if seed in flt else ():
            hooks = [m.register_forward_hook(scaled(f))
                     for n, m in sut.codec.model.named_children()
                     if n.startswith(("ep_anchor_", "ep_nonanchor_"))]
            try:
                got = judge.judge(window(pool, seed)[1], ref)
            finally:
                for h in hooks:
                    h.remove()
            row[f"scales_x{f:g}"] = got
            low = best_flt.setdefault(f"scales_x{f:g}", {})
            for k, v in got.items():
                low[k] = min(low.get(k, v), v)
        for k, v in row["program"].items():
            worst[k] = max(worst.get(k, v), v)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del pool, kept
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": best_ctl, "fault_min": best_flt,
                      "limits": config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
