"""Where a cell's traced stretch spends its time by the program's own spans,
and what recording them costs.

    python3 portbench/spans_report.py --workload S.request64 --seed 7 \\
        --reps 3 --out chiprun_out/spans_S.request64.json

from the root of a checkout, on the card.  Sets the cell up as ``run.py``
does, then runs the traced stretch of a ``--trace 1`` run
(``core.traced``) ``2 * --reps`` times, the codec's recorder on and off in
turns (on, off, off, on, ...; ``spans.follow_profiler``).  For each it
gives the window, the device's busy seconds, the per-layer metrics, the
idle time by the innermost span open while it lasted (the benchmark's
calls and the program's spans: ``program_spans.idle_pieces``), the share
of the idle time inside each of the benchmark's calls that a program
span names, and, with the recorder on, the spans' account of a request:
the device ms of a direction's stages plus its host time outside them
against the mean call on the host clock.  Prints one JSON line (and writes it to
``--out``)."""

import argparse
import importlib
import json
import os
import statistics
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CALLS = ("compress", "compress_begin", "compress_end", "decompress")


def account(trace, recs) -> dict:
    """Mean ms a request of each direction: the spans' account and the
    benchmark's call on the host clock (the request loop only)."""
    from portbench import program_spans as ps
    by = {}
    for s in recs:
        by.setdefault(s.call, {})[s.name] = s
    enc, dec = [], []
    for got in by.values():
        stages = ps.STAGES["encode"] + ps.STAGES["decode"]
        if any(got[n].device_ms is None for n in stages if n in got):
            continue
        if all(n in got for n in ps.STAGES["encode"]) and \
                "call.compress_end" in got:
            end = got["call.compress_end"]
            after = end.end_ns - (got["encode.wait"].end_ns
                                  if "encode.wait" in got else end.start_ns)
            enc.append(sum(got[n].device_ms for n in ps.STAGES["encode"])
                       + after / 1e6)
        if all(n in got for n in ps.STAGES["decode"]) and \
                "decode.parse" in got:
            dec.append(got["decode.parse"].ms + sum(
                got[n].device_ms for n in ps.STAGES["decode"]))

    def host(name):
        c = [(e - s) / 1e6 for n, s, e in trace.spans if n == name]
        return statistics.fmean(c) if c else None
    return {"encode_spans_ms": statistics.fmean(enc) if enc else None,
            "compress_ms": host("compress"),
            "decode_spans_ms": statistics.fmean(dec) if dec else None,
            "decompress_ms": host("decompress")}


def named_share(trace, recs) -> dict:
    """% of the idle time inside each benchmark call that a program span
    names (``program_spans.idle_pieces``); None where there is none."""
    from portbench import program_spans as ps
    tot, named = defaultdict(float), defaultdict(float)
    for label, call, sec in ps.idle_pieces(trace, recs):
        tot[call] += sec
        if label not in CALLS and label != "between calls":
            named[call] += sec
    return {c: 100.0 * named[c] / tot[c] if tot[c] else None for c in CALLS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from portbench import cells
    _, config, mix, _, per_layer = cells.load_cell(args.workload)
    cells.apply_env(config)
    import torch

    from mlic_tpu_torch import spans
    from portbench import core, frames
    from portbench import program_spans as ps
    from portbench import trace as trace_mod
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    device = torch.device("cuda")
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    sut_mod, judge = core.parts(loop)
    sut = sut_mod.make(config, device, args.seed)
    pool = frames.pool(mix, args.seed, device)
    loop.warm(sut, pool, mix)
    sut.sync()
    setup_s = time.perf_counter() - t_start
    traces = []

    class Kept(trace_mod.Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            traces.append(self)
    trace_mod.Trace = Kept
    codec = sut.codec
    wrapped = {a: codec.__dict__[a] for a in CALLS if a in codec.__dict__}
    rows = []
    for i in range(2 * args.reps):
        on = (i % 4) in (0, 3)
        spans.follow_profiler(on)
        _, _, metrics, busy, breakdown = core.traced(
            sut, judge, pool, mix, config, loop, args.seed + i, per_layer)
        spans.follow_profiler(True)
        for a in CALLS:             # undo this stretch's call spans
            codec.__dict__.pop(a, None)
        codec.__dict__.update(wrapped)
        tr = traces.pop()           # keep no stretch's trace past its row
        recs = ps.records({"trace": tr}) or []
        if i == 0:
            setup = {n: ps.setup_s({"trace": tr}, n) for n in (
                "setup.kernels", "setup.update", "setup.first_call")}
        row = {"recorder": on, "busy_s": busy[0], "window_s": busy[1],
               "metrics": {k: v["value"] for k, v in metrics.items()},
               "idle_gaps_by_call": breakdown["idle_gaps"],
               "idle_gaps_by_span": ps.idle_gaps(tr, recs, 16),
               "spans": len(recs)}
        if on:
            row["named_share"] = named_share(tr, recs)
            row["account"] = account(tr, recs)
        rows.append(row)
        print(json.dumps({"workload": args.workload, **row}),
              file=sys.stderr, flush=True)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "power_limit": core.power_limit(), "setup_s": setup_s,
           "setup_spans": setup,
           "rows": rows}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
