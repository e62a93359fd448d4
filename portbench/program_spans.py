"""The program's own spans (``mlic_tpu_torch.spans``) in a traced run, for
the per-layer metrics that read them.

The codec records its spans while ``torch.profiler`` runs, so the traced
stretch records them and the unprofiled and serial stretches do not: the
profiled stretch's own metrics (``device_idle*``, ``*_roofline*``, the
breakdown) are read with the recorder on.  Its stage spans carry CUDA
events, read once the stretch is over (by the codec's first call after
it, or here).  A program without ``mlic_tpu_torch.spans`` records none:
every reading is then None.

``idle_gaps`` gives the device's idle time inside the stretch by the
innermost span open while it lasted, the benchmark's call spans and the
program's together."""

from __future__ import annotations

import statistics
from collections import defaultdict

# the stages that queue a direction's device work, and its calls
STAGES = {"encode": ("encode.analyze", "encode.encode_pass",
                     "encode.rans_encode"),
          "decode": ("decode.entropy_decode", "decode.synthesize")}
CALLS = {"encode": ("call.compress_begin", "call.compress_end"),
         "decode": ("call.decompress",)}
WAITS = {"encode": ("encode.wait",), "decode": ("decode.wait",)}


def _spans_module():
    try:
        from mlic_tpu_torch import spans
    except ImportError:
        return None
    return spans


def records(obs) -> list | None:
    """The program's spans of the traced stretch, device times resolved;
    None where it recorded none."""
    spans = _spans_module()
    if spans is None:
        return None
    t = obs["trace"]
    out = [s for s in list(spans.PROFILED)
           if s.start_ns >= t.t0 and s.end_ns <= t.t1]
    return spans.resolve(out) or None


def stage_ms(recs, name: str):
    """The median over the stretch's calls of stage ``name``'s device ms
    (between its two events); None where no such stage has device time."""
    vals = [s.device_ms for s in recs or () if s.name == name
            and s.device_ms is not None]
    return statistics.median(vals) if vals else None


def issue_share(recs, directions: tuple):
    """The median over the stretch's batches of the host's ms inside the
    codec's calls of ``directions`` less their waits, over the device ms
    of the batch's stages in those directions, in %.  The host's ms
    include the time a launch is blocked by a full CUDA launch queue, so
    this is the host's time in the calls, not its free issue time.
    Batches missing a stage or a call are left out; None where none is
    whole."""
    calls = [c for d in directions for c in CALLS[d]]
    stages = [s for d in directions for s in STAGES[d]]
    waits = {w for d in directions for w in WAITS[d]}
    by = defaultdict(lambda: defaultdict(list))
    for s in recs or ():
        by[s.call][s.name].append(s)
    out = []
    for got in by.values():
        if not all(got.get(n) for n in calls + stages) or any(
                s.device_ms is None for n in stages for s in got[n]):
            continue
        host = (sum(s.ms for n in calls for s in got[n])
                - sum(s.ms for n in waits for s in got.get(n, ())))
        device = sum(s.device_ms for n in stages for s in got[n])
        if device > 0:
            out.append(100.0 * host / device)
    return statistics.median(out) if out else None


def setup_s(obs, name: str):
    """The seconds of the traced cell's set-up span ``name``
    (``cell_setup`` over ``mlic_tpu_torch.spans.SETUP``); None where
    there is none."""
    spans = _spans_module()
    if spans is None:
        return None
    return cell_setup(list(spans.SETUP), records(obs), obs["trace"].t0,
                      name)


def cell_setup(entries, recs, t0: int, name: str):
    """The seconds of set-up span ``name`` among ``entries`` (name,
    seconds, end_ns, codec) that ended before the traced stretch began at
    ``t0``: of ``setup.kernels`` the last (a cell builds once, before it
    makes its codec), of the others the sum over the codecs whose calls
    ``recs`` holds.  None where there is none."""
    codecs = {s.codec for s in recs or () if s.parent is None}
    vals = [sec for n, sec, end, codec in entries
            if n == name and end < t0
            and (codec is None if name == "setup.kernels"
                 else codec in codecs)]
    if not vals:
        return None
    return vals[-1] if name == "setup.kernels" else sum(vals)


def idle_pieces(trace, recs) -> list:
    """The device's idle time inside ``trace``'s stretch, cut where the
    innermost open span changes: [(label, call, seconds)], ``label`` the
    innermost span open then among the benchmark's host spans and the
    program's ``recs``, ``call`` the innermost of the benchmark's own
    ("between calls" where none is open).  So an idle gap that outlasts
    the span it began in is split among the spans the host went through
    while the device waited."""
    between = "between calls"
    events = []
    for own, spans in ((True, trace.spans),
                       (False, [(s.name, s.start_ns, s.end_ns)
                                for s in recs or ()])):
        for name, s, e in spans:
            span = (name, s, e, own)
            events += [(s, 1, -e, span), (e, 0, -s, span)]
    events.sort(key=lambda ev: ev[:3])
    segs, stack, t = [], [], trace.t0
    for when, starts, _, span in events:
        if when > t:
            inner = stack[-1][0] if stack else between
            call = next((sp[0] for sp in reversed(stack) if sp[3]), between)
            segs.append((t, when, inner, call))
            t = when
        if starts:
            stack.append(span)
        else:
            stack.remove(span)
    segs.append((t, max(t, trace.t1), between, between))
    out, k = [], 0
    busy = trace.busy()
    edges = [trace.t0]
    for s, e in busy:
        edges += [min(max(s, trace.t0), trace.t1),
                  min(max(e, trace.t0), trace.t1)]
    edges.append(trace.t1)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            a, b = max(g0, segs[j][0]), min(g1, segs[j][1])
            if b > a:
                out.append((segs[j][2], segs[j][3], (b - a) / 1e9))
            j += 1
    return out


def idle_gaps(trace, recs, n: int | None = None) -> list:
    """The idle time of ``idle_pieces`` by span, largest first:
    [[label, seconds], ...]."""
    acc = defaultdict(float)
    for label, _, sec in idle_pieces(trace, recs):
        acc[label] += sec
    out = [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])]
    return out if n is None else out[:n]
