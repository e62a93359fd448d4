"""The reduction of a ``torch.profiler`` trace of the device's activity to
what the per-layer metrics read: the device's work as intervals, its busy
seconds (the union of every kernel, copy and fill), the time by device
operation, and the idle gaps labelled by the codec call the host was in
when each gap began (the benchmark's own host spans, in the profiler's
clock, ``time.time_ns``)."""

from __future__ import annotations

import bisect
from collections import defaultdict


def _ns(e, what: str) -> int:
    fn = getattr(e, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, what + "_us")() * 1000)


class Trace:
    """The device operations [(name, start_ns, end_ns)] of one profiled
    stretch, its host spans [(name, start_ns, end_ns)], its bounds in the
    profiler's clock and its wall-clock seconds."""

    def __init__(self, prof, spans: list, w0: int, w1: int,
                 window_s: float):
        from torch.autograd import DeviceType
        self.device_ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue
            start = _ns(e, "start")
            self.device_ops.append((e.name(), start,
                                    start + _ns(e, "duration")))
        self.device_ops.sort(key=lambda t: t[1])
        self.spans = sorted((s for s in spans if s[2] > w0 and s[1] < w1),
                            key=lambda t: t[1])
        self.t0, self.t1, self.window_s = w0, w1, window_s

    def busy(self) -> list:
        """The union of the device's work, as sorted disjoint intervals."""
        out = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def calls(self, name: str) -> list:
        """The host spans of codec call ``name`` as sorted disjoint
        intervals."""
        out = []
        for n, s, e in self.spans:
            if n != name:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def ops_s(self, match: str, within: str | None = None) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        ``match``; with ``within``, only those that began inside a span of
        that codec call (a call that ends in a synchronize holds its own
        device work)."""
        sel = [(s, e) for n, s, e in self.device_ops if match in n]
        if within is not None:
            calls = self.calls(within)
            starts = [c[0] for c in calls]

            def inside(t):
                k = bisect.bisect_right(starts, t) - 1
                return k >= 0 and t < calls[k][1]
            sel = [(s, e) for s, e in sel if inside(s)]
        return sum(e - s for s, e in sel) / 1e9, len(sel)

    def idle_within(self, name: str):
        """The device's idle share (%) of the time the host spent inside
        codec call ``name``; None where the stretch holds no such call."""
        calls = self.calls(name)
        total = sum(e - s for s, e in calls)
        if not total:
            return None
        busy, k = 0, 0
        for s, e in self.busy():
            while k < len(calls) and calls[k][1] <= s:
                k += 1
            j = k
            while j < len(calls) and calls[j][0] < e:
                busy += max(0, min(e, calls[j][1]) - max(s, calls[j][0]))
                j += 1
        return 100.0 * (1.0 - busy / total)

    def top_ops(self, n: int = 10) -> list:
        acc = defaultdict(int)
        for name, s, e in self.device_ops:
            acc[name[:160]] += e - s
        return [[k, v / 1e9] for k, v in sorted(
            acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time inside the stretch by the innermost codec call
        open when each gap began ("between calls" where none was),
        largest first."""
        starts = [s for _, s, _ in self.spans]
        acc = defaultdict(int)
        edges = [self.t0]
        for s, e in self.busy():
            edges += [min(max(s, self.t0), self.t1),
                      min(max(e, self.t0), self.t1)]
        edges.append(self.t1)
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            label, best = "between calls", None
            k = bisect.bisect_right(starts, g0)
            for name, s, e in self.spans[max(0, k - 64):k]:
                if s <= g0 < e and (best is None or s >= best):
                    label, best = name, s
            acc[label] += g1 - g0
        return [[k, v / 1e9] for k, v in sorted(
            acc.items(), key=lambda kv: -kv[1])[:n]]
