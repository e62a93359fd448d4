"""Spans of the codec's work: where a call's host time goes, and for each
stage of a call the device time between two CUDA events.

A span is a named interval of the host's clock, ``time.time_ns``: the
clock that ``torch.profiler`` stamps its device events with, so a span
says what the host was doing while the device ran or idled.  Every span
of one codec call carries the call's identifier (``Codec``'s count of
calls in that direction: a batch's encode and decode share one) and its
parent, the innermost span of the call that holds it.  A call's spans
are, by name (``<direction>.<what>``):

* the call itself: ``call.compress_begin``, ``call.compress_end``,
  ``call.decompress``, and ``stream.wait`` (``roundtrip_stream``'s wait
  for a batch it hands out);
* its stages, the intervals ``Codec(timings=...)`` times: ``encode.
  analyze``, ``.encode_pass``, ``.rans_encode``, ``.assemble``,
  ``.synthesize`` (``encode_recon``), ``.z_encode`` (format v3);
  ``decode.parse``, ``.z_decode`` (v3), ``.entropy_decode``,
  ``.synthesize``.  On a CUDA device each stage has a pair of events
  recorded on the codec's stream at its bounds, and ``device_ms`` once
  ``resolve`` has read them;
* the steps inside stages: ``encode.slice<k>.anchor`` and ``.nonanchor``
  (the model's slice loop, each phase with its contexts and, decoding,
  its K4 launch), ``decode.z`` (the z phase of K4), ``encode.wait`` (for
  the copy of the streams), ``encode.fetch`` (words past the speculative
  download), ``decode.wait`` (for x_hat).

Recording follows ``torch.profiler``: a codec call records its spans
into ``PROFILED`` while the profiler runs in its thread, unless
``follow_profiler(False)`` has switched that off, and otherwise records
nothing: it creates no event, reads no clock and grows no list for it.
Events are read by ``resolve``, after the caller's window; the first
call after a profiled stretch reads those the device has passed and
drops the rest, so a stretch nobody reads leaves no event behind.

``SETUP`` holds the one-off seconds of set-up, recorded whether spans are
on or not, each with the ``time_ns`` it ended and its codec
(``codec_serial``; None for the kernels): ``setup.kernels`` (a
``_build.build``: compiling or finding the kernels' libraries),
``setup.update`` (a ``Codec.update``), ``setup.first_call`` (a device
codec's first ``compress_begin``, ``compress_end`` and ``decompress``,
each).  It and ``PROFILED`` belong to the process, as the kernels'
libraries and a profiler session do.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import torch

PROFILED = deque(maxlen=1 << 16)    # spans recorded while the profiler ran
SETUP = deque(maxlen=1 << 12)       # (name, seconds, end_ns, codec)
_follow = True                      # follow_profiler
_unsettled = deque(maxlen=1 << 16)  # PROFILED's spans whose events wait
_serials = itertools.count()


def profiling() -> bool:
    """Whether ``torch.profiler`` (or the autograd profiler) is running
    in this thread."""
    return torch.autograd._profiler_enabled()


def follow_profiler(on: bool) -> None:
    """Whether codec calls record their spans while ``torch.profiler``
    runs (the default) or never."""
    global _follow
    _follow = on


def codec_serial() -> int:
    """A number of its own for each codec: its calls' spans and its
    set-up entries carry it."""
    return next(_serials)


def setup(name: str, t0: float, codec: int | None = None) -> None:
    """Set-up span ``name`` from ``time.perf_counter()`` ``t0`` to now."""
    SETUP.append((name, time.perf_counter() - t0, time.time_ns(), codec))


def recorder(name: str, call: int, prefix: str, device, codec: int):
    """A ``Recorder`` of codec ``codec``'s call ``name`` while spans are
    recorded, else None (settling a profiled stretch's events first)."""
    if not (_follow and profiling()):
        if _unsettled:
            _settle()
        return None
    return Recorder(name, call, prefix, device, codec)


def _settle() -> None:
    """Read the events the device has passed, drop the rest."""
    for s in _unsettled:
        if s.events is not None and s.events[1].query():
            resolve((s,))
        s.events = None
    _unsettled.clear()


class Span:
    """One span; ``events`` and ``device_ms`` on a stage on CUDA,
    ``codec`` (the codec's serial) on a call's own span."""

    __slots__ = ("name", "call", "parent", "start_ns", "end_ns", "events",
                 "device_ms", "codec")

    def __init__(self, name: str, call: int, start_ns: int,
                 end_ns: int | None = None, events=None, codec=None):
        self.name, self.call, self.codec = name, call, codec
        self.start_ns, self.end_ns = start_ns, end_ns
        self.events, self.parent, self.device_ms = events, None, None

    @property
    def ms(self) -> float:
        """The host's milliseconds in the span."""
        return (self.end_ns - self.start_ns) / 1e6


class Recorder:
    """The spans of one call, put in ``PROFILED`` when it ``end``s.

    ``stage(name)`` closes stage ``name``, which began where the call or
    the stage before it ended; ``step(name)`` closes the open step, if
    any, and opens ``name`` (None opens none)."""

    __slots__ = ("prefix", "root", "stages", "steps", "stream",
                 "mark", "current")

    def __init__(self, name: str, call: int, prefix: str, device,
                 codec: int | None = None):
        self.prefix = prefix
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        now = time.time_ns()
        self.root = Span(name, call, now, codec=codec)
        self.stages, self.steps = [], []
        self.mark = (now, self._event())
        self.current = None

    def _event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def stage(self, name: str) -> None:
        now, ev = time.time_ns(), self._event()
        start, ev0 = self.mark
        self.stages.append(Span(self.prefix + name, self.root.call, start,
                                now, None if ev is None else (ev0, ev)))
        self.mark = (now, ev)

    def step(self, name: str | None = None) -> None:
        now = time.time_ns()
        if self.current is not None:
            self.current.end_ns = now
            self.steps.append(self.current)
        self.current = (None if name is None else
                        Span(self.prefix + name, self.root.call, now))

    def end(self) -> None:
        """Close the call, give each span its parent, hand them over."""
        self.step()
        self.root.end_ns = time.time_ns()
        for st in self.stages:
            st.parent = self.root
        for s in self.steps:
            s.parent = next((st for st in self.stages
                             if st.start_ns <= s.start_ns < st.end_ns),
                            self.root)
        PROFILED.extend([self.root, *self.stages, *self.steps])
        if self.stream is not None:
            _unsettled.extend(self.stages)


def resolve(spans) -> list:
    """Fill ``device_ms`` of every span that has events, once the device
    has passed them (a wait for each span's end event; after the window
    they are long done), and drop the events.  Returns ``spans``."""
    for s in spans:
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return spans
