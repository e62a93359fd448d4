"""The codec's spans (``mlic_tpu_torch.spans``) on the CPU, MLICPP_TINY at
batch 2 of 64x64 with the port's own initial weights: off by default and
then free (no event, no span clock, nothing recorded, the same streams),
and on, one span per stage, step and call, each inside its call and
carrying its batch's identifier; ``timings`` keeps its stages."""

import types

import pytest
import torch

from mlic_tpu_torch import spans
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.models.registry import get_model

SLICES = 2          # MLICPP_TINY's slice_num
# the spans a format-v4 codec records, as PERF.md lists them; the CPU
# records all but the CUDA waits (``encode.wait``, ``stream.wait``)
NAMES = ({"call.compress_begin", "call.compress_end", "call.decompress",
          "stream.wait", "encode.analyze", "encode.encode_pass",
          "encode.rans_encode", "encode.wait", "encode.assemble",
          "encode.fetch", "encode.synthesize", "decode.parse",
          "decode.entropy_decode", "decode.z", "decode.synthesize",
          "decode.wait"}
         | {f"{d}.slice{k}.{p}" for d in ("encode", "decode")
            for k in range(SLICES) for p in ("anchor", "nonanchor")})
CUDA_ONLY = {"encode.wait", "stream.wait"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread, as the other codec tests run under six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coded():
    torch.manual_seed(0)
    model = get_model("MLICPP_TINY")
    codec = Codec(model, n_lanes=16, device="cpu")
    n_setup = len(spans.SETUP)
    codec.update()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    return {"codec": codec, "x": x, "enc": enc, "dec": dec,
            "setup": list(spans.SETUP)[n_setup:]}


def _by_call(recorded) -> dict:
    out = {}
    for s in recorded:
        out.setdefault(s.call, []).append(s)
    return out


def test_off_records_nothing_and_codes_the_same(coded, monkeypatch):
    """Off (no profiler): no CUDA event is made, the spans' clock
    is never read, ``PROFILED`` does not grow; on, the streams and y_hat
    are the same bit for bit."""
    codec, x = coded["codec"], coded["x"]

    def forbidden(*a, **k):
        raise AssertionError("called while recording is off")
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        time_ns=forbidden))
    n = len(spans.PROFILED)
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert len(spans.PROFILED) == n
    monkeypatch.undo()
    monkeypatch.setattr(spans, "profiling", lambda: True)
    enc_on = codec.compress(x)
    dec_on = codec.decompress(enc_on["strings"], enc_on["shape"])
    assert len(spans.PROFILED) > n
    assert enc_on["strings"] == enc["strings"] == coded["enc"]["strings"]
    assert torch.equal(dec_on["y_hat"], dec["y_hat"])
    assert torch.equal(dec_on["y_hat"], enc["y_hat"])


def _recorded(monkeypatch, run) -> list:
    """The spans ``run()`` records while the profiler seems to run."""
    n = len(spans.PROFILED)
    monkeypatch.setattr(spans, "profiling", lambda: True)
    run()
    monkeypatch.undo()
    return list(spans.PROFILED)[n:]


def test_spans_nest_in_their_calls_and_carry_the_batch(coded, monkeypatch):
    """Through ``roundtrip_stream``: each batch's encode and decode spans
    share one identifier, every span lies inside its call span and hangs
    from it, each direction has 2 x slice_num slice spans a batch, and the
    names are the listed set."""
    codec, x = coded["codec"], coded["x"]
    out = []
    got = _recorded(monkeypatch, lambda: out.extend(
        codec.roundtrip_stream([x, x.flip(1)])))
    assert len(out) == 2
    calls = _by_call(got)
    assert len(calls) == 2
    for recorded in calls.values():
        roots = {s.name: s for s in recorded if s.parent is None}
        assert set(roots) == {"call.compress_begin", "call.compress_end",
                              "call.decompress"}
        for s in recorded:
            if s.parent is None:
                continue
            root = s.parent
            while root.parent is not None:
                root = root.parent
            assert root.call == s.call
            assert root.start_ns <= s.parent.start_ns <= s.start_ns
            assert s.end_ns <= s.parent.end_ns <= root.end_ns
            assert (root.name == "call.decompress") == \
                s.name.startswith("decode.")
        for d, stage in (("encode", "encode.encode_pass"),
                         ("decode", "decode.entropy_decode")):
            sl = [s for s in recorded if s.name.startswith(f"{d}.slice")]
            assert len(sl) == 2 * SLICES
            assert all(s.parent.name == stage for s in sl)
    names = {s.name for s in got}
    assert names <= NAMES
    assert NAMES - CUDA_ONLY - {"encode.fetch", "decode.wait"} <= names


def test_timings_keep_their_stages_with_spans_on(coded, monkeypatch):
    codec, x = coded["codec"], coded["x"]
    t_enc, t_dec = {}, {}

    def run():
        enc = codec.compress(x, timings=t_enc)
        codec.decompress(enc["strings"], enc["shape"], timings=t_dec)
    got = _recorded(monkeypatch, run)
    assert list(t_enc) == ["analyze", "encode_pass", "rans_encode", "assemble",
                           "synthesize"]
    assert list(t_dec) == ["parse", "entropy_decode", "synthesize"]
    stages = [s.name.split(".", 1)[1] for s in got
              if s.parent is not None and s.parent.parent is None
              and not s.name.endswith(".wait")]
    assert stages == list(t_enc) + list(t_dec)


def test_profiler_turns_recording_on(coded, monkeypatch):
    """A call made while the profiler runs records into
    ``spans.PROFILED`` (the profiler itself in ``portbench/tests``, whose
    start takes seconds on the CPU), its call span carrying the codec's
    serial, unless ``follow_profiler(False)`` switched that off."""
    codec = coded["codec"]
    n = len(spans.PROFILED)
    assert not spans.profiling()
    assert codec._recorder("call.decompress", 8, "decode.") is None
    monkeypatch.setattr(spans, "profiling", lambda: True)
    rec = codec._recorder("call.decompress", 7, "decode.")
    rec.stage("parse")
    rec.end()
    got = list(spans.PROFILED)[n:]
    assert [(s.name, s.call) for s in got] == [("call.decompress", 7),
                                               ("decode.parse", 7)]
    assert got[0].codec == codec._serial
    spans.follow_profiler(False)
    try:
        assert codec._recorder("call.decompress", 9, "decode.") is None
    finally:
        spans.follow_profiler(True)


class _Event:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        assert self.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_a_profiled_stretch_leaves_no_event(monkeypatch):
    """The first call after a profiled stretch reads the events the device
    has passed and drops the others."""
    done, pending = spans.Span("a", 0, 0, 1), spans.Span("b", 0, 1, 2)
    done.events = (_Event(1.0), _Event(3.5))
    pending.events = (_Event(3.5), _Event(9.0, done=False))
    monkeypatch.setattr(spans, "_unsettled", [done, pending])
    assert spans.recorder("call.decompress", 0, "decode.",
                          torch.device("cpu"), 0) is None
    assert (done.device_ms, done.events) == (2.5, None)
    assert (pending.device_ms, pending.events) == (None, None)
    assert spans._unsettled == []


def test_setup_spans(coded):
    """``update`` and the codec's first three calls are set-up spans of
    the codec, stamped with the time they ended."""
    names = [n for n, _, _, _ in coded["setup"]]
    assert names.count("setup.update") == 1
    assert names.count("setup.first_call") == 3
    assert all(sec > 0 and end > 0 and codec == coded["codec"]._serial
               for _, sec, end, codec in coded["setup"])
