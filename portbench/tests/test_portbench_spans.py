"""The readers of the program's spans (``program_spans.py``, the metrics
``loop_ms.*``, ``issue_share*``, ``setup_s.*``) on records made by hand
with known answers, the idle gaps labelled by the innermost span however
many spans began after it, a traced tiny cell reporting the set-up spans,
and on the card the shared clock: a request's K4 launches begin inside
its ``decode.entropy_decode``."""

from __future__ import annotations

import importlib
import json
import os
import time

import pytest
import torch

import tiny
from mlic_tpu_torch.spans import Span
from portbench import core, program_spans, spans_report
from portbench.paths import BENCH, ROOT
from portbench.trace import Trace

NEW = ("loop_ms.analyze", "loop_ms.encode_pass", "loop_ms.rans_encode",
       "loop_ms.entropy_decode", "loop_ms.synthesize", "issue_share",
       "setup_s.kernels", "setup_s.update", "setup_s.first_call")


def _span(name, call, start_ms, ms, device_ms=None):
    s = Span(name, call, int(start_ms * 1e6), int((start_ms + ms) * 1e6))
    s.device_ms = device_ms
    return s


def _batch(call, host, device, waits=()):
    """A batch's spans: calls of ``host`` ms each (compress_begin,
    compress_end, decompress), stages of ``device`` ms each (analyze,
    encode_pass, rans_encode, entropy_decode, synthesize), and ``waits``
    as (name, ms)."""
    t = 1000.0 * call
    out = [_span(n, call, t, h) for n, h in zip(
        ("call.compress_begin", "call.compress_end", "call.decompress"),
        host)]
    out += [_span(n, call, t, 1.0, d) for n, d in zip(
        program_spans.STAGES["encode"] + program_spans.STAGES["decode"],
        device)]
    out += [_span(n, call, t, ms) for n, ms in waits]
    return out


def _made():
    return (_batch(0, (10, 5, 20), (30, 40, 10, 50, 20),
                   (("encode.wait", 3),))
            + _batch(1, (10, 5, 20), (30, 40, 10, 50, 20),
                     (("encode.wait", 3), ("decode.wait", 5)))
            + _batch(2, (10, 5, 20), (60, 80, 20, 100, 40),
                     (("encode.wait", 3), ("stream.wait", 9)))
            + _batch(3, (10, 5, 20), (30, 40, 10, 50, 20))[:-1])


def test_stage_ms_is_the_median_of_the_stage_events():
    recs = _made()
    assert program_spans.stage_ms(recs, "encode.analyze") == 30.0
    assert program_spans.stage_ms(recs, "decode.entropy_decode") == 50.0
    assert program_spans.stage_ms(recs, "encode.assemble") is None
    assert program_spans.stage_ms(None, "encode.analyze") is None


def test_issue_share_leaves_out_the_waits():
    """Host 10 + 5 + 20 ms less the waits inside the calls (stream.wait
    is outside them), over the five stages: batch 0 32/150, batch 1
    27/150, batch 2 32/300; batch 3 lacks a stage."""
    recs = _made()
    both = program_spans.issue_share(recs, ("encode", "decode"))
    assert both == pytest.approx(100 * 27 / 150)
    enc = program_spans.issue_share(recs, ("encode",))
    assert enc == pytest.approx(100 * 12 / 80)       # 12/80, 12/80, 12/160
    dec = program_spans.issue_share(recs, ("decode",))
    assert dec == pytest.approx(100 * 15 / 70)       # 20/70, 15/70, 20/140
    no_waits = [s for s in recs if not s.name.endswith(".wait")]
    assert program_spans.issue_share(no_waits, ("encode",)) == \
        pytest.approx(100 * 15 / 80)
    assert program_spans.issue_share([], ("decode",)) is None
    for s in recs:
        s.device_ms = None
    assert program_spans.issue_share(recs, ("decode",)) is None


def test_setup_seconds_sum_by_name():
    """The cell's set-up: entries that ended before the stretch (at 100),
    of the codec whose calls it recorded (7), and the last build; another
    codec's entries and a later update are left out."""
    recs = [Span("call.decompress", 0, 200, 300, codec=7),
            _span("decode.parse", 0, 0, 1)]
    recs[1].parent = recs[0]
    entries = [("setup.kernels", 9.0, 5, None),
               ("setup.update", 0.5, 6, 3), ("setup.first_call", 2.0, 8, 3),
               ("setup.kernels", 1.5, 10, None),
               ("setup.update", 0.04, 20, 7),
               ("setup.first_call", 0.5, 30, 7),
               ("setup.first_call", 0.25, 40, 7),
               ("setup.update", 0.03, 150, 7)]

    def got(name, upto=len(entries)):
        return program_spans.cell_setup(entries[:upto], recs, 100, name)
    assert got("setup.first_call") == 0.75
    assert got("setup.kernels") == 1.5
    assert got("setup.update") == 0.04
    assert got("setup.update", 4) is None
    assert program_spans.cell_setup(entries, None, 100,
                                    "setup.update") is None


def _trace(spans, busy, t1):
    """A ``Trace`` of device work ``busy`` [(start, end)] and host spans
    ``spans`` [(name, start, end)] over [0, t1] ns."""
    tr = Trace.__new__(Trace)
    tr.device_ops = [("k", s, e) for s, e in busy]
    tr.spans = sorted(spans, key=lambda t: t[1])
    tr.t0, tr.t1, tr.window_s = 0, t1, t1 / 1e9
    return tr


def test_idle_is_named_by_the_innermost_open_span_past_64_spans():
    """A decode whose slice loop holds 100 steps: the idle time after the
    last step lies in ``decode.entropy_decode``, which began 101 spans
    before it (the benchmark's own ``Trace.idle_gaps`` looks back 64 spans
    and finds none open); a gap that outlasts that stage is split with
    ``decompress``; the gap in the wait is ``decode.wait``."""
    recs = [_span("decode.entropy_decode", 0, 0.010, 0.890)]
    recs += [_span(f"decode.slice{i}.anchor", 0, 0.010 + 0.008 * i, 0.005)
             for i in range(100)]
    recs.append(_span("decode.wait", 0, 0.950, 0.040))
    busy = [(0, 809_000), (810_000, 895_000), (905_000, 955_000),
            (960_000, 1_000_000)]
    tr = _trace([("decompress", 0, 1_000_000)], busy, 1_000_000)
    pieces = program_spans.idle_pieces(tr, recs)
    assert [(lb, c) for lb, c, _ in pieces] == [
        ("decode.entropy_decode", "decompress"),
        ("decode.entropy_decode", "decompress"),
        ("decompress", "decompress"), ("decode.wait", "decompress")]
    assert [sec for _, _, sec in pieces] == pytest.approx(
        [1e-6, 5e-6, 5e-6, 5e-6])
    assert program_spans.idle_gaps(tr, None) == [
        ["decompress", pytest.approx(16e-6)]]
    assert dict(program_spans.idle_gaps(tr, recs)) == {
        "decode.entropy_decode": pytest.approx(6e-6),
        "decompress": pytest.approx(5e-6),
        "decode.wait": pytest.approx(5e-6)}
    both = _trace(tr.spans + [(s.name, s.start_ns, s.end_ns) for s in recs],
                  busy, 1_000_000)
    assert dict(both.idle_gaps())["between calls"] == pytest.approx(11e-6)
    shares = spans_report.named_share(tr, recs)
    assert shares["decompress"] == pytest.approx(100.0 * 11 / 16)
    assert shares["compress"] is None


def test_readers_find_nothing_without_the_program_spans(monkeypatch):
    """A program without ``mlic_tpu_torch.spans`` (the parent of the
    change that added it): every new reader returns None."""
    monkeypatch.setattr(program_spans, "_spans_module", lambda: None)
    obs = {"trace": _trace([], [], 10)}
    for name in NEW:
        mod = importlib.util.spec_from_file_location(
            "m", os.path.join(BENCH, "metrics", name + ".py"))
        m = importlib.util.module_from_spec(mod)
        mod.loader.exec_module(m)
        assert m.read(obs) is None, name


@pytest.fixture
def _tiny_loaders(monkeypatch):
    for mod, name, value in tiny.patches():
        monkeypatch.setattr(mod, name, value)


@pytest.fixture
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("_tiny_loaders", "_two_torch_threads")
def test_traced_tiny_cell_reports_the_set_up_spans(tmp_path):
    """The tiny request cell traced with the new metrics listed: the
    set-up spans are read; the device times are not, on the CPU; the
    profiled stretch recorded the program's spans and the unprofiled one
    did not."""
    from mlic_tpu_torch import spans
    base = tiny.make_base(str(tmp_path))
    bench = tiny.bench({"T.request": "request"})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        ours = [m for m in json.load(f)["per_layer"]
                if m["name"] in NEW or m["name"].startswith(
                    ("loop_ms.", "issue_share."))]
    for m in ours:
        bench["per_layer"].append(dict(m, workloads=["T.request"]))
    n = len(spans.PROFILED)
    out = core.run_cell(tiny.args("T.request", trace=1),
                        time.perf_counter(), device="cpu", bench=bench,
                        base=base)
    assert out["correct"] is True, out["checks"]
    got = {k for k in out["metrics"] if k in {m["name"] for m in ours}}
    assert got == {"setup_s.update", "setup_s.first_call"}
    assert all(out["metrics"][k]["value"] > 0 for k in got)
    recorded = list(spans.PROFILED)[n:]
    calls = {s.call for s in recorded if s.name == "call.decompress"}
    assert len(calls) == tiny.mix("request")["trace_batches"]


@pytest.mark.card
def test_decode_launches_begin_inside_their_span():
    """The shared clock on the card: in a profiled stretch of
    ``S.request64``, each request's K4 launches (1 + 2 x slice_num)
    begin after its ``decode.entropy_decode`` span starts and before the
    next request's does, and the stages have device times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from portbench import cells, codec_sut, frames
    from portbench.loops import request
    cell, config, mix, _, _ = cells.load_cell("S.request64")
    device = torch.device("cuda")
    torch.set_grad_enabled(False)
    sut = codec_sut.make(config, device, 5)
    pool = frames.pool(dict(mix, pool_batches=2), 5, device)
    request.run(sut, pool, mix, batches=1)
    sut.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        res = request.run(sut, pool, mix, batches=3)
        w1 = time.time_ns()
    tr = Trace(prof, [], w0, w1, res["seconds"])
    recs = program_spans.records({"trace": tr})
    starts = sorted(s.start_ns for s in recs
                    if s.name == "decode.entropy_decode")
    k4 = [s for n, s, _ in tr.device_ops if "rans_decode_kernel" in n]
    assert len(starts) == 3
    per = [0] * 3
    for t in k4:
        assert t >= starts[0]
        per[max(i for i, s in enumerate(starts) if s <= t)] += 1
    assert per == [1 + 2 * config["model"]["slice_num"]] * 3
    for name in program_spans.STAGES["encode"] + program_spans.STAGES[
            "decode"]:
        assert program_spans.stage_ms(recs, name) > 0, name
