"""The harness driven end to end on the CPU at a tiny size: the result
line's keys, the per-layer metrics of a traced run, a cell added by files
alone (a configuration with the program's switches, a mix, a loop naming
its own system under test, metrics), the faults and the control that the
comparison must fail."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import tiny
from portbench import core
from portbench.paths import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CHECKS = ["y_roundtrip", "z_flips", "y_flips", "y_gap", "x_gap",
          "rate_gap"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def _tiny_loaders(monkeypatch):
    for mod, name, value in tiny.patches():
        monkeypatch.setattr(mod, name, value)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(base, cell, loop, **kw):
    return core.run_cell(tiny.args(cell, **kw), time.perf_counter(),
                         device="cpu", bench=tiny.bench({cell: loop}),
                         base=base)


@pytest.mark.parametrize("loop", ["bulk", "request"])
def test_untraced_line(base, loop):
    out = run(base, f"T.{loop}", loop)
    assert list(out) == KEYS
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    want = ["setup_s"] + (["encode_ms_p90", "decode_ms_p90"]
                          if loop == "request" else ["roundtrip_img_s"])
    assert sorted(out["metrics"]) == sorted(want)
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out["checks"]) == CHECKS
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("loop", ["bulk", "request"])
def test_traced_line(base, loop):
    out = run(base, f"T.{loop}", loop, trace=1)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True, out["checks"]
    want = [n for n, _ in tiny.PER_LAYER[loop] if n not in tiny.DEVICE_ONLY]
    assert sorted(out["metrics"]) == sorted(want)
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _break(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.mlicpp import MLICPlusPlus
    decode = MLICPlusPlus.codec_device_pass_v4
    if fault == "state_unchanged":
        def f(self, *a, **k):
            return torch.zeros_like(decode(self, *a, **k))
        monkeypatch.setattr(MLICPlusPlus, "codec_device_pass_v4", f)
    elif fault == "symbol_altered":
        def f(self, *a, **k):
            y = decode(self, *a, **k)
            y[0, 0, 0, 0] += 1.0
            return y
        monkeypatch.setattr(MLICPlusPlus, "codec_device_pass_v4", f)
    elif fault == "pixel_altered":
        synth = MLICPlusPlus.synthesize

        def f(self, y_hat):
            x = synth(self, y_hat)
            x[-1, 5, 7, 1] += 0.5
            return x
        monkeypatch.setattr(MLICPlusPlus, "synthesize", f)
    elif fault == "scales_doubled":
        from mlic_tpu_torch.models.context import EntropyParameters
        params = EntropyParameters.forward

        def f(self, x):
            out = params(self, x)
            c = out.shape[1] // 2
            return torch.cat([2.0 * out[:, :c], out[:, c:]], 1)
        monkeypatch.setattr(EntropyParameters, "forward", f)
    elif fault == "half_batch":
        dec = Codec.decompress

        def f(self, strings, shape, *a, **k):
            n = len(strings[0])
            half = [s[:n // 2] for s in strings]
            out = dec(self, half, shape, *a, **k)
            for key in ("y_hat", "x_hat"):
                t = out[key]
                out[key] = torch.cat([t, t.mean(0, keepdim=True).expand(
                    n - n // 2, *t.shape[1:])])
            return out
        monkeypatch.setattr(Codec, "decompress", f)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "symbol_altered", "pixel_altered",
                                   "scales_doubled"])
def test_broken_path_is_not_correct(base, monkeypatch, fault):
    _break(monkeypatch, fault)
    out = run(base, "T.bulk", "bulk")
    assert out["correct"] is False, out["checks"]
    if fault == "scales_doubled":
        # encoder and decoder agree: only the rate sees it
        failed = [n for n, c in out["checks"].items()
                  if c["value"] > c["limit"]]
        assert failed == ["rate_gap"], out["checks"]


def test_control_is_not_correct():
    """The reference in the control's precision (float8 transforms, TF32
    entropy path) in the program's place fails the comparison at the
    tiny cell's limits, on three seeds."""
    from portbench import frames, judge
    cfg = tiny.CONFIG
    ref = judge.reference_model(cfg, torch.device("cpu"))
    control = judge.reference_model(cfg, torch.device("cpu"), ref.p,
                                    judge.reference_module(cfg).CONTROL)
    for seed in (1, 2, 3):
        x = frames.pool(tiny.mix("bulk"), seed, "cpu")[0]
        numbers = judge.judge(judge.control_outputs([{"frames": x}],
                                                    control), ref)
        correct, checks = judge.verdict(numbers, cfg["limits"])
        assert correct is False, checks


NEW_FILES = {
    # a metric
    "metrics/images_traced.py":
        '"""Images in the traced stretch."""\n\n\n'
        'def read(obs):\n'
        '    return float(obs["batches"] * obs["mix"]["batch"])\n',
    "metrics/switch_seen.py":
        '"""1 where the configuration\'s switch reached the program."""\n'
        'import os\n\n\n'
        'def read(obs):\n'
        '    return 1.0 if os.environ.get("PORTBENCH_TINY_SWITCH") == "on"'
        ' else None\n',
    # a loop that names its own system under test
    "loops/bulk_switched.py":
        '"""The bulk loop over ``sut_switched``."""\n'
        'from portbench.loops.bulk import run, warm  # noqa: F401\n\n'
        'SUT = "sut_switched"\n',
    "sut_switched.py":
        '"""The codec, made only where the switch is set."""\n'
        'import os\n\n'
        'from portbench import codec_sut\n\n\n'
        'def make(cfg, device, seed):\n'
        '    assert os.environ["PORTBENCH_TINY_SWITCH"] == "on"\n'
        '    return codec_sut.make(cfg, device, seed)\n',
}


def test_new_cell_from_files_alone(tmp_path):
    """A configuration that sets a switch of the program, a mix whose loop
    names its own system under test, and per-layer metrics, dropped into a
    copy of the folder as new files, make a new cell that runs: the
    harness finds each by its name and no existing file changes."""
    base = tiny.make_base(str(tmp_path))
    before = {}
    for d, _, names in os.walk(base):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                before[p] = f.read()
    for rel, text in NEW_FILES.items():
        with open(os.path.join(base, rel), "w") as f:
            f.write(text)
    with open(os.path.join(base, "configs", "tiny_switched.json"), "w") as f:
        json.dump(dict(tiny.CONFIG, env={"PORTBENCH_TINY_SWITCH": "on"}), f)
    with open(os.path.join(base, "traffic", "tiny_switched.json"), "w") as f:
        json.dump(dict(tiny.mix("bulk"), loop="bulk_switched"), f)
    bench = tiny.bench({"T.new": "bulk"})
    bench["workloads"][0].update(config="tiny_switched",
                                 traffic="tiny_switched")
    for name in ("images_traced", "switch_seen"):
        bench["per_layer"].append({
            "name": name, "unit": "img", "better": "higher",
            "source": "host_clock", "layer": "test",
            "moves": "roundtrip_img_s"})
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code = ("import json, sys, time; sys.argv[1:] = []\n"
            "from portbench import cells, paths\n"
            "bench = json.load(open(paths.ROOT + '/BENCHMARK.json'))\n"
            "cells.apply_env(cells.load_cell('T.new', bench)[1])\n"
            "import tiny\n"
            "from portbench import core\n"
            "tiny.install()\n"
            "out = core.run_cell(tiny.args('T.new', trace=1), "
            "time.perf_counter(), device='cpu', bench=bench)\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), ROOT, os.path.dirname(__file__)]),
        OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["images_traced"]["value"] == 6.0
    assert out["metrics"]["switch_seen"]["value"] == 1.0
    for p, data in before.items():
        with open(p, "rb") as f:
            assert f.read() == data, p


@pytest.mark.card
def test_cell_runs_on_the_card():
    """One short run of the request cell through ``run.py`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "S.request64", "--seed", "2147483659", "--seconds",
         "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_refuses_without_a_card():
    """Without CUDA, ``run.py`` exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "S.bulk128", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
