"""A cell of ``BENCHMARK.json`` and the files it names, read without
importing torch or the program, so that ``run.py`` can set a
configuration's switches before either is imported.

A cell names a configuration and a traffic mix; the harness finds each by
its name: ``configs/<config>.json`` (the model, its weights, its settings,
the program's switches under ``env``, the limits of the comparison, the
reference's module under ``reference/``), ``traffic/<mix>.json`` (the
frames, the batch, the loop under ``loops/`` and its parameters), and for
a traced run ``metrics/<metric>.py`` for each per-layer metric that lists
the cell.  A loop names the system under test and the comparison it
drives (``SUT`` and ``JUDGE``, modules of ``portbench/``; the codec's by
default).  Adding a cell, a configuration, a mix, a loop or a metric adds
files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

from portbench.paths import BENCH, ROOT


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None,
              base: str = BENCH) -> tuple:
    """(cell, configuration, mix, end-to-end metrics, per-layer metrics)
    of cell ``name`` of ``bench`` (``BENCHMARK.json``), the files under
    ``base``; the metrics are the entries that apply to the cell."""
    bench = bench or read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = read_json(os.path.join(base, "configs", cell["config"] + ".json"))
    mix = read_json(os.path.join(base, "traffic", cell["traffic"] + ".json"))

    def applies(m):
        return name in m.get("workloads", [name])
    return (cell, config, mix,
            [m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def apply_env(config: dict) -> None:
    """Set the program's switches that the configuration states (``env``:
    {variable: value}); before the program is imported."""
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)


def metric_reader(name: str, base: str = BENCH):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
