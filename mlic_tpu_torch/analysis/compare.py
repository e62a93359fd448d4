"""Compare per-image bpp distributions (port of
``mlic_tpu/analysis/compare.py``; reference
``analysis/compare_bpp_distr.py``): read two or more per-image CSVs of
``mlic_tpu_torch.tools.statistics`` (columns name, bpp, psnr, ms_ssim) and
report each file's distribution and the pairwise per-image deltas."""

from __future__ import annotations

import csv
from typing import Sequence

import numpy as np


def load_stats_csv(path: str) -> dict[str, dict[str, float]]:
    """CSV with a header (name, bpp, ...) -> {name: {column: value}}."""
    out: dict[str, dict[str, float]] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            name = row.pop("name")
            out[name] = {k: float(v) for k, v in row.items()
                         if v not in ("", None)}
    return out


def summarize(values: np.ndarray) -> dict:
    return {
        "mean": float(values.mean()), "std": float(values.std()),
        "min": float(values.min()), "p50": float(np.median(values)),
        "p90": float(np.percentile(values, 90)), "max": float(values.max()),
    }


def compare_bpp(paths: Sequence[str], column: str = "bpp") -> dict:
    """Distribution summary per file, and per pair of files the summary of
    the per-image deltas over the images both name."""
    stats = {p: load_stats_csv(p) for p in paths}
    result = {"summaries": {}, "deltas": {}}
    for p, rows in stats.items():
        result["summaries"][p] = summarize(
            np.asarray([r[column] for r in rows.values()]))
    names = (set.intersection(*(set(s) for s in stats.values())) if stats
             else set())
    paths = list(paths)
    for i in range(len(paths)):
        for j in range(i + 1, len(paths)):
            a, b = stats[paths[i]], stats[paths[j]]
            delta = np.asarray([a[n][column] - b[n][column]
                                for n in sorted(names)])
            result["deltas"][(paths[i], paths[j])] = (summarize(delta)
                                                      if len(delta) else {})
    return result
