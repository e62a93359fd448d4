"""Bjøntegaard-delta metrics of two RD curves (port of ``tools/bdrate.py``):
BD-rate and BD-PSNR from cubic fits, integrated over the overlapping
range.

    python -m mlic_tpu_torch.tools.bdrate --test my_curve.json \\
        --anchor anchor_curve.json

A curve file holds ``{"bpp": [...], "psnr" | "psnr-rgb" | "PSNR": [...]}``,
flat or under ``"results"`` (the reference's results files); the curves of
``tools.rd_curve``, ``tools.rd_vbr`` and ``tools.jpeg_anchor`` are of that
form.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load_curve(path: str):
    with open(path) as f:
        data = json.load(f)
    if "results" in data:
        data = data["results"]
    bpp = np.asarray(data["bpp"], dtype=np.float64)
    for key in ("psnr", "psnr-rgb", "PSNR"):
        if key in data:
            psnr = np.asarray(data[key], dtype=np.float64)
            break
    else:
        raise KeyError(f"no psnr field in {path}: {sorted(data)}")
    order = np.argsort(bpp)
    return bpp[order], psnr[order]


def _bd(xa, ya, xt, yt):
    """Mean of the test fit minus the anchor fit (cubic polynomials of y
    over x) over the overlap of the x ranges."""
    pa = np.polyfit(xa, ya, 3)
    pt = np.polyfit(xt, yt, 3)
    lo = max(xa.min(), xt.min())
    hi = min(xa.max(), xt.max())
    if hi <= lo:
        raise ValueError("no overlap between curves")
    ia, it = np.polyint(pa), np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return avg_t - avg_a


def bd_rate(anchor_bpp, anchor_psnr, test_bpp, test_psnr) -> float:
    """BD-rate in percent (negative: the test needs fewer bits)."""
    d = _bd(anchor_psnr, np.log(anchor_bpp), test_psnr, np.log(test_bpp))
    return float((np.exp(d) - 1.0) * 100.0)


def bd_psnr(anchor_bpp, anchor_psnr, test_bpp, test_psnr) -> float:
    """BD-PSNR in dB (positive: the test is better at equal rate)."""
    return float(_bd(np.log(anchor_bpp), anchor_psnr, np.log(test_bpp),
                     test_psnr))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--test", required=True, help="test RD curve json")
    p.add_argument("--anchor", required=True, help="anchor RD curve json")
    args = p.parse_args(argv)
    ab, ap = _load_curve(args.anchor)
    tb, tp = _load_curve(args.test)
    rate, gain = bd_rate(ab, ap, tb, tp), bd_psnr(ab, ap, tb, tp)
    print(f"BD-rate : {rate:+.2f} %  (negative = better)")
    print(f"BD-PSNR : {gain:+.3f} dB (positive = better)")
    return {"bd_rate": rate, "bd_psnr": gain}


if __name__ == "__main__":
    main()
