"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload S.bulk128 --seed 12345 \
        --seconds 45 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  The configuration's switches of the program (its ``env``) are set
before torch or the program is imported.  Set-up (kernel builds on a
first run, weights, tables, frames from the seed, a warm-up at the cell's
own shapes) is ``setup_s``; the window
then measures for ``--seconds``; with ``--trace 1`` a stretch of the loop
is profiled instead and the per-layer metrics are reported.  After the
window the plain reference judges a seeded sample of what it coded
(``judge.py``).  Each number compared is printed with its limit as the
last lines on standard error and under ``checks`` in the result.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced).

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when a module of the JAX side (``jax``,
``jaxlib``, ``flax``, ``mlic_tpu``) is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches() -> None:
    """Keep the CUDA driver's cache of code it compiles at load time inside
    the checkout, at a fixed path (it would otherwise go under ``HOME``;
    the program's own kernels build into ``build/kernels``)."""
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "portbench",
                                                 "cuda")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from portbench import cells
    cell, config = cells.load_cell(args.workload)[:2]
    cells.apply_env(config)
    import torch

    from portbench import core
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 2
    out = core.run_cell(args, T_START)
    found = core.forbidden_modules()
    if found:
        print(f"modules of the JAX side are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
