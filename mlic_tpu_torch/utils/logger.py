"""Logging: named timestamped loggers and a JSONL metrics writer (port of
``mlic_tpu/utils/logger.py``; reference ``MLIC++/utils/logger.py:9-23``
and the scalars of ``utils/training.py:88-97``).

The metrics go to ``metrics.jsonl`` only.  The JAX package also writes
TensorBoard event files where ``torch.utils.tensorboard`` imports; the
port does not, because that import loads TensorFlow where it is installed
(seconds per process) and the JSONL file already holds every scalar."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def setup_logger(name: str, log_dir: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%y%m%d-%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}_{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Scalar metrics sink: one JSON object a line in
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            rec[f"{prefix}{k}"] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
