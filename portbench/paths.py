"""Where the benchmark and the checkout it runs in lie."""

from __future__ import annotations

import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
