"""Stage times of the traced run's staged batches, for the per-layer
metrics that read them."""

from __future__ import annotations

import statistics


def median_ms(obs: dict, keys: tuple):
    """The median over the staged batches of the sum of stages ``keys``
    (``"compress.analyze"``, ...), in ms; None where a stage is missing."""
    st = obs["stages"]
    if not all(k in st for k in keys):
        return None
    return statistics.median(sum(v) for v in zip(*(st[k] for k in keys)))
