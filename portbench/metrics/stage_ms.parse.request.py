"""The codec driver's host work in the request loop's decode: the
streams' parse a request (``parse``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("decompress.parse",))
