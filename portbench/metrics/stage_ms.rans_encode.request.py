"""The rANS coder in the request loop: the encode's K7, K3 and K6 and the
copy of the streams to host memory a request (``rans_encode``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("compress.rans_encode",))
