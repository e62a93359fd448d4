"""The entropy model in the request loop: the decoder's z decode, h_s
and slice loop with K4's phases a request (``entropy_decode``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("decompress.entropy_decode",))
