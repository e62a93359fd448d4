"""The transforms in the request loop: the decoder's g_s a request
(``synthesize``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("decompress.synthesize",))
