"""The transforms: the encoder's g_a, h_a and z rounding a batch
(``analyze``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("compress.analyze",))
