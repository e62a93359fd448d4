"""The codec driver's host work a batch: the encoder's stream
assembly (``assemble``) and the decoder's parse (``parse``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("compress.assemble", "decompress.parse"))
