"""The entropy model: the encoder's h_s and slice loop (contexts,
entropy parameters, LRP, K8) a batch (``encode_pass``).

Median ms over the traced run's staged batches
(``Codec.compress/decompress(timings=...)``; each stage ends in a
synchronize)."""

from portbench.stages import median_ms


def read(obs):
    return median_ms(obs, ("compress.encode_pass",))
