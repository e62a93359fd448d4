"""The set-up seconds of the cell's codec's first ``compress_begin``,
``compress_end`` and ``decompress``, in the warm-up: first launches,
library loads, cuDNN's choices (``setup.first_call``)."""

from portbench import program_spans


def read(obs):
    return program_spans.setup_s(obs, "setup.first_call")
