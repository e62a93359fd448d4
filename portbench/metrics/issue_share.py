"""The host's ms inside a batch's ``compress_begin``, ``compress_end``
and ``decompress`` in the bulk loop, less their waits, over the device
ms of the batch's five stages, in %: the median over the traced
stretch's batches (``program_spans.issue_share``).  The host's ms
include the time its launches are blocked by a full CUDA launch queue,
so behind a busy card the share climbs towards 100 however fast the
host issues: it is the host's time in the calls, not its free issue
time."""

from portbench import program_spans


def read(obs):
    return program_spans.issue_share(program_spans.records(obs),
                                     ("encode", "decode"))
