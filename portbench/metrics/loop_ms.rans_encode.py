"""The device ms of the rANS encode (K7, K3, K6) and the copy of its
counts and words to pinned memory in the bulk loop, two batches in
flight (``encode.rans_encode``): the median over the traced stretch's
batches of the time between the stage span's two CUDA events, with no
synchronize between stages."""

from portbench import program_spans


def read(obs):
    return program_spans.stage_ms(program_spans.records(obs),
                                  "encode.rans_encode")
