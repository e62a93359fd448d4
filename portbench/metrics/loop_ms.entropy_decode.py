"""The device ms of the decoder's z phase of K4, h_s and slice loop
(K4's y phases) in the bulk loop, two batches in flight
(``decode.entropy_decode``): the median over the traced stretch's
batches of the time between the stage span's two CUDA events, with no
synchronize between stages."""

from portbench import program_spans


def read(obs):
    return program_spans.stage_ms(program_spans.records(obs),
                                  "decode.entropy_decode")
