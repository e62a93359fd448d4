"""The device ms of the decoder's g_s in the bulk loop, two batches in
flight (``decode.synthesize``): the median over the traced stretch's
batches of the time between the stage span's two CUDA events, with no
synchronize between stages."""

from portbench import program_spans


def read(obs):
    return program_spans.stage_ms(program_spans.records(obs),
                                  "decode.synthesize")
