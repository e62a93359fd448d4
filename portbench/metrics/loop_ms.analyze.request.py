"""The device ms of the encoder's g_a, h_a and z rounding in the request
loop (``encode.analyze``): the median over the traced stretch's batches
of the time between the stage span's two CUDA events, with no
synchronize between stages."""

from portbench import program_spans


def read(obs):
    return program_spans.stage_ms(program_spans.records(obs),
                                  "encode.analyze")
