"""The device ms of the encoder's h_s and slice loop in the request loop
(``encode.encode_pass``): the median over the traced stretch's batches
of the time between the stage span's two CUDA events, with no
synchronize between stages."""

from portbench import program_spans


def read(obs):
    return program_spans.stage_ms(program_spans.records(obs),
                                  "encode.encode_pass")
