"""The set-up seconds of the cell's ``_build.build``, the last one
before the traced stretch: compiling the kernels' libraries, or finding
them built (``setup.kernels``)."""

from portbench import program_spans


def read(obs):
    return program_spans.setup_s(obs, "setup.kernels")
