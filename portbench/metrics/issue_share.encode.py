"""The host's ms inside a request's ``compress_begin`` and
``compress_end`` less ``encode.wait``, over the device ms of
``encode.analyze``, ``.encode_pass`` and ``.rans_encode``, in %: the
median over the traced stretch's requests
(``program_spans.issue_share``).  The host's ms include the time its
launches are blocked by a full CUDA launch queue: it is the host's time
in the calls, not its free issue time."""

from portbench import program_spans


def read(obs):
    return program_spans.issue_share(program_spans.records(obs),
                                     ("encode",))
