"""How a traffic mix drives the system: one module a kind of loop, named
by the mix's ``loop`` key.  Each has ``warm(sut, pool, mix)`` and
``run(sut, pool, mix, seconds=None, batches=None, keep=None)``; ``run``
returns the images it coded, the window's seconds, and its end-to-end
metrics by name (and, where a batch's directions run apart, their mean
seconds under ``direction_s``).  A loop may name its system under test
and its comparison (``SUT``, ``JUDGE``: modules of ``portbench/``); the
codec's (``codec_sut``, ``judge``) where it names none."""
