"""K4's share of its roofline in the request loop's decode, in %: the
least time of its z and y phases for the stretch's batches
(``kernels.rans_launches``; its CDF evaluations are not counted, so a
lower bound), over the device time of its launches that began inside
``decompress`` calls.  None where there is none."""

from portbench import kernels


def read(obs):
    return kernels.rans_share(obs, ("rans_decode_phase",),
                              within="decompress")
