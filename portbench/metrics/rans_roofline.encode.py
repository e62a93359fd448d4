"""The rANS encode's share of its roofline in the request loop, in %:
the least time of K7, K3 and K6 for the stretch's batches
(``kernels.rans_launches``), over the device time of their launches that
began inside ``compress`` calls.  None where there is none."""

from portbench import kernels


def read(obs):
    return kernels.rans_share(obs, kernels.RANS_ENCODE, within="compress")
