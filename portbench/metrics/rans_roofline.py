"""The rANS kernels' share of their roofline over the traced stretch, in
%: the least time of the launches of K7, K3, K6 (the encode) and K4 (the
decode's z and y phases) that the stretch's batches need, from the
cell's shapes and each batch's coded words and escapes
(``kernels.rans_launches``), over their device time in the trace.  K4's
CDF evaluations are not counted, so the share is a lower bound.  None
where the trace holds none of their launches."""

from portbench import kernels


def read(obs):
    return kernels.rans_share(obs, tuple(kernels.RANS_NAMES))
