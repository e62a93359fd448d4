"""K8's share of its roofline in the request loop's decode, in %: the
least time of the K8 launches a decompress of the stretch's batches needs
(``kernels.k8_problems``), over the device time of the K8 launches that
began inside ``decompress`` calls (each ends in a synchronize).  None where
the trace holds no such launch."""

from portbench import kernels


def read(obs):
    return kernels.k8_share(obs, ("decompress",), within="decompress")
