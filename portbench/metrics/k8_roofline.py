"""K8's share of its roofline over the traced stretch, in %: the least
time of every K8 launch the stretch's batches need (``kernels.
k8_problems``: the larger of its operations over the float32 peak and its
bytes over the memory bandwidth), over K8's device time in the trace.
None where the trace holds no K8 launch."""

from portbench import kernels


def read(obs):
    return kernels.k8_share(obs, ("compress", "decompress"))
