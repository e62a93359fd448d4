"""The request loop's decode as a share of the card's peak, in %: the least
time the published peaks allow for a decode's operations (g_s against
the bfloat16 peak, h_s and the slice loop against the float32 peak;
``MLICPP.count_flops`` over the plain reference at the cell's shapes),
over the mean time of a decode in the traced run's unprofiled stretch.
None where the loop times no decode apart."""

from portbench import kernels


def read(obs):
    secs = obs["direction_s"].get("decode")
    if not secs:
        return None
    f = kernels.flops(obs)
    least = f["g_s"] / kernels.BF16_OPS + f["entropy"] / kernels.F32_OPS
    return 100.0 * least / secs
