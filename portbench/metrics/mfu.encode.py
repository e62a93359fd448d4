"""The request loop's encode as a share of the card's peak, in %: the least
time the published peaks allow for a encode's operations (g_a and h_a against
the bfloat16 peak, h_s and the slice loop against the float32 peak;
``MLICPP.count_flops`` over the plain reference at the cell's shapes),
over the mean time of a encode in the traced run's unprofiled stretch.
None where the loop times no encode apart."""

from portbench import kernels


def read(obs):
    secs = obs["direction_s"].get("encode")
    if not secs:
        return None
    f = kernels.flops(obs)
    least = f["g_a_h_a"] / kernels.BF16_OPS + f["entropy"] / kernels.F32_OPS
    return 100.0 * least / secs
