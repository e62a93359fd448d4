"""The whole round trip's share of the card's peak, in %: the least time
the published peaks allow for a round trip's operations, over the
measured time of a round trip (the traced run's unprofiled stretch of the
normal loop, its seconds over its batches).  The operations are counted
by ``FlopCounterMode`` over the plain reference at the cell's shapes
(``MLICPP.count_flops``): g_a, h_a and g_s against the bfloat16 peak,
h_s and the slice loop of both directions against the float32 peak."""

from portbench import kernels


def read(obs):
    f = kernels.flops(obs)
    least = ((f["g_a_h_a"] + f["g_s"]) / kernels.BF16_OPS
             + 2 * f["entropy"] / kernels.F32_OPS)
    return 100.0 * least / obs["roundtrip_s"]
