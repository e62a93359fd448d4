"""The device's idle share of the traced stretch of the normal loop, in
%: the time in which no kernel, copy or fill ran (``torch.profiler``),
over the stretch's wall time."""


def read(obs):
    t = obs["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
