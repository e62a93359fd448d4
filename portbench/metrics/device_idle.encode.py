"""The device's idle share in the request loop's encode, in %: the time in
which no kernel, copy or fill ran (``torch.profiler``) while the host was
inside a ``compress`` call, over the time it spent in those calls."""


def read(obs):
    return obs["trace"].idle_within("compress")
