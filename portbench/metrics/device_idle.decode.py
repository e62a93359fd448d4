"""The device's idle share in the request loop's decode, in %: the time in
which no kernel, copy or fill ran (``torch.profiler``) while the host was
inside a ``decompress`` call, over the time it spent in those calls."""


def read(obs):
    return obs["trace"].idle_within("decompress")
