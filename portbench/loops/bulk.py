"""A closed loop of whole batches through ``Codec.roundtrip_stream``, two
batches in flight: the storage service that re-encodes a library to the
learned codec and decodes it back, or an evaluator coding a large set.

The window opens before the first batch is handed to the pipeline and
closes with a device synchronize after the last batch that started in it
has been decoded; every image of every batch that started counts."""

from __future__ import annotations

import time


def _batches(pool, stop):
    i = 0
    while not stop(i):
        yield pool[i % pool.shape[0]]
        i += 1


def run(sut, pool, mix, seconds=None, batches=None, keep=None) -> dict:
    codec = sut.codec
    started = [0]
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds

    def stop(i):
        if batches is not None:
            done = i >= batches
        else:
            done = time.perf_counter() >= deadline
        if not done:
            started[0] = i + 1
        return done
    for j, (enc, dec) in enumerate(codec.roundtrip_stream(
            _batches(pool, stop))):
        if keep is not None:
            keep(j, enc, dec)
    sut.sync()
    secs = time.perf_counter() - t0
    images = started[0] * pool.shape[1]
    return {"images": images, "batches": started[0], "seconds": secs,
            "e2e": {"roundtrip_img_s": images / secs}}


def warm(sut, pool, mix) -> None:
    run(sut, pool, mix, batches=int(mix["warm_batches"]))
