"""One client in a closed loop: each request is ``Codec.compress`` of a
batch, then ``Codec.decompress`` of its streams, each timed by the host
clock to its end (the streams in host memory; x_hat on the device, after
a synchronize); the next request is sent when the previous returns.  An
upload service that codes each arriving group of photos and hands back
the decoded preview before taking the next group."""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np


def run(sut, pool, mix, seconds=None, batches=None, keep=None) -> dict:
    codec = sut.codec
    enc_ms, dec_ms = [], []
    t0 = time.perf_counter()
    i = 0
    while (i < batches) if batches is not None else (
            time.perf_counter() < t0 + seconds):
        x = pool[i % pool.shape[0]]
        ta = time.perf_counter()
        enc = codec.compress(x)
        tb = time.perf_counter()
        dec = codec.decompress(enc["strings"], enc["shape"])
        tc = time.perf_counter()
        enc_ms.append((tb - ta) * 1e3)
        dec_ms.append((tc - tb) * 1e3)
        if keep is not None:
            keep(i, enc, dec)
        i += 1
    sut.sync()
    secs = time.perf_counter() - t0
    images = i * pool.shape[1]
    e2e = {"roundtrip_img_s": images / secs,
           "encode_ms_p90": float(np.percentile(enc_ms, 90)),
           "decode_ms_p90": float(np.percentile(dec_ms, 90))}
    if seconds is not None:
        print(f"requests {i}: encode ms median "
              f"{statistics.median(enc_ms):.3f}, decode ms median "
              f"{statistics.median(dec_ms):.3f}", file=sys.stderr)
    return {"images": images, "batches": i, "seconds": secs, "e2e": e2e,
            "direction_s": {"encode": statistics.fmean(enc_ms) / 1e3,
                            "decode": statistics.fmean(dec_ms) / 1e3}}


def warm(sut, pool, mix) -> None:
    run(sut, pool, mix, batches=int(mix["warm_batches"]))
