"""Data-parallel serving: the codec sharded over a list of devices (the
counterpart of ``mlic_tpu/parallel/serving.py``).

The JAX package runs one program over a mesh, the batch sharded with
``shard_map``.  The port holds one replica of the model and of a device
``Codec`` (format v4, or v3 under ``MLIC_UNIFIED_Z=0``) per entry of a
list of devices, splits each batch evenly over them and queues each
shard's work on a CUDA stream of its own, so the shards' kernels (K7, K3,
K6 and K4) run side by side; the host assembles one container per image
exactly as ``Codec`` does, so a shard's streams are the single codec's
streams of those images.  A list may name one device twice
(``["cuda:0", "cuda:0"]``, ``["cpu", "cpu"]``): two replicas, two
streams, one card.

One host thread issues every replica's launches, and a request is bound
by the host's launches, not by the card: N replicas take about N times
one replica's host time a batch, so on a host of several cards this
serves slower than one card does (PERF.md).  Driving each replica from a
thread of its own was slower still (Python's global lock serializes the
interpreter between launches).  What would scale out is a process a
card, as training runs, or fewer launches (CUDA graphs).

Differences from ``Codec``, as in the JAX package:

* the batch must divide evenly over the shards, else ``ValueError``;
* ``compress`` returns no ``y_hat`` (serving delivers streams;
  ``encode_recon=True`` still returns ``x_hat``);
* the JAX package refuses v3's symbol-overflow fallbacks here.  The
  port's device encoder codes int32 symbols with escapes in v3 as in v4
  and has no such fallback, so there is nothing to refuse.

Results handed back (``x_hat``, ``y_hat``) are on the first device,
ordered after the shards' streams on the caller's current stream.
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.device import resolve_device


class ShardedCodec:
    """``Codec``'s serving interface (``update``, ``compress_begin``/
    ``compress_end``, ``compress``, ``decompress``, ``roundtrip_stream``)
    over ``devices``, one replica each; ``model`` carries the weights and
    becomes the first replica's."""

    backend = "device"

    def __init__(self, model, devices, n_lanes: int = 512,
                 encode_recon: bool = False):
        if not devices:
            raise ValueError("ShardedCodec needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        models = [model] + [copy.deepcopy(model) for _ in self.devices[1:]]
        self.replicas = [Codec(m, n_lanes=n_lanes, device=d,
                               encode_recon=encode_recon)
                         for m, d in zip(models, self.devices)]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self.device = self.devices[0]
        self.n_lanes = self.replicas[0].n_lanes
        self.unified_z = self.replicas[0].unified_z
        self.encode_recon = encode_recon
        self._sync_all()        # the replicas' weights, before any stream

    @property
    def n_shards(self) -> int:
        return len(self.replicas)

    @property
    def parametric(self) -> bool:
        return self.replicas[0].parametric

    @property
    def analytic_enc_rows(self) -> int:
        return self.replicas[0].analytic_enc_rows

    def _on(self, i: int):
        """Shard ``i``'s device and stream as the current ones."""
        s = self.streams[i]
        if s is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(s.device))
        stack.enter_context(torch.cuda.stream(s))
        return stack

    def _sync_all(self) -> None:
        for d in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    def _hand_over(self, i: int, t):
        """Shard ``i``'s result tensor on the first device, ordered after
        shard ``i``'s stream on the caller's current stream."""
        if t.device.type == "cuda":
            cur = torch.cuda.current_stream(t.device)
            cur.wait_stream(self.streams[i])
            t.record_stream(cur)
        return t.to(self.device, non_blocking=True)

    def _per_shard(self, n: int) -> int:
        if n % self.n_shards:
            raise ValueError(f"batch {n} not divisible by {self.n_shards} "
                             "shards")
        return n // self.n_shards

    @torch.no_grad()
    def update(self, scale_table=None, force: bool = True) -> bool:
        """Every replica's ``Codec.update`` (K1 and K2 run once each); the
        replicas must take the same tables."""
        built = False
        for i, codec in enumerate(self.replicas):
            with self._on(i):
                built |= codec.update(scale_table, force)
        self._sync_all()
        kinds = {(c.parametric, c.analytic_enc_rows) for c in self.replicas}
        if len(kinds) > 1:
            raise RuntimeError(f"the replicas built different tables: "
                               f"{sorted(kinds)}")
        return built

    def _require_tables(self) -> None:
        if any(c._gc is None for c in self.replicas):
            self.update()

    @torch.no_grad()
    def compress_begin(self, x, s: int = 0, inputscale: float = 0.0) -> dict:
        """Queue each shard's ``Codec.compress_begin`` on its stream, with
        no host synchronization once warm."""
        self._require_tables()
        t0 = time.perf_counter()
        per = self._per_shard(len(x))
        on_card = isinstance(x, torch.Tensor) and x.is_cuda
        caller = torch.cuda.current_stream(x.device) if on_card else None
        handles = []
        for i, codec in enumerate(self.replicas):
            part = x[i * per:(i + 1) * per]
            with self._on(i):
                if on_card:     # the images as the caller's stream left them
                    torch.cuda.current_stream().wait_stream(caller)
                    part.record_stream(torch.cuda.current_stream())
                handles.append(codec.compress_begin(part, s, inputscale))
        return {"shards": handles, "t0": t0}

    @torch.no_grad()
    def compress_end(self, h: dict) -> dict:
        """Each shard's ``Codec.compress_end``, in shard order: the
        batch's streams, the z shape and, with ``encode_recon``, x_hat."""
        y_strings, z_strings, x_hats = [], [], []
        for i, (codec, hs) in enumerate(zip(self.replicas, h["shards"])):
            with self._on(i):
                enc = codec.compress_end(hs)
            y_strings += enc["strings"][0]
            z_strings += enc["strings"][1]
            if self.encode_recon:
                x_hats.append(self._hand_over(i, enc["x_hat"]))
        res = {"strings": [y_strings, z_strings], "shape": enc["shape"],
               "cost_time": time.perf_counter() - h["t0"]}
        if self.encode_recon:
            res["x_hat"] = torch.cat(x_hats)
        return res

    def compress(self, x, s: int = 0, inputscale: float = 0.0) -> dict:
        t0 = time.perf_counter()
        out = self.compress_end(self.compress_begin(x, s, inputscale))
        self._sync_all()
        out["cost_time"] = time.perf_counter() - t0
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, s: int = 0, inputscale: float = 0.0,
                   wait: bool = True) -> dict:
        """Each shard's streams decoded by its replica on its stream (any
        kind ``Codec.decompress`` reads); x_hat and y_hat of the batch.
        ``wait=False`` returns once the work is queued."""
        t0 = time.perf_counter()
        self._require_tables()
        y_strings, z_strings = strings
        per = self._per_shard(len(y_strings))
        x_hats, y_hats = [], []
        for i, codec in enumerate(self.replicas):
            sl = slice(i * per, (i + 1) * per)
            with self._on(i):
                dec = codec.decompress([y_strings[sl], z_strings[sl]], shape,
                                       s, inputscale, wait=False)
            x_hats.append(self._hand_over(i, dec["x_hat"]))
            y_hats.append(self._hand_over(i, dec["y_hat"]))
        out = {"x_hat": torch.cat(x_hats), "y_hat": torch.cat(y_hats)}
        if wait:
            self._sync_all()
        out["cost_time"] = time.perf_counter() - t0
        return out

    # the two-deep pipeline of ``Codec``, over the shards' handles
    roundtrip_stream = Codec.roundtrip_stream
    _handed_out = Codec._handed_out
