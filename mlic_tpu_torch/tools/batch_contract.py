"""The codec's batch contract: B images coded in one pass give the same
per-image streams as each image coded alone (the JAX package holds it in
``tests/test_model.py``, ``test_batched_codec_matches_single``).  Serving
depends on it: a container is one image of a batch, decoded alone.

    python -m mlic_tpu_torch.tools.batch_contract \\
        --checkpoint ckpts/bench_default --batch 128       (on the card)
    python -m mlic_tpu_torch.tools.batch_contract --cpu --model MLICPP_TINY \\
        --batch 3 --size 64 64 --lanes 16

Compresses one batch of distinct dead-leaves frames, then each frame
alone, and counts the bytes by which each image's y and z strings differ.
Forward hooks on every f32 module of the entropy path (``h_s``,
``chctx_*``, ``ginter_*``, ``gintra_*``, ``local_*``, ``ep_*``, ``lrp_*``)
record each call's output in both runs; the entries of an image's row that
differ are counted by module.  A module whose inputs already differ shows
the difference it was handed, so for a few images (``--decode-idx``) each
hooked call of the batch run is also run again on that image's row of its
own inputs: the entries that differ then are the module's own (``own``).
The layers of the analysis transforms g_a and h_a that hold weights get
the same own check (their outputs are not kept): an image's latent, and
so its streams, follows the batch where one of them does.  Then the batch
is decoded, and the images at ``--decode-idx`` are decoded alone from
their containers against the batch's y_hat.

Prints one JSON line; exits 1 when any count is not 0.  Runs on the CUDA
card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.data.folder import dead_leaves_pool
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import init_params, load_checkpoint

ENTROPY_MODULES = ("h_s", "chctx_", "ginter_", "gintra_", "local_", "ep_",
                   "lrp_")


def entropy_modules(model) -> dict:
    """{name: module} of the model's f32 entropy-path children."""
    return {name: m for name, m in model.named_children()
            if name.startswith(ENTROPY_MODULES)}


def analysis_layers(model) -> dict:
    """{name: module} of the layers of g_a and h_a that hold weights."""
    return {f"{part}.{name}": m for part in ("g_a", "h_a")
            for name, m in getattr(model, part).named_modules()
            if not list(m.children())
            and list(m.parameters(recurse=False))}


def contract_frames(n: int, height: int, width: int, seed: int = 0,
                    pool: np.ndarray | None = None) -> np.ndarray:
    """``n`` distinct uint8 NHWC dead-leaves frames: a pool of at most 16
    rendered frames (or ``pool``), each also flipped left-right,
    upside-down and rolled by half its width, in turn."""
    if pool is None:
        pool = dead_leaves_pool(min(n, 16), height, seed, width=width,
                                cache_dir="")
    out = []
    for j in range(n):
        f, v = pool[j % len(pool)], j // len(pool)
        if v & 1:
            f = f[:, ::-1]
        if v & 2:
            f = f[::-1]
        if v & 4:
            f = np.roll(f, f.shape[1] // 2, axis=1)
        out.append(f)
    if len({f.tobytes() for f in out}) != n:
        raise ValueError(f"contract_frames: {n} frames need more than "
                         f"{len(pool)} pool frames")
    return np.ascontiguousarray(np.stack(out))


def decode_indices(batch: int, n: int = 8) -> list:
    """``n`` evenly spaced images of a batch, the first and the last among
    them (0, 18, ..., 108, 127 at 128)."""
    return sorted({int(i) for i in np.linspace(0, batch - 1, n)})


class Recorder:
    """Forward hooks on ``modules`` ({name: module}).  While ``calls`` is a
    dict, each call's output is kept under (module, call number) (with
    ``keep``); for the images in ``isolate``, the call is run again on the
    image's row of its inputs and the entries that differ from the row of
    the output are added to ``own[module]``."""

    def __init__(self, modules: dict, isolate=(), keep: bool = True):
        self.calls = None
        self.isolate = tuple(isolate)
        self.keep = keep
        self.own = {}
        self._inside = False
        self._handles = [m.register_forward_hook(self._hook(name))
                         for name, m in modules.items()]

    def _hook(self, name):
        def hook(mod, args, out):
            if self.calls is None or self._inside:
                return
            n = sum(1 for k in self.calls if k[0] == name)
            self.calls[(name, n)] = out.detach().clone() if self.keep \
                else None
            if out.shape[0] == 1:
                return
            self._inside = True
            try:
                for i in self.isolate:
                    alone = mod(*(a[i:i + 1] for a in args))
                    self.own[name] = self.own.get(name, 0) + int(
                        (alone[0] != out[i]).sum())
            finally:
                self._inside = False
        return hook

    def record(self, fn):
        """(``fn()``, the calls it made)."""
        self.calls = {}
        try:
            out = fn()
            return out, self.calls
        finally:
            self.calls = None

    def remove(self):
        for h in self._handles:
            h.remove()


def differing_bytes(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8)
    y = np.frombuffer(b[:n], np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


def check(codec, frames: np.ndarray, decode_idx=None) -> dict:
    """The contract on ``frames`` (uint8 [B, H, W, 3]): the batch's streams
    against each image's alone, the hooked modules' differing entries
    (all, and their own at ``decode_idx``), and the containers at
    ``decode_idx`` decoded alone against the batch's y_hat."""
    b = len(frames)
    decode_idx = decode_indices(b) if decode_idx is None else decode_idx
    rec = Recorder(entropy_modules(codec.model), isolate=decode_idx)
    layers = Recorder(analysis_layers(codec.model), isolate=decode_idx,
                      keep=False)
    try:
        t0 = time.perf_counter()
        enc, batch_calls = rec.record(
            lambda: layers.record(lambda: codec.compress(frames))[0])
        batch_s = time.perf_counter() - t0
        rec.isolate = ()
        own = dict(rec.own)
        dec = codec.decompress(enc["strings"], enc["shape"])
        entries = {}
        differ = {}
        for (name, _), out in batch_calls.items():
            entries[name] = entries.get(name, 0) + out.numel()
            differ.setdefault(name, 0)
        y_bytes = z_bytes = y_hat_alone = 0
        t0 = time.perf_counter()
        for i in range(b):
            e1, calls = rec.record(lambda: codec.compress(frames[i:i + 1]))
            if set(calls) != set(batch_calls):
                raise AssertionError(f"image {i} alone made other module "
                                     "calls than the batch")
            for key, out in calls.items():
                differ[key[0]] += int((batch_calls[key][i] != out[0]).sum())
            y_bytes += differing_bytes(e1["strings"][0][0],
                                       enc["strings"][0][i])
            z_bytes += differing_bytes(e1["strings"][1][0],
                                       enc["strings"][1][i])
            y_hat_alone += int((e1["y_hat"][0] != enc["y_hat"][i]).sum())
        alone_s = time.perf_counter() - t0
    finally:
        rec.remove()
        layers.remove()
    containers = {}
    for i in decode_idx:
        d1 = codec.decompress([[enc["strings"][0][i]],
                               [enc["strings"][1][i]]], enc["shape"])
        containers[i] = int((d1["y_hat"][0] != enc["y_hat"][i]).sum())
    return {"batch": b, "frames": list(frames.shape[1:3]),
            "y_stream_bytes": sum(len(s) for s in enc["strings"][0]),
            "y_bytes_differing": y_bytes, "z_bytes_differing": z_bytes,
            "y_hat_entries_differing_alone": y_hat_alone,
            "batch_roundtrip_y_hat_differing": int(
                (dec["y_hat"] != enc["y_hat"]).sum()),
            "decode_idx": list(decode_idx),
            "containers_y_hat_differing": containers,
            "module_entries": entries, "module_entries_differing": differ,
            "module_own_entries_differing": own,
            "analysis_own_entries_differing": dict(layers.own),
            "batch_compress_s": batch_s, "alone_compress_s": alone_s}


def broken(res: dict) -> list:
    """The counts of ``check``'s result that are not 0."""
    bad = [k for k in ("y_bytes_differing", "z_bytes_differing",
                       "y_hat_entries_differing_alone",
                       "batch_roundtrip_y_hat_differing") if res[k]]
    bad += [f"container {i}" for i, n in
            res["containers_y_hat_differing"].items() if n]
    bad += [f"module {k}" for k, n in res["module_entries_differing"].items()
            if n]
    bad += [f"module {k} (own)" for k, n in
            res["module_own_entries_differing"].items() if n]
    bad += [f"layer {k} (own)" for k, n in
            res["analysis_own_entries_differing"].items() if n]
    return bad


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="MLICPP_S")
    p.add_argument("--checkpoint", default=None,
                   help="orbax directory or torch file (default: seeded "
                        "random weights)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, nargs=2, default=(512, 768))
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--transform-dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    model = get_model(args.model, transform_dtype=(
        None if args.cpu else args.transform_dtype))
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    else:
        model.load_state_dict(init_params(
            model, torch.Generator().manual_seed(args.seed)))
    codec = Codec(model, n_lanes=args.lanes, device=device)
    codec.update()
    frames = contract_frames(args.batch, *args.size, seed=args.seed)
    res = {"model": args.model, "weights": args.checkpoint or "seeded",
           "device": device,
           **({"card": torch.cuda.get_device_name(0)} if device == "cuda"
              else {}),
           **check(codec, frames)}
    res["broken"] = broken(res)
    print(json.dumps({"batch_contract": res}), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(1 if main()["broken"] else 0)
