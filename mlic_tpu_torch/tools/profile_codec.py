"""Stage-level wall time of the device codec's compress and decompress
(port of ``tools/profile_codec.py``).

Runs the device backend's steps one section at a time, each ended by
``torch.cuda.synchronize()`` (on the CPU there is nothing to wait for), so
that the time of each stage is its own:

  compress:   c.upload | c.gain | c.analyze | c.encode_pass | c.rans_encode
              | c.stream_dl | c.synthesize
  decompress: d.gain | d.parse | d.upload | d.device_pass | d.synthesize

Format v4 carries z in the y stream, so the JAX tool's z stages (c.z_dl,
c.z_host, d.z_host) have no counterpart.  Each round trip must reproduce
the encoder's x_hat bit for bit, and the tool raises when ``Codec.update``
took a fallback (``parametric`` False or ``analytic_enc_rows`` 0): the
stages are those of the parametric tables.

    python -m mlic_tpu_torch.tools.profile_codec       (on the card)
    PROF_MODEL=MLICPP_TINY PROF_BATCH=2 PROF_REPS=1 PROF_LANES=16 \\
        PROF_HEIGHT=64 PROF_WIDTH=64 python -m mlic_tpu_torch.tools.profile_codec --cpu

Environment: PROF_MODEL (MLICPP_S), PROF_BATCH (8), PROF_REPS (3),
PROF_LANES (512), PROF_CKPT (default ``ckpts/bench_default`` for
MLICPP_S, seeded weights otherwise; an orbax directory or a torch file,
taken by ``load_matching``), PROF_BF16 (1: ``bfloat16`` transforms),
PROF_CPU (1: as ``--cpu``), PROF_HEIGHT / PROF_WIDTH (512 x 768).  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec, encode_rans_v4
from mlic_tpu_torch.data.folder import synthetic_batches
from mlic_tpu_torch.entropy.stream import parse_global
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import init_params, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
DEFAULT_CKPT = os.path.join(REPO, "ckpts", "bench_default")


class T:
    """Named wall-time accumulator; each section waits for the device."""

    def __init__(self, device):
        self.acc: dict[str, float] = {}
        self.device = device

    def section(self, name):
        return _Sec(self, name)


class _Sec:
    def __init__(self, t, name):
        self.t, self.name = t, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if self.t.device.type == "cuda":
            torch.cuda.synchronize(self.t.device)
        self.t.acc[self.name] = self.t.acc.get(self.name, 0.0) \
            + time.perf_counter() - self.t0


def build_codec(model_name: str, lanes: int, bf16: bool, ckpt: str,
                device) -> Codec:
    """The device codec of the run: seeded weights, then the checkpoint's
    matching leaves; raises when ``update`` falls back."""
    model = get_model(model_name, "bfloat16" if bf16 else None)
    state = init_params(model, torch.Generator().manual_seed(0))
    if ckpt:
        state, _ = load_matching(state, load_checkpoint(ckpt))
    model.load_state_dict(state)
    codec = Codec(model, n_lanes=lanes, device=device)
    codec.update()
    if not codec.parametric or not codec.analytic_enc_rows:
        raise RuntimeError(
            f"Codec.update fell back (parametric {codec.parametric}, "
            f"analytic_enc_rows {codec.analytic_enc_rows}): the stages "
            "would not be those of the parametric tables")
    return codec


def compress(codec: Codec, t: T, x_np: np.ndarray) -> dict:
    """``Codec.compress`` on the device backend, a section a stage."""
    model = codec.model
    with t.section("c.upload"):
        x = codec._images(x_np)
    with t.section("c.gain"):
        scale = codec._scale_for(0, 0.0)
        tables = codec._tables_for(codec._z_qs_for(0, 0.0))
    with t.section("c.analyze"):
        y, z_symbols = model.analyze(x)
    with t.section("c.encode_pass"):
        y_hat, sym32, idx = model.codec_encode_pass(y, z_symbols, scale)
    b, zh, zw, _ = z_symbols.shape
    with t.section("c.rans_encode"):
        comp = encode_rans_v4(sym32, idx, z_symbols.reshape(b, -1), tables,
                              codec.n_lanes, 2 * model.cfg.slice_num,
                              codec.z_rows_base)
    with t.section("c.stream_dl"):
        counts = torch.cat([comp["img_n"], comp["ecount"]]).cpu().numpy()
        n_w = int(counts[:b].sum())
        n_e = int(counts[b:].sum())
        streams = codec._assemble(comp, counts, comp["buf"][:n_w].cpu()
                                  .numpy(), comp["ebuf"][:n_e].cpu().numpy())
    with t.section("c.synthesize"):
        x_hat = model.synthesize(y_hat)
    return {"strings": streams, "shape": (zh, zw), "x_hat": x_hat}


def decompress(codec: Codec, t: T, streams, shape) -> torch.Tensor:
    """``Codec.decompress`` of format v4, a section a stage."""
    model = codec.model
    with t.section("d.gain"):
        scale = codec._scale_for(0, 0.0)
        z_qs = codec._z_qs_for(0, 0.0)
        tables = codec._tables_for(z_qs)
    with t.section("d.parse"):
        parsed = [parse_global(s) for s in streams]
        words = np.concatenate([w for _, w, _ in parsed]).view(np.int16)
        img_begin = np.cumsum([0] + [len(w) for _, w, _ in parsed[:-1]])
        escs = [e for _, _, e in parsed]
        esc_begin = np.cumsum([0] + [len(e) for e in escs[:-1]])
        esc = np.concatenate(escs) if sum(map(len, escs)) else np.zeros(1)
    with t.section("d.upload"):
        args = [codec._to_device(np.asarray(a, dt)) for a, dt in (
            (words, np.int16), (img_begin, np.int32), (esc, np.int32),
            (esc_begin, np.int32))]
    zh, zw = shape
    with t.section("d.device_pass"):
        y_hat = model.codec_device_pass_v4(
            zh, zw, args[0], args[1], tables, codec.n_lanes, codec.n_steps,
            codec.z_steps_row, codec.z_rows_base, args[2], args[3], scale,
            z_qs)
    with t.section("d.synthesize"):
        x_hat = model.synthesize(y_hat)
    return x_hat


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="stage times of the device "
                                "codec")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    cpu = args.cpu or os.environ.get("PROF_CPU", "0") == "1"
    model_name = os.environ.get("PROF_MODEL", "MLICPP_S")
    batch = int(os.environ.get("PROF_BATCH", "8"))
    reps = int(os.environ.get("PROF_REPS", "3"))
    n_lanes = int(os.environ.get("PROF_LANES", "512"))
    h = int(os.environ.get("PROF_HEIGHT", "512"))
    w = int(os.environ.get("PROF_WIDTH", "768"))
    bf16 = os.environ.get("PROF_BF16", "1") == "1"
    ckpt = os.environ.get("PROF_CKPT", "")
    if not ckpt and model_name == "MLICPP_S" and os.path.isdir(DEFAULT_CKPT):
        ckpt = DEFAULT_CKPT
    codec = build_codec(model_name, n_lanes, bf16, ckpt,
                        "cpu" if cpu else None)

    imgs = []
    for b in synthetic_batches(batch, 64, steps=reps + 1, seed=7):
        img = np.tile(b, (1, h // 64 + 1, w // 64 + 1, 1))[:, :h, :w, :]
        imgs.append(np.round(img * 255).astype(np.uint8))

    def roundtrip(t, x_np):
        enc = compress(codec, t, x_np)
        x_hat = decompress(codec, t, enc["strings"], enc["shape"])
        if not torch.equal(x_hat, enc["x_hat"]):
            raise AssertionError("decoded x_hat differs from the encoder's")

    with torch.no_grad():
        roundtrip(T(codec.device), imgs[0])          # warm-up
        t = T(codec.device)
        t0 = time.perf_counter()
        for x_np in imgs[1:]:
            roundtrip(t, x_np)
        total = time.perf_counter() - t0

    n = reps * batch
    out = {"model": model_name, "batch": batch, "reps": reps,
           "lanes": n_lanes, "size": [h, w], "ckpt": ckpt or None,
           "transform_dtype": "bfloat16" if bf16 else "float32",
           "parametric": bool(codec.parametric),
           "analytic_enc_rows": int(codec.analytic_enc_rows),
           "img_per_s": n / total,
           "ms_per_image": {k: 1000 * v / n for k, v in sorted(t.acc.items())},
           "accounted_ms": 1000 * sum(t.acc.values()) / n,
           "total_ms": 1000 * total / n,
           "device": (torch.cuda.get_device_name(codec.device)
                      if codec.device.type == "cuda" else "cpu")}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
