"""Device time of each module and coding stage (port of
``tools/microbench.py``).

The JAX tool repeats a module ``reps`` times inside one ``lax.scan`` and
fences once, so that the TPU runtime's dispatch cost drops out.  PyTorch
has no scan: here a module runs ``reps`` times back to back between two
CUDA events with one synchronize at the end, so the launches queue ahead
of the card and the time a call is the card's (``events_ms``; the host
clock on the CPU).  ``tools.profile_modules`` times one call at a time.

Sets (``MB_SET``):

* ``gemm``: a 2048^3 f32 matrix product (the card's f32 rate, no TF32),
  and the widest entropy-parameters product in f32 and bf16;
* ``ctx``: the context modules with their calls a pass;
* ``all``: ``gemm``, ``ctx`` and the four transforms;
* ``encode``: the encode's stages on a trained codec's real latents --
  analyze, the encode pass, K7, K3 and K6 alone, the whole format-v4
  encode, and the format-v2 (K7, K3 and the per-lane compaction) and v3
  encodes of the same y symbols;
* ``decode``: the format-v4 decode pass (K4, 1 + 2 * slice_num launches)
  on the batch's real streams, and K4's lane layout decoding the same y
  symbols coded in format v2;
* ``fusedblk``: g_a and g_s with the fused block tail (K5) against the
  unfused blocks, under ``bfloat16`` and ``bfloat16_mixed`` (``MB_TDT``, a
  comma-separated list), alternated over two segments;
* ``train``: a training step in float32 against ``bfloat16_mixed``,
  alternated over two segments (``MB_PATCH`` crops).

    python -m mlic_tpu_torch.tools.microbench              (on the card)
    MB_SET=encode MB_MODEL=MLICPP_TINY MB_BATCH=2 MB_REPS=1 MB_HEIGHT=64 \\
        MB_WIDTH=64 MB_LANES=16 python -m mlic_tpu_torch.tools.microbench --cpu

Environment: MB_MODEL (MLICPP_S), MB_BATCH (8), MB_REPS (30), MB_SET
(all), MB_LANES (512), MB_CKPT (``ckpts/bench_default`` for MLICPP_S),
MB_TDT, MB_PATCH (256), MB_HEIGHT / MB_WIDTH (512 x 768).  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.models.config import model_config
from mlic_tpu_torch.tools.profile_modules import (
    context_cases,
    latents,
    row,
    transform_cases,
)

SETS = ("all", "ctx", "gemm", "encode", "decode", "fusedblk", "train")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def events_ms(fn, reps: int, device) -> float:
    """ms a call of ``fn`` over ``reps`` back-to-back calls after a
    warm-up: CUDA events around them and one synchronize on the card, the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def trained_codec(name: str, tdt: str, lanes: int, device,
                  encode_recon: bool = True):
    """A device codec of ``name`` under ``tdt``: seeded weights, and for
    MLICPP_S the trained checkpoint's (``MB_CKPT``)."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.utils.checkpoint import load_matching
    from mlic_tpu_torch.weights import init_params, load_checkpoint
    model = get_model(name, tdt)
    state = init_params(model, torch.Generator().manual_seed(1))
    ckpt = os.environ.get("MB_CKPT", os.path.join(REPO, "ckpts",
                                                  "bench_default"))
    if name == "MLICPP_S" and os.path.exists(ckpt):
        state, _ = load_matching(state, load_checkpoint(ckpt))
    model.load_state_dict(state)
    codec = Codec(model, n_lanes=lanes, device=device,
                  encode_recon=encode_recon)
    codec.update()
    return codec


def frames(B: int, H: int, W: int) -> np.ndarray:
    from mlic_tpu_torch.data.folder import dead_leaves_pool
    pool = dead_leaves_pool(min(B, 24), H, seed=1303, width=W)
    return np.asarray(pool)[np.arange(B) % len(pool)]


def encode_set(name, B, H, W, reps, device, rows) -> None:
    from mlic_tpu_torch.codec import encode_rans_v4
    from mlic_tpu_torch.entropy import device_rans as dr
    lanes = int(os.environ.get("MB_LANES", "512"))
    codec = trained_codec(name, os.environ.get("MB_TDT", "bfloat16"), lanes,
                          device, encode_recon=False)
    model, tables = codec.model, codec.tables
    n_ph = 2 * model.cfg.slice_num
    x = codec._images(frames(B, H, W))
    rows.append(row("analyze(g_a+h_a+round)",
                    events_ms(lambda: model.analyze(x), reps, device), 1))
    y, z = model.analyze(x)
    rows.append(row("codec_encode_pass", events_ms(
        lambda: model.codec_encode_pass(y, z), reps, device), 1))
    _, sym, idx = model.codec_encode_pass(y, z)
    z_flat = z.reshape(B, -1).contiguous()
    an = codec.analytic_enc_rows
    prep_args = (sym, idx, z_flat, tables, codec.z_rows_base,
                 tables["cdf_rows"].shape[0] - codec.z_rows_base, not an)
    rows.append(row("K7 rans_encode_prep (z + y)", events_ms(
        lambda: dr.rans_encode_prep(*prep_args), reps, device), 1))
    (st_z, fm_z, esc_z), (st_y, fm_y, esc_y) = dr.rans_encode_prep(
        *prep_args)
    scan_args = (st_z, fm_z, st_y, fm_y, lanes, n_ph)
    rows.append(row("K3 rans_encode_scan", events_ms(
        lambda: dr.rans_encode_scan(*scan_args), reps, device), 1))
    got = dr.rans_encode_scan(*scan_args)
    compact_args = (*got, esc_z, z_flat, esc_y, sym, lanes, n_ph)
    rows.append(row("K6 rans_encode_compact", events_ms(
        lambda: dr.rans_encode_compact(*compact_args), reps, device), 1))
    rows.append(row("rANS enc v4 total (K7+K3+K6)", events_ms(
        lambda: encode_rans_v4(sym, idx, z_flat, tables, lanes, n_ph,
                               codec.z_rows_base, not an), reps, device), 1))
    for fmt, label in (("lanes", "rANS enc v2 y (K7+K3+lane compaction)"),
                       ("global", "rANS enc v3 y (K7+K3+K6)")):
        rows.append(row(label, events_ms(
            lambda: dr.encode_interleaved_device(sym, idx, tables, lanes,
                                                 n_ph, fmt, an),
            reps, device), 1))


def decode_set(name, B, H, W, reps, device, rows) -> None:
    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.stream import (assemble_lane_streams,
                                               lane_decode_inputs)
    lanes = int(os.environ.get("MB_LANES", "512"))
    codec = trained_codec(name, os.environ.get("MB_TDT", "bfloat16"), lanes,
                          device)
    model, tables = codec.model, codec.tables
    x = frames(B, H, W)
    enc = codec.compress(x)
    words, img_begin, esc, esc_begin = codec._parse(enc["strings"][0], False)
    zh, zw = enc["shape"]
    rows.append(row(f"codec_device_pass_v4 (K4 x "
                    f"{1 + 2 * model.cfg.slice_num}, lanes={lanes})",
                    events_ms(lambda: model.codec_device_pass_v4(
                        zh, zw, words, img_begin, tables, lanes,
                        codec.n_steps, codec.z_steps_row, codec.z_rows_base,
                        esc, esc_begin), reps, device), 1))
    y, z = model.analyze(codec._images(x))
    _, sym, idx = model.codec_encode_pass(y, z)
    n_ph = 2 * model.cfg.slice_num
    streams = assemble_lane_streams(dr.encode_interleaved_device(
        sym, idx, tables, lanes, n_ph, "lanes", codec.analytic_enc_rows),
        lanes)
    args = lane_decode_inputs(streams, codec.device)
    pad = tables["row_params"].shape[0] - 1
    rows_ph = [dr.phase_order(p, lanes, pad).contiguous()
               for p in idx.chunk(n_ph, 1)]

    def decode_all():
        init, dec = dr.make_decoder(args["words"], codec.n_steps,
                                    args["esc"], args["esc_begin"], lanes,
                                    fmt="lanes")
        carry = init(args["lane_begin"])
        for r in rows_ph:
            carry, _ = dec(carry, r, tables)

    rows.append(row(f"K4 lane layout (K4 x {n_ph}, the v2 y phases)",
                    events_ms(decode_all, reps, device), 1))


def fusedblk_set(name, B, H, W, reps, device, rows) -> dict:
    """Returns {"<part> tdt=<tdt>": max |fused - unfused|}."""
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.weights import init_params
    cfg = model_config(name)
    t = latents(cfg, B, H, W, device)
    tdts = os.environ.get("MB_TDT", "bfloat16,bfloat16_mixed").split(",")
    before = os.environ.get("MLIC_FUSED_BLOCKS")
    diffs = {}
    try:
        for tdt in tdts:
            model = get_model(name, tdt)
            model.load_state_dict(init_params(
                model, torch.Generator().manual_seed(0)))
            model.to(device).eval()
            outs = {}
            for seg in range(2):
                for mode in ("unfused", "fused"):
                    os.environ["MLIC_FUSED_BLOCKS"] = \
                        "1" if mode == "fused" else "0"
                    for part, fn, inp in (("g_a", model.g_a, t["x"]),
                                          ("g_s", model.g_s, t["y"])):
                        r = row(f"{part}[{mode}] seg{seg} tdt={tdt}",
                                events_ms(lambda: fn(inp), reps, device), 1)
                        outs[(part, mode)] = fn(inp).float()
                        rows.append(r)
            for part in ("g_a", "g_s"):
                diffs[f"{part} tdt={tdt}"] = float(
                    (outs[(part, "fused")] - outs[(part, "unfused")])
                    .abs().max())
    finally:
        if before is None:
            os.environ.pop("MLIC_FUSED_BLOCKS", None)
        else:
            os.environ["MLIC_FUSED_BLOCKS"] = before
    return diffs


def train_set(name, B, reps, device, rows) -> None:
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.train.trainer import (TrainConfig,
                                              create_train_state, train_step)
    from mlic_tpu_torch.weights import init_params
    P = int(os.environ.get("MB_PATCH", "256"))
    g = torch.Generator().manual_seed(5)
    batch = torch.rand(B, P, P, 3, generator=g).to(device)
    cfg_t = TrainConfig(lmbda=0.025)
    states = {}
    for tdt in ("float32", "bfloat16_mixed"):
        model = get_model(name, tdt)
        model.load_state_dict(init_params(model,
                                          torch.Generator().manual_seed(0)))
        states[tdt] = create_train_state(model, cfg_t, device)
    for seg in range(2):
        for tdt, st in states.items():
            rows.append(row(f"train_step[{tdt}] seg{seg}", events_ms(
                lambda: train_step(st, batch, cfg_t), reps, device), 1))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="device time of each module")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    name = os.environ.get("MB_MODEL", "MLICPP_S")
    B = int(os.environ.get("MB_BATCH", "8"))
    reps = int(os.environ.get("MB_REPS", "30"))
    which = os.environ.get("MB_SET", "all")
    H = int(os.environ.get("MB_HEIGHT", "512"))
    W = int(os.environ.get("MB_WIDTH", "768"))
    if which not in SETS:
        raise ValueError(f"MB_SET {which!r}: one of {SETS}")
    cfg = model_config(name)
    rows, extra = [], {}
    with torch.no_grad():
        if which in ("all", "gemm"):
            g = torch.Generator().manual_seed(0)
            mp = torch.randn(2048, 2048, generator=g).to(device)
            wp = torch.randn(2048, 2048, generator=g).to(device)
            ms = events_ms(lambda: mp @ wp, reps, device)
            r = row("mm_probe[2048^3 f32]", ms, 1)
            r["tflops"] = 2 * 2048 ** 3 / (ms * 1e-3) / 1e12
            rows.append(r)
            L = B * (H // 16) * (W // 16)
            K = 2 * cfg.M + 10 * cfg.slice_ch
            a32 = torch.randn(L, K, generator=g).to(device)
            w32 = torch.randn(K, 320, generator=g).to(device)
            rows.append(row("gemm[LxKx320] f32", events_ms(
                lambda: a32 @ w32, reps, device), 1))
            a16, w16 = a32.bfloat16(), w32.bfloat16()
            rows.append(row("gemm[LxKx320] bf16", events_ms(
                lambda: a16 @ w16, reps, device), 1))
        if which in ("all", "ctx"):
            t = latents(cfg, B, H, W, device)
            S = cfg.slice_num
            for label, mod, inputs, count in context_cases(
                    cfg, t, device, widths=[max(S - 1, 1)]):
                rows.append(row(label, events_ms(lambda: mod(*inputs), reps,
                                                 device), count))
        if which == "all":
            t = latents(cfg, B, H, W, device)
            for label, mod, inputs, count in transform_cases(cfg, t, device):
                rows.append(row(label, events_ms(lambda: mod(*inputs), reps,
                                                 device), count))
        if which == "encode":
            encode_set(name, B, H, W, reps, device, rows)
        if which == "decode":
            decode_set(name, B, H, W, reps, device, rows)
        if which == "fusedblk":
            extra["fused_max_abs_diff"] = fusedblk_set(name, B, H, W, reps,
                                                       device, rows)
    if which == "train":
        train_set(name, B, reps, device, rows)
    rows.sort(key=lambda r: -r["ms_per_pass"])
    out = {"model": name, "batch": B, "reps": reps, "set": which,
           "latent": [H // 16, W // 16],
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "modules": rows, **extra}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
