#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mlic_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the five CUDA kernels from ``mlic_tpu_torch/csrc`` (one nvcc per
   source, in parallel);
3. path 1, the serving path: three requests of MLICPP_S at full width --
   seeded random weights, bf16 transforms, batches of 8 seeded 768x512
   frames, 512 rANS lanes, stream format v4 -- through ``Codec.update``,
   ``Codec.compress`` and ``Codec.decompress``, asserting that the
   decoder's y_hat and x_hat are bit-identical to the encoder's, and that
   K1-K4 were launched on that path (K5 is off there);
4. times more requests whole and, alternately, by the stages that
   ``Codec.compress``/``decompress`` record (median, min, max of each),
   and profiles one more compress and decompress (device busy time, idle
   share against the median whole time, top ops by device time);
5. path 2, the file-based evaluation path: the same model under the
   ``bfloat16_mixed`` policy with ``MLIC_FUSED_BLOCKS=1`` through
   ``mlic_tpu_torch.eval.evaluate_codec`` into a temporary directory --
   four dead-leaves frames of 512x768 and one cropped to 500x750 (the
   pad-and-crop path) -- asserting what ``evaluate_codec`` asserts (the
   decoder's x_hat bit-identical to the encoder's, read back from the
   file), finite bpp, PSNR and MS-SSIM, 20 launches of K5 per image and
   launches of K1-K4;
6. g_a and g_s at the serving size with the fused tail off and on, under
   ``float32`` and ``bfloat16_mixed``: difference and median times;
7. holds every kernel against its plain PyTorch version on the card:
   K1-K4 on a payload with the codec's shapes and 3% escapes (exact
   equality), K4 also on seeded states and tables in both modes at 16,
   256, 512 and 1024 lanes (clusters of 1, 4, 8 and 8 blocks; timed), K5
   at every shape of the path, at a ragged size and at other widths, in
   f32 and bf16 (within the stated tolerance, and both against a float64
   evaluation: in bf16 the kernel's error may be at most twice the plain
   version's); times kernel, plain version and, for the row select,
   ``table[row]``; K5's shared-memory plan must take every width of the
   configurations, and a width that cannot fit a block must raise, in the
   wrapper and in the C entry point;
8. round-trips at 16 and 1024 lanes, and checks the f32 analysis
   transform on the card against the CPU on a small input;
9. prints one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

Exits non-zero, before printing any result, without CUDA or without the
repository beside it; any failed phase raises, and no kernel failure is
caught to carry on without the kernel.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
MODEL = "MLICPP_S"
BATCH, HEIGHT, WIDTH = 8, 512, 768
N_LANES = 512
N_REQUESTS = 3
STAGE_REQUESTS = 7
ESC_SHARE = 0.03
EVAL_FRAMES = 4                 # full 512x768 frames on path 2, plus a crop
EVAL_CROP = (500, 750)
K5_PER_IMAGE = 20               # 6 in g_a, 7 in g_s at compress and decompress
FUSED_SWITCH = "MLIC_FUSED_BLOCKS"
# K5 against its plain version: |k - p| <= tol * (1 + |p|), the tolerances
# of the same comparison on the JAX side.  f32: the two sum the same
# products in different orders.  bf16: they round at the same points, so a
# different sum order moves a result by one bf16 step (2^-8 relative) where
# a sum lies near a rounding boundary, and a few such steps compound.
K5_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
# operations/s outside the tensor cores, bf16 operations/s in them.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
# Operations per CDF evaluation: a dozen float ops around erfcf, which the
# CUDA math library computes in about 25 more.
CDF_OPS = 36
# K4 against its plain version on seeded inputs: (lanes, images, steps).
K4_LANE_CASES = ((16, 3, 20), (256, 4, 12), (512, 2, 12), (1024, 2, 12))
KERNEL_SYMBOLS = {"select_rows": "select_rows_kernel",
                  "eval_cdf": "eval_cdf_kernel",
                  "rans_encode_scan": "rans_encode_kernel",
                  "rans_decode_phase": "rans_decode_kernel",
                  "fused_block_tail": "fused_block_tail_"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, symbol: str, reps: int = 5) -> float:
    """Device time of the CUDA kernel named ``symbol`` per call of ``fn``,
    from ``torch.profiler`` (launch overhead on the host excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if symbol in e.key)
    return us / 1e3 / reps


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def bound(nbytes: float, ops: float, peak_ops: float = F32_OPS):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve(codec, frames):
    """The main path: compress -> decompress per request, bit-exact y_hat."""
    import torch
    rows = []
    for r, x in enumerate(frames):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            n = int((enc["y_hat"] != dec["y_hat"]).sum())
            raise AssertionError(f"request {r}: y_hat differs at {n} entries")
        x_hat = dec["x_hat"]
        if not torch.equal(enc["x_hat"], x_hat):
            raise AssertionError(f"request {r}: decoder x_hat differs from "
                                 "the encoder's")
        if tuple(x_hat.shape) != (BATCH, HEIGHT, WIDTH, 3) \
                or not bool(torch.isfinite(x_hat).all()):
            raise AssertionError(f"request {r}: bad x_hat {tuple(x_hat.shape)}")
        n_bytes = sum(len(s) for s in enc["strings"][0])
        n_esc = sum(int(np.frombuffer(s[8:12], np.uint32)[0])
                    for s in enc["strings"][0])
        zh, zw = enc["shape"]
        n_sym = enc["y_hat"].numel() + BATCH * zh * zw * codec.model.cfg.N
        rows.append({"request": r, "bpp": 8.0 * n_bytes / (BATCH * HEIGHT * WIDTH),
                     "escape_share": n_esc / n_sym,
                     "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        print(json.dumps(rows[-1]), flush=True)
        if r == 0:
            x_ref = codec.model.synthesize(enc["y_hat"])
            if not torch.equal(x_ref, x_hat):
                raise AssertionError("x_hat != g_s(encoder y_hat)")
    return rows


def stage_times(codec, frames) -> dict:
    """Where a request's time goes: STAGE_REQUESTS requests timed whole
    (no synchronize inside), each followed by one whose ``compress`` and
    ``decompress`` record their own stages (a synchronize after each).
    Prints median, min and max of both; returns the whole medians."""
    import torch
    whole = {"compress": [], "decompress": []}
    stages = {}
    for r in range(STAGE_REQUESTS):
        x = frames[r % len(frames)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        whole["compress"].append((t1 - t0) * 1e3)
        whole["decompress"].append((time.perf_counter() - t1) * 1e3)
        marks = {"compress": {}, "decompress": {}}
        enc = codec.compress(x, timings=marks["compress"])
        dec = codec.decompress(enc["strings"], enc["shape"],
                               timings=marks["decompress"])
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            raise AssertionError(f"staged request {r}: y_hat differs")
        for phase, t in marks.items():
            for name, ms in t.items():
                stages.setdefault(f"{phase}.{name}", []).append(ms)

    def stats(v):
        return {"median": float(np.median(v)), "min": min(v), "max": max(v)}
    print(json.dumps({"stage_split": {
        "requests": STAGE_REQUESTS,
        "whole_ms": {k: stats(v) for k, v in whole.items()},
        "stages_ms": {k: stats(v) for k, v in stages.items()}}}), flush=True)
    return {k: float(np.median(v)) for k, v in whole.items()}


def profile_request(codec, x, wall_ms: dict, top: int = 8):
    """Device busy time of one compress and one decompress under
    ``torch.profiler`` (kernels, copies and sets on the card), the idle
    share against the median unprofiled wall time of the same phase, and
    the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    enc = None
    for phase in ("compress", "decompress"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if phase == "compress":
                enc = codec.compress(x)
            else:
                codec.decompress(enc["strings"], enc["shape"])
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(r[0] for r in rows)
        wall = wall_ms[phase]
        ours = {name: [sum(r[0] for r in rows if sym in r[2]),
                       sum(r[1] for r in rows if sym in r[2])]
                for name, sym in KERNEL_SYMBOLS.items()}
        out[phase] = {"device_busy_ms": busy, "unprofiled_wall_ms": wall,
                      "idle_share": 1.0 - busy / wall,
                      "kernel_launches": sum(r[1] for r in rows),
                      "port_kernels_ms_launches": ours,
                      "top": [[k[:70], ms, n] for ms, n, k in rows[:top]]}
    print(json.dumps({"profile": out}), flush=True)


def make_payload(codec, rng):
    """Symbols and scale indexes with the codec's shapes (10 y phases of
    32x24x32 per image, z of 8x12x96) and ESC_SHARE escapes."""
    from mlic_tpu_torch.entropy.cdf import get_scale_table
    cfg = codec.model.cfg
    mv = codec.tables["max_value"].cpu().numpy().astype(np.int64)
    off = codec.tables["offsets"].cpu().numpy().astype(np.int64)
    n_phases = 2 * cfg.slice_num
    n_per = (HEIGHT // 16) * (WIDTH // 32) * cfg.slice_ch
    idx = rng.integers(0, 64, (BATCH, n_phases * n_per))
    sym = np.rint(rng.standard_normal(idx.shape) * get_scale_table()[idx])
    sym = np.clip(sym, off[idx], off[idx] + mv[idx] - 1)
    esc = rng.random(idx.shape) < ESC_SHARE
    big = mv[idx] // 2 + 1 + rng.integers(0, 1000, idx.shape)
    sym = np.where(esc, rng.choice([-1, 1], idx.shape) * big, sym)
    n_z = (HEIGHT // 64) * (WIDTH // 64) * cfg.N
    zr = codec.z_rows_base + np.arange(n_z) % cfg.N
    z = off[zr] + rng.integers(0, mv[zr], (BATCH, n_z))
    zesc = rng.random(z.shape) < ESC_SHARE
    z = np.where(zesc, off[zr] - 1 - rng.integers(0, 100, z.shape), z)
    return sym.astype(np.int32), idx.astype(np.int32), z.astype(np.int32)


def check_kernels(codec, counts):
    """Every kernel against its plain version on the payload; timings."""
    import torch

    from mlic_tpu_torch.codec import encode_inputs_v4
    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.parametric import eval_cdf, eval_cdf_plain
    from mlic_tpu_torch.entropy.stream import assemble_streams, parse_global
    from mlic_tpu_torch.ops.select_rows import select_rows, select_rows_plain

    dev = codec.device
    cfg = codec.model.cfg
    tables = codec.tables
    rp = tables["row_params"]
    n_phases = 2 * cfg.slice_num
    sym_np, idx_np, z_np = make_payload(codec, np.random.default_rng(SEED + 1))
    sym, idx, z = (torch.from_numpy(a).to(dev) for a in (sym_np, idx_np, z_np))
    out = []

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, ops,
              library_ms, shape, call):
        bms, by = bound(nbytes, ops)
        symbol = KERNEL_SYMBOLS[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"mlic_tpu_torch/csrc/{source}",
                    "replaces": replaces, "launches": counts[name],
                    "status": "exact" if err == 0.0 else "differs",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
                    "kernel_ms": kernel_ms(call, symbol), "shape": shape})
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")

    # K1 at the decoder's per-phase shape: [steps, B*n_lanes] rows.
    rows = dr.phase_order(idx[:, :idx.shape[1] // n_phases], N_LANES,
                          rp.shape[0] - 1).contiguous()
    got, ref = select_rows(rows, rp), select_rows_plain(rows, rp)
    n = rows.numel()
    entry("select_rows", "select_rows.cu", "mlic_tpu/ops/pallas_select.py:93",
          max_abs_err([(got, ref)]), cuda_ms(lambda: select_rows(rows, rp), 50),
          cuda_ms(lambda: select_rows_plain(rows, rp), 10),
          4 * n + 4 * 6 * n + rp.numel() * 4, 0,
          cuda_ms(lambda: rp[rows.long()], 50), list(rows.shape),
          lambda: select_rows(rows, rp))

    # K2 as the encoder uses it: slot and slot+1 over the whole y payload.
    m, b, A, C, Bc, Lf = select_rows(idx, rp)
    L = Lf.to(torch.int32)
    v = sym - (-((L - 1) >> 1))
    slot = torch.where((v < 0) | (v >= L), L, v)
    k = torch.stack([slot, slot + 1]).contiguous()
    got, ref = eval_cdf(k, m, b, A, C, Bc), eval_cdf_plain(k, m, b, A, C, Bc)
    n = sym.numel()
    entry("eval_cdf", "eval_cdf.cu", "mlic_tpu/entropy/parametric.py:93",
          max_abs_err([(got, ref)]), cuda_ms(lambda: eval_cdf(k, m, b, A, C, Bc), 20),
          cuda_ms(lambda: eval_cdf_plain(k, m, b, A, C, Bc), 5),
          8 * n + 20 * n + 8 * n, 2 * n * CDF_OPS, None, list(k.shape),
          lambda: eval_cdf(k, m, b, A, C, Bc))

    # K3 over the whole stream of the batch.
    start16, freqm1, esc, sym_steps = encode_inputs_v4(
        sym, idx, z, tables, N_LANES, n_phases, codec.z_rows_base)
    got = dr.rans_encode_scan(start16, freqm1)
    ref = dr.rans_encode_scan_plain(start16, freqm1)
    P = start16.numel()
    entry("rans_encode_scan", "rans_encode.cu",
          "mlic_tpu/entropy/device_rans.py:525",
          max_abs_err([(g, r) for g, r in zip(got, ref)]),
          cuda_ms(lambda: dr.rans_encode_scan(start16, freqm1), 10),
          cuda_ms(lambda: dr.rans_encode_scan_plain(start16, freqm1), 1),
          7 * P + 8 * start16.shape[1], 10 * P, None, list(start16.shape),
          lambda: dr.rans_encode_scan(start16, freqm1))
    comp = dr.compact_streams_global(*got, esc, sym_steps, BATCH)
    streams = assemble_streams(comp, N_LANES)

    # K4 phase by phase over those streams: kernel and plain on the same
    # carry, then the escape patch; the symbols must come back.
    parsed = [parse_global(s) for s in streams]
    words = torch.from_numpy(np.concatenate([p[1] for p in parsed])
                             .view(np.int16)).to(dev)
    img_begin = torch.tensor(np.cumsum([0] + [len(p[1]) for p in parsed[:-1]]),
                             dtype=torch.int32, device=dev)
    esc_vals = torch.from_numpy(np.concatenate([p[2] for p in parsed])).to(dev)
    esc_begin = torch.tensor(np.cumsum([0] + [len(p[2]) for p in parsed[:-1]]),
                             dtype=torch.int32, device=dev)
    x, ptr = dr.rans_init_global(words, img_begin, N_LANES)
    esc_count = torch.zeros_like(esc_begin)
    n_z_steps = -(-z.shape[1] // N_LANES)
    n_per_steps = -(-(idx.shape[1] // n_phases) // N_LANES)
    decoded, err, timed = [], 0.0, None
    ordered_idx = [dr.phase_order(
        idx[:, k * (idx.shape[1] // n_phases):(k + 1) * (idx.shape[1] // n_phases)],
        N_LANES, rp.shape[0] - 1).contiguous() for k in range(n_phases)]
    z_rows = dr.phase_order(
        (codec.z_rows_base + torch.arange(z.shape[1], device=dev,
                                          dtype=torch.int32) % cfg.N)
        [None].expand(BATCH, -1), N_LANES, codec.z_rows_base - 1).contiguous()
    for k in range(n_phases + 1):
        if k == 0:
            kw = dict(rows=z_rows, cdf_rows=tables["cdf_rows"],
                      max_value=tables["max_value"], offsets=tables["offsets"])
            steps = codec.z_steps_row
        else:
            kw = dict(cols=select_rows(ordered_idx[k - 1], rp))
            steps = codec.n_steps
        got = dr.rans_decode_phase(words, x, ptr, N_LANES, steps, **kw)
        ref = dr.rans_decode_phase_plain(words, x, ptr, N_LANES, steps, **kw)
        err = max(err, max_abs_err([(g, r) for g, r in zip(got, ref)]))
        if k == 1:
            call = functools.partial(dr.rans_decode_phase, words, x, ptr,
                                     N_LANES, steps, **kw)
            timed = (cuda_ms(call, 10), cuda_ms(functools.partial(
                dr.rans_decode_phase_plain, words, x, ptr, N_LANES, steps,
                **kw), 1), kw["cols"], got, ptr, call)
        sym_k, esc_count = dr.patch_escapes(got[0], got[1], esc_count,
                                            esc_vals, esc_begin, N_LANES)
        decoded.append(sym_k)
        x, ptr = got[2], got[3]
    if not torch.equal(torch.cat(decoded), sym_steps.reshape(-1)):
        raise AssertionError("decoded payload differs from the encoded one")
    ms, plain_ms, cols, got1, ptr0, call = timed
    P = cols.shape[1] * cols.shape[2]
    consumed = int((got1[3] - ptr0).sum())
    Lrow = cols[5].to(torch.int64).clamp(min=1)
    evals = float(torch.floor(torch.log2(Lrow.double())).sum())
    entry("rans_decode_phase", "rans_decode.cu",
          "mlic_tpu/entropy/device_rans.py:169", err, ms, plain_ms,
          24 * P + 5 * P + 2 * consumed + 16 * cols.shape[2] + 8 * BATCH,
          evals * CDF_OPS + 20 * P, None, list(cols.shape), call)
    if n_z_steps + n_phases * n_per_steps != start16.shape[0]:
        raise AssertionError("stream steps differ from the codec's layout")
    return out


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check_decode_lanes(codec):
    """K4 against its plain version, exact, in both modes, on seeded
    states, words and table rows at each of K4_LANE_CASES: every cluster
    size the codec's lane counts give."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.ops.select_rows import select_rows
    tables = codec.tables
    rp = tables["row_params"]
    rng = np.random.default_rng(SEED + 4)
    rows = []
    for lanes, B, S in K4_LANE_CASES:
        BL = B * lanes
        words = torch.from_numpy(rng.integers(0, 1 << 16, 20 * S * BL)
                                 .astype(np.uint16).view(np.int16)).cuda()
        x = torch.from_numpy(rng.integers(1 << 16, 1 << 32, BL)).cuda()
        ptr = torch.from_numpy((np.arange(B) * 10 * S * lanes)
                               .astype(np.int32)).cuda()
        idx = torch.from_numpy(rng.integers(0, rp.shape[0] - 1, (S, BL))
                               .astype(np.int32)).cuda()
        for mode, kw, steps in (
                ("parametric", dict(cols=select_rows(idx, rp)),
                 codec.n_steps),
                ("rows", dict(rows=idx, cdf_rows=tables["cdf_rows"],
                              max_value=tables["max_value"],
                              offsets=tables["offsets"]),
                 codec.z_steps_row)):
            call = functools.partial(dr.rans_decode_phase, words, x, ptr,
                                     lanes, steps, **kw)
            got = call()
            ref = dr.rans_decode_phase_plain(words, x, ptr, lanes, steps,
                                             **kw)
            exact = all(torch.equal(g, r) for g, r in zip(got, ref))
            rows.append({"lanes": lanes, "images": B, "steps": S,
                         "mode": mode,
                         "threads_per_lane": dr.decode_group(lanes),
                         "blocks_per_image": dr.decode_blocks_per_image(
                             lanes), "exact": exact,
                         "ms": cuda_ms(call, 10)})
            if not exact:
                print(json.dumps({"rans_decode_lanes": rows}), flush=True)
                raise AssertionError(f"K4 differs from its plain version at "
                                     f"{lanes} lanes ({mode})")
    print(json.dumps({"rans_decode_lanes": rows}), flush=True)


def eval_path(state) -> dict:
    """Path 2: the file-based evaluation entry point at full width, with
    the fused block tail (K5) in g_a and g_s.  Returns its launch counts."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.data.folder import dead_leaves_pool
    from mlic_tpu_torch.eval import evaluate_codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build

    os.environ[FUSED_SWITCH] = "1"
    model = get_model(MODEL, transform_dtype="bfloat16_mixed")
    model.load_state_dict(state)
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    pool = dead_leaves_pool(EVAL_FRAMES, HEIGHT, SEED, width=WIDTH,
                            cache_dir="")
    images = [f.astype(np.float32) / 255.0 for f in pool]
    images.append(images[0][:EVAL_CROP[0], :EVAL_CROP[1]])
    lines = []
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as save_dir:
        # raises unless every decoder x_hat, read back from its file, is
        # bit-identical to the encoder's
        res = evaluate_codec(codec, images, save_dir, log=lines.append)
        files = sorted(os.listdir(save_dir))
    counts = _build.launch_counts()
    print(json.dumps({"eval_path": {
        "model": MODEL, "transform_dtype": "bfloat16_mixed",
        FUSED_SWITCH: "1", "lanes": N_LANES,
        "images": [list(i.shape) for i in images], "files": files,
        "note": "seeded random weights: bpp, PSNR and MS-SSIM measure the "
                "plumbing, not the codec's quality",
        "per_image": lines, "average": res, "launches": counts}}), flush=True)
    if res["n_images"] != len(images) or len(files) != len(images):
        raise AssertionError(f"eval path: {res['n_images']} images, "
                             f"{len(files)} files for {len(images)} inputs")
    bad = [k for k in ("bpp", "psnr", "ms_ssim") if not np.isfinite(res[k])]
    if bad or not res["bpp"] > 0:
        raise AssertionError(f"eval path: not finite: {bad}, bpp {res['bpp']}")
    if counts["fused_block_tail"] != K5_PER_IMAGE * len(images):
        raise AssertionError(
            f"eval path: K5 launched {counts['fused_block_tail']} times, "
            f"expected {K5_PER_IMAGE} per image")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: {missing}")
    # the latent too: decoder y_hat == encoder y_hat on a full frame
    enc = codec.compress(images[0][None])
    dec = codec.decompress(enc["strings"], enc["shape"])
    if not (torch.equal(enc["y_hat"], dec["y_hat"])
            and torch.equal(enc["x_hat"], dec["x_hat"])):
        raise AssertionError("eval path: decoder y_hat or x_hat differs")
    os.environ.pop(FUSED_SWITCH)
    return counts


def fused_against_unfused(state, frames):
    """g_a (through ``analyze``) and g_s (through ``synthesize``) on one
    serving batch with the fused tail off and on: the difference of y and
    of x_hat against the output's scale, and the median time of each, the
    two settings taken in turns (off, on, on, off)."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    x = torch.from_numpy(frames).cuda()
    rows = {}
    for policy, tol in (("float32", 1e-5), ("bfloat16_mixed", 5e-2)):
        model = get_model(MODEL, transform_dtype=policy)
        model.load_state_dict(state)
        model.cuda().eval()
        outs, ms = {}, {}
        with torch.no_grad():
            for switch in ("0", "1", "1", "0") * 3:
                os.environ[FUSED_SWITCH] = switch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, _ = model.analyze(x)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                x_hat = model.synthesize(torch.round(outs.get("y0", y)))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                outs.setdefault("y0", y)       # one latent feeds every g_s
                outs[switch] = (y, x_hat)
                ms.setdefault(switch, []).append(((t1 - t0) * 1e3,
                                                  (t2 - t1) * 1e3))
        os.environ.pop(FUSED_SWITCH)
        row = {"tolerance_of_scale": tol}
        for i, name in enumerate(("y", "x_hat")):
            ref, got = outs["0"][i], outs["1"][i]
            scale = float(ref.abs().max())
            err = float((ref - got).abs().max())
            row[name] = {"max_abs_diff": err, "scale": scale,
                         "of_scale": err / scale}
            # the first round of each setting pays set-up: leave it out
            for switch, key in (("0", "unfused_ms"), ("1", "fused_ms")):
                row[name][key] = float(np.median(
                    [m[i] for m in ms[switch][1:]]))
        rows[policy] = row
    print(json.dumps({"fused_against_unfused": {
        "batch": list(frames.shape), "g_a_through": "analyze (with h_a)",
        "g_s_through": "synthesize", **rows}}), flush=True)
    for policy, row in rows.items():
        for name in ("y", "x_hat"):
            if not row[name]["of_scale"] <= row["tolerance_of_scale"]:
                raise AssertionError(
                    f"fused {name} under {policy} differs from unfused by "
                    f"{row[name]['of_scale']} of its scale")


def _tail_f64(mid, skip, conv, gdn, act):
    """The block tail's formula in float64, nothing rounded."""
    import torch
    import torch.nn.functional as F

    from mlic_tpu_torch.models.layers import _gdn_effective
    d = torch.float64
    g = F.gelu(mid.to(d), approximate="tanh")
    a = F.conv2d(g, conv.dw.depth.weight.to(d), conv.dw.depth.bias.to(d),
                 padding=1, groups=mid.shape[1])
    h = F.conv2d(a, conv.dw.point.weight.to(d), conv.dw.point.bias.to(d))
    if act == "gelu":
        return F.gelu(h, approximate="tanh") + skip.to(d)
    gamma, beta = _gdn_effective(gdn)
    norm = F.conv2d(h * h, gamma.to(d).t()[:, :, None, None], beta.to(d))
    return h * (norm.sqrt() if act == "igdn" else norm.rsqrt()) + skip.to(d)


def check_fused_block(launches: int):
    """K5 against ``fused_block_tail_plain`` on the card at every shape of
    the path at the serving batch, at a ragged size with other widths and
    with C != N, in f32 and bf16; both against float64; times of the
    path's shapes.  Returns K5's entry of the kernels line."""
    import torch

    from mlic_tpu_torch.models import layers as tl
    from mlic_tpu_torch.ops.fused_block import (
        ACTS,
        KERNEL,
        MAX_SMEM,
        fused_block_tail,
        fused_block_tail_plain,
        smem_bytes,
    )

    N = 96
    sizes = ((HEIGHT // 2, WIDTH // 2), (HEIGHT // 4, WIDTH // 4),
             (HEIGHT // 8, WIDTH // 8))
    cases = [(act, BATCH, N, N, h, w, True) for act in ("gdn", "igdn", "gelu")
             for h, w in sizes]
    cases.append(("gelu", BATCH, 160, 160, HEIGHT // 16, WIDTH // 16, True))
    cases.append(("gdn", 1, N, N, HEIGHT // 2, WIDTH // 2, True))
    for act in ("gdn", "igdn", "gelu"):
        cases += [(act, 1, c, n, 37, 53, False) for c, n in
                  ((96, 96), (160, 160), (192, 192), (320, 320), (40, 72),
                   (100, 36))]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    rows, head = [], None
    for act, b, c, n, h, w, on_path in cases:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            conv = tl.Conv3x3(c, n, 1, True, dt).cuda()
            gdn = tl.GDN(n, inverse=act == "igdn",
                         dtype=None if dt == torch.float32 else dt).cuda()
            ped = gdn._OFFSET ** 2
            with torch.no_grad():
                conv.dw.depth.weight.copy_(randn(c, 1, 3, 3, scale=1 / 3))
                conv.dw.depth.bias.copy_(randn(c, scale=0.1))
                conv.dw.point.weight.copy_(randn(n, c, 1, 1, scale=c ** -0.5))
                conv.dw.point.bias.copy_(randn(n, scale=0.1))
                gdn.beta.copy_((1.0 + randn(n).abs() + ped).sqrt())
                gdn.gamma.copy_((0.1 * torch.eye(n, device="cuda")
                                 + 0.02 * randn(n, n).abs() + ped).sqrt())
                mid, skip = randn(b, c, h, w).to(dt), randn(b, n, h, w).to(dt)
                gamma, beta = (None, None) if act == "gelu" else (
                    t.contiguous() for t in tl._gdn_effective(gdn))
                args = (mid, skip, conv.dw.depth.weight, conv.dw.depth.bias,
                        conv.dw.point.weight, conv.dw.point.bias, gamma, beta)
                got = fused_block_tail(*args, act=act)
                torch.cuda.synchronize()
                ref = fused_block_tail_plain(*args, act=act)
                exact = _tail_f64(mid, skip, conv, gdn, act)
                if got.dtype != dt or got.shape != ref.shape:
                    raise AssertionError(f"K5 returned {got.dtype} "
                                         f"{tuple(got.shape)}")
                diff = (got.double() - ref.double()).abs()
                row = {"act": act, "dtype": name, "mid": [b, c, h, w], "N": n,
                       "max_abs_err": float(diff.max()),
                       "err_of_tolerance": float(
                           (diff / (1 + ref.double().abs())).max())
                       / K5_TOL[name],
                       "kernel_vs_f64": float((got.double() - exact)
                                              .abs().max()),
                       "plain_vs_f64": float((ref.double() - exact)
                                             .abs().max())}
                del exact, diff
                if on_path:
                    def unfused(conv=conv, gdn=gdn, mid=mid, skip=skip,
                                act=act):
                        t = conv(tl.gelu(mid))
                        return (tl.gelu(t) if act == "gelu" else gdn(t)) + skip

                    call = functools.partial(fused_block_tail, *args, act=act)
                    pix = b * h * w
                    ops = pix * (2 * c * n + 18 * c
                                 + (0 if act == "gelu" else 2 * n * n))
                    nbytes = (mid.numel() + 2 * skip.numel()) \
                        * mid.element_size() + 4 * sum(
                            t.numel() for t in args[2:] if t is not None)
                    row["bound_ms"], row["bound_by"] = bound(
                        nbytes, ops,
                        F32_OPS if dt == torch.float32 else BF16_OPS)
                    row["ms"] = cuda_ms(call, 10)
                    row["plain_ms"] = cuda_ms(functools.partial(
                        fused_block_tail_plain, *args, act=act), 3)
                    row["unfused_ms"] = cuda_ms(unfused, 5)
                    if head is None and dt == torch.bfloat16:
                        row["kernel_ms"] = kernel_ms(
                            call, KERNEL_SYMBOLS["fused_block_tail"])
                        head = row
                rows.append(row)
                if not (row["err_of_tolerance"] <= 1.0 and (
                        dt == torch.float32 or row["kernel_vs_f64"]
                        <= 2 * row["plain_vs_f64"])):
                    print(json.dumps({"fused_block_tail_checks": rows}),
                          flush=True)
                    raise AssertionError(f"K5 differs from its plain version "
                                         f"beyond tolerance, or errs against "
                                         f"float64 more than twice as much "
                                         f"as the plain version: {row}")
    print(json.dumps({"fused_block_tail_checks": rows,
                      "tolerance": K5_TOL}), flush=True)

    # The kernel's shared-memory plan takes every width the configurations
    # send through the fused tail (models/config.py), C != N too, in both
    # dtypes and all three tails, and two bf16 blocks an SM at C = N = 96.
    plan = {f"{c}x{n}": {f"{act}_{str(dt).split('.')[1]}":
                         smem_bytes(c, n, act, dt) for act in ACTS
                         for dt in (torch.float32, torch.bfloat16)}
            for c, n in ((32, 32), (96, 96), (128, 128), (160, 160),
                         (192, 192), (320, 320), (96, 160), (160, 96))}
    print(json.dumps({"fused_block_tail_smem_bytes": plan,
                      "max": MAX_SMEM}), flush=True)
    if max(v for p in plan.values() for v in p.values()) > MAX_SMEM \
            or 2 * plan["96x96"]["gdn_bfloat16"] > 228 * 1024:
        raise AssertionError("K5's shared-memory plan does not take the "
                             "configurations' widths")
    # A launch that cannot run (its tile needs more shared memory than a
    # block may have) must raise, and must not poison the next launch.
    wide = 4096
    bad = (randn(1, wide, 8, 8), randn(1, wide, 8, 8), randn(wide, 1, 3, 3),
           randn(wide), randn(wide, wide, 1, 1), randn(wide),
           randn(wide, wide), randn(wide))
    try:
        fused_block_tail(*bad, act="gdn")
    except ValueError as e:
        print(json.dumps({"fused_block_tail_refuses": str(e)}), flush=True)
    else:
        raise AssertionError("K5 took a width that cannot fit a block")
    # the C entry point refuses it too, before any launch
    out_bad = torch.empty_like(bad[1])
    try:
        KERNEL.launch(*(t.data_ptr() for t in (bad[0], bad[1], out_bad)),
                      *(t.data_ptr() for t in bad[2:]), 1, wide, wide, 8, 8,
                      ACTS["gdn"], 0, stream_ptr())
    except RuntimeError as e:
        print(json.dumps({"fused_block_tail_launch_refuses": str(e)}),
              flush=True)
    else:
        raise AssertionError("K5's entry point took a width that cannot fit")
    fused_block_tail(*args, act=act)        # the last case again: still runs
    torch.cuda.synchronize()

    return {"name": "fused_block_tail", "route": "cuda",
            "source": "mlic_tpu_torch/csrc/fused_block_tail.cu",
            "replaces": "mlic_tpu/ops/pallas_fused_block.py:148",
            "launches": launches, "status": "within tolerance",
            "tolerance": K5_TOL["bfloat16"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "kernel_ms": head["kernel_ms"], "unfused_ms": head["unfused_ms"],
            "shape": head["mid"], "dtype": head["dtype"], "act": head["act"]}


def check_lane_widths(model, frames):
    """Round trips at other lane counts (a partial warp, the widest block):
    bit-exact y_hat through the kernels."""
    import torch

    from mlic_tpu_torch.codec import Codec
    for lanes, x in ((16, frames[0][:2, :128, :256]), (1024, frames[0])):
        codec = Codec(model, n_lanes=lanes, device="cuda")
        enc = codec.compress(np.ascontiguousarray(x))
        dec = codec.decompress(enc["strings"], enc["shape"])
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            raise AssertionError(f"{lanes} lanes: y_hat differs")
        print(json.dumps({"lanes": lanes, "shape": list(x.shape),
                          "roundtrip": "bit-exact"}), flush=True)


def check_small_reference(state_dict):
    """The f32 analysis transform on the card against the CPU."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    x = np.random.default_rng(SEED + 2).random((1, 64, 128, 3),
                                               dtype=np.float32)
    ys = []
    for dev in ("cpu", "cuda"):
        m = get_model(MODEL, transform_dtype="float32")
        m.load_state_dict(state_dict)
        m.to(dev).eval()
        with torch.no_grad():
            ys.append(m.analyze(torch.from_numpy(x).to(dev))[0].cpu())
    err = float((ys[0] - ys[1]).abs().max())
    scale = float(ys[0].abs().max())
    print(json.dumps({"analyze_f32_cpu_vs_cuda_max_abs_err": err,
                      "y_max_abs": scale}), flush=True)
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"analyze on the card differs from the CPU: {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)       # inference only; K5 has no backward
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.weights import init_params

    card = card_line()
    print(card, flush=True)
    os.environ.pop(FUSED_SWITCH, None)      # path 1 runs the unfused tails
    t0 = time.perf_counter()
    per = _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": per}), flush=True)

    model = get_model(MODEL, transform_dtype="bfloat16")
    state = init_params(model, torch.Generator().manual_seed(SEED))
    model.load_state_dict(state)
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    t0 = time.perf_counter()
    codec.update()          # raises unless both self-checks pass
    print(json.dumps({"update_s": time.perf_counter() - t0}), flush=True)

    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
              for _ in range(N_REQUESTS)]
    _build.reset_launch_counts()
    serve(codec, frames)
    counts = _build.launch_counts()
    print(json.dumps({"launches_on_main_path": counts}), flush=True)
    missing = [k for k, v in counts.items()
               if v <= 0 and k != "fused_block_tail"]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if counts["fused_block_tail"]:
        raise AssertionError("K5 launched on path 1, where its switch is off")

    wall_ms = stage_times(codec, frames)
    profile_request(codec, frames[0], wall_ms)
    eval_counts = eval_path(state)
    fused_against_unfused(state, frames[0])
    kernels = check_kernels(codec, counts)
    kernels.append(check_fused_block(eval_counts["fused_block_tail"]))
    for k in kernels:
        k["launches_by_path"] = {"serve": counts[k["name"]],
                                 "eval": eval_counts[k["name"]]}
    check_decode_lanes(codec)
    check_lane_widths(model, frames)
    check_small_reference(state)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
