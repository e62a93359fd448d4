#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mlic_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the four CUDA kernels from ``mlic_tpu_torch/csrc`` (one nvcc per
   source, in parallel);
3. serves three requests of MLICPP_S at full width -- seeded random
   weights, bf16 transforms, batches of 8 seeded 768x512 frames, 512 rANS
   lanes, stream format v4 -- through ``Codec.update``, ``Codec.compress``
   and ``Codec.decompress``, asserting that the decoder's y_hat is
   bit-identical to the encoder's and x_hat == g_s(y_hat), and that every
   kernel was launched on that path;
4. times more requests whole and, alternately, by the stages that
   ``Codec.compress``/``decompress`` record (median, min, max of each),
   and profiles one more compress and decompress (device busy time, idle
   share against the median whole time, top ops by device time);
5. holds every kernel against its plain PyTorch version on the card, on a
   payload with the codec's shapes and 3% escapes (exact equality), and
   times kernel, plain version and, for the row select, ``table[row]``;
6. round-trips at 16 and 1024 lanes, and checks the f32 analysis
   transform on the card against the CPU on a small input;
7. prints one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

Exits non-zero, before printing any result, without CUDA or without the
repository beside it; any failed phase raises.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
MODEL = "MLICPP_S"
BATCH, HEIGHT, WIDTH = 8, 512, 768
N_LANES = 512
N_REQUESTS = 3
STAGE_REQUESTS = 7
ESC_SHARE = 0.03
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12
# Operations per CDF evaluation: a dozen float ops around erfcf, which the
# CUDA math library computes in about 25 more.
CDF_OPS = 36
KERNEL_SYMBOLS = {"select_rows": "select_rows_kernel",
                  "eval_cdf": "eval_cdf_kernel",
                  "rans_encode_scan": "rans_encode_kernel",
                  "rans_decode_phase": "rans_decode_kernel"}


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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
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
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.weights import init_params

    card = card_line()
    print(card, flush=True)
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
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    wall_ms = stage_times(codec, frames)
    profile_request(codec, frames[0], wall_ms)
    kernels = check_kernels(codec, counts)
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
