"""The yardstick on the CPU: the plain reference against the program in
float32, the benchmark's imports, the kernels' launches, operations and
bytes against hand counts and against the calls the program makes, and
the seeded frames."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench import frames, judge, kernels
from portbench.paths import BENCH
from portbench.reference import mlicpp as ref_mod
from tiny import reference_params, seeded_weights

TINY = {"N": 32, "M": 64, "slice_num": 2, "context_window": 5}
# the program's float32 streams against the reference's estimate at
# 64x128 on seeded weights: rate_gap 0.21-0.36% over three weight seeds and
# two frame seeds
RATE_SOUND = 1.0


def _program(transform_dtype="float32", seed=5):
    from mlic_tpu_torch.models.registry import get_model
    m = get_model("MLICPP_TINY", transform_dtype=transform_dtype)
    sd = seeded_weights(m, seed)
    m.load_state_dict(sd, strict=True)
    ref = ref_mod.MLICPP(reference_params(sd, torch.device("cpu")), TINY)
    return m, ref


def _frames(b=2, h=64, w=128, seed=3):
    return frames.pool({"batch": b, "height": h, "width": w,
                        "pool_batches": 1, "disks": 30}, seed, "cpu")[0]


@torch.no_grad()
def test_reference_is_the_programs_float32_arithmetic():
    """At float32 the reference computes what the program computes, to
    float32 rounding: the latent, z's symbols, the coded y_hat and the
    synthesis (different sums: unfold against shifted correlations, one
    batched call against the program's image-at-a-time products)."""
    from mlic_tpu_torch.codec import Codec
    m, ref = _program()
    x = _frames()
    y_p, z_p = m.analyze(x)
    y_r, z_r = ref.analyze(x)
    assert (y_p.permute(0, 3, 1, 2) - y_r).abs().max() < 1e-5
    z_hat = ref.z_hat(z_r)
    med = ref.medians()[None, :, None, None]
    assert torch.equal(z_hat, z_p.permute(0, 3, 1, 2).float() + med)
    codec = Codec(m, n_lanes=16, device="cpu")
    enc = codec.compress(x)
    y_hat = ref.encode(y_r, z_hat)
    assert (y_hat.permute(0, 2, 3, 1) - enc["y_hat"]).abs().max() < 1e-5
    assert (ref.g_s(y_hat).permute(0, 2, 3, 1) - enc["x_hat"]).abs().max() \
        < 1e-4
    kept = [{"frames": x, "y_enc": enc["y_hat"], "y_dec": enc["y_hat"],
             "x_dec": enc["x_hat"], "z_dec": z_hat,
             "bits": sum(judge.coded_bits(s) for s in enc["strings"][0])}]
    got = judge.judge(kept, ref)
    assert got["y_roundtrip"] == 0 and got["z_flips"] == 0.0
    assert got["y_flips"] == 0.0 and got["y_gap"] < 1e-5
    assert got["x_gap"] < 1e-4
    assert abs(got["rate_gap"]) < RATE_SOUND


@torch.no_grad()
def test_follow_recovers_the_symbols():
    """Rebuilt from a coded y_hat, the reference finds the encoder's
    symbols and values; one symbol moved by one moves the rebuilt value
    with it, so the comparison with the analysis sees it."""
    _, ref = _program()
    y, z = ref.analyze(_frames())
    z_hat = ref.z_hat(z)
    y_hat = ref.encode(y, z_hat)
    again, flips, count, _ = ref.follow(y_hat, z_hat, y)
    assert int(flips) == 0 and count == y.numel()
    assert (again - y_hat).abs().max() < 1e-5
    moved = y_hat.clone()
    moved[0, 3, 2, 5] += 1.0
    _, flips, _, _ = ref.follow(moved, z_hat, y)
    assert int(flips) >= 1


@torch.no_grad()
def test_estimated_bits_are_the_programs_likelihoods():
    """The reference's rate estimate is the program's own entropy models
    at float32: z's bits under the factorized prior and the symbols' under
    the Gaussians of their scales, to float32 rounding."""
    from mlic_tpu_torch.entropy.models import gaussian_likelihood
    m, ref = _program()
    y, z = ref.analyze(_frames())
    z_hat = ref.z_hat(z)
    _, lk = m.entropy_bottleneck(z_hat, training=False)
    want = float(-torch.log2(lk).sum())
    assert abs(ref.z_bits(z_hat) - want) <= 1e-4 * want
    gen = torch.Generator().manual_seed(3)
    sym = torch.round(3.0 * torch.randn(2, 8, 4, 4, generator=gen))
    sc = torch.rand(2, 8, 4, 4, generator=gen) * 4.0
    sc[0, 0] = 0.01                                  # under the bound
    mu = torch.randn(2, 8, 4, 4, generator=gen)
    want = float(-torch.log2(gaussian_likelihood(sym + mu, sc, mu)).sum())
    assert abs(ref.y_bits(sym, sc) - want) <= 1e-4 * want


def test_rows_are_the_coders():
    """The reference's rows are the program's coder's: the row a scale
    takes (the smallest of the 64 scales that holds it), each row's width
    and center, and its 16-bit frequencies to one count (the two spread
    what rounding leaves differently: the program over the largest
    remainders, the reference on the center)."""
    from mlic_tpu_torch.entropy.cdf import get_scale_table
    from mlic_tpu_torch.entropy.models import (GaussianConditionalTables,
                                               build_indexes)
    table = torch.tensor(get_scale_table(), dtype=torch.float32)
    assert torch.equal(table, torch.tensor(ref_mod.SCALE_TABLE,
                                           dtype=torch.float32))
    sc = torch.cat([torch.logspace(-3, 3, 500), table, torch.tensor(
        [0.0, 0.11, 300.0])])
    assert torch.equal(ref_mod.MLICPP.table_row(sc),
                       build_indexes(sc, table).long())
    prog = GaussianConditionalTables.create()
    bits, width, center = ref_mod.gaussian_rows("cpu")
    assert width.tolist() == (prog.cdf_length - 2).tolist()
    assert center.tolist() == (-prog.offset).tolist()
    for r in range(64):
        n = int(width[r]) + 1
        want = torch.from_numpy(np.diff(prog.quantized_cdf[r, :n + 1]))
        got = torch.round(2.0 ** (16 - bits[r, :n])).long()
        off = (got - want).abs()
        off[int(center[r])] = 0
        assert int(off.max()) <= 1, r


def test_precision_helpers():
    one = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.5,
                        1.0 + 2.0 ** -10])
    assert ref_mod.tf32(one).tolist() == [1.0, 1.0 + 2.0 ** -9, -1.5,
                                          1.0 + 2.0 ** -10]
    t = torch.tensor([0.0, 1.0, -448.0, 0.3])
    q = ref_mod.fp8(t)
    assert q[0] == 0.0 and q[2] == -448.0 and q[1] == 1.0
    assert abs(float(q[3]) - 0.3) <= 0.3 / 16


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


def test_benchmark_imports_no_jax_side():
    """No module under ``portbench/`` imports ``jax``, ``jaxlib``,
    ``flax`` or ``mlic_tpu`` (top-level names compared whole: the port's
    ``mlic_tpu_torch`` begins with ``mlic_tpu``), and the reference
    imports nothing of the program either."""
    seen = 0
    for d, _, names in os.walk(BENCH):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(d, n)
            banned = {"jax", "jaxlib", "flax", "mlic_tpu"}
            if os.sep + "reference" + os.sep in path:
                banned.add("mlic_tpu_torch")
            found = set(_imports(path)) & banned
            assert not found, (path, found)
            seen += 1
    assert seen >= 20


def test_k8_launches_are_the_programs_calls():
    """``kernels.k8_problems`` lists, in each direction, the products the
    program hands K8's four entry points (captured on the CPU, where they
    run as plain versions), with the same groups, (M, N, K) and bytes."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.ops import invariant_matmul as im
    m, _ = _program("bfloat16")
    b, h, w = 2, 64, 128
    x = _frames(b, h, w)
    codec = Codec(m, n_lanes=16, device="cpu", encode_recon=False)
    codec.update()
    calls, where = [], ["compress"]
    orig = {n: getattr(im, n) for n in ("linear", "kt_v", "ctx_q",
                                        "conv2d")}

    def wrap(name):
        def f(*a, **k):
            calls.append((where[0], name, a))
            return orig[name](*a, **k)
        return f
    with pytest.MonkeyPatch.context() as mp:
        for n in orig:
            mp.setattr(im, n, wrap(n))
        enc = codec.compress(x)
        where[0] = "decompress"
        codec.decompress(enc["strings"], enc["shape"])

    def shape(name, a):
        es = a[0].element_size()
        if name == "linear":
            g, k, n = a[0].shape[0], a[0].shape[-1], a[1].shape[0]
            mm = a[0][0].numel() // k
        elif name == "kt_v":
            g, mm, n, k = (a[0].shape[0] * a[0].shape[2], a[0].shape[3],
                           a[1].shape[3], a[0].shape[1])
        elif name == "ctx_q":
            g, mm, n, k = (a[1].shape[0] * a[1].shape[2], a[1].shape[1],
                           a[0].shape[3], a[1].shape[3])
        else:
            s = a[3] if len(a) > 3 else 1
            g, n, win = a[0].shape[0], a[1].shape[0], a[1].shape[-1]
            mm = ((a[0].shape[2] - 1) // s + 1) * ((a[0].shape[3] - 1)
                                                   // s + 1)
            k = a[0].shape[1] * win * win
        nbytes = (a[0].numel() + a[1].numel() + g * mm * n) * es
        if len(a) > 2 and a[2] is not None:
            nbytes += a[2].numel() * es
        return g, (mm, n, k), nbytes
    for d in ("compress", "decompress"):
        got = [shape(n, a) for dd, n, a in calls if dd == d]
        want = [(p["groups"], p["mnk"], p["bytes"])
                for p in kernels.k8_problems(TINY, b, h, w, d)]
        assert got == want, d


def test_kernel_counts_by_hand():
    """One shape each, counted by hand: the window fusion of MLICPP_S at
    768x512, batch 128, and the rANS launches of a tiny batch."""
    s = {"N": 96, "M": 160, "slice_num": 5}
    fusion = kernels.k8_problems(s, 128, 512, 768, "decompress")[0]
    assert fusion["mnk"] == (1536, 64, 800) and fusion["groups"] == 128
    assert fusion["ops"] == 2.0 * 128 * 1536 * 64 * 800
    assert fusion["bytes"] == 4 * (128 * 1536 * 800 + 64 * 800
                                   + 128 * 1536 * 64 + 64)
    assert len(kernels.k8_problems(s, 8, 512, 768, "compress")) == 31
    assert len(kernels.k8_problems(s, 8, 512, 768, "decompress")) == 29
    lau = kernels.rans_launches(TINY, 2, 64, 64, 16, words=1000,
                                escapes=3)
    # n_z 32, n_y 1024 an image; a phase 256 symbols: 2 + 4 x 16 = 66
    # steps of 32 lanes (two images of 16), one mask word a lane group
    assert lau[0] == ("rans_encode_prep", 17 * 2048 + 13 * 64,
                      2.0 * 2048 * 36)
    assert lau[1] == ("rans_encode_scan", 8 * 2112 + 2 * 66 * 32
                      + 4 * 66 * 2 + 8 * 32, 10.0 * 66 * 32)
    assert lau[2] == ("rans_encode_compact", 4 * 66 * 2 + 2 * (1000 - 64)
                      + 2112 + 12 + 8 * 32 + 2 * 1000 + 12 + 16, 0.0)
    assert [n for n, *_ in lau[3:]] == ["rans_decode_phase"] * 5
    assert lau[3][1] == 9 * 2 * 32 + 2 * (1000 - 64) + 16 * 32 + 16
    assert lau[4] == ("rans_decode_phase", 9 * 16 * 32 + 16 * 32 + 16,
                      20.0 * 16 * 32)
    assert kernels.least_s(3.35e12, 0.0) == 1.0
    assert kernels.least_s(0.0, 67e12) == 1.0


def test_frames_follow_the_seed():
    mix = {"batch": 3, "height": 64, "width": 96, "pool_batches": 2,
           "disks": 40}
    a = frames.pool(mix, 2**31 + 77, "cpu")
    b = frames.pool(mix, 2**31 + 77, "cpu")
    c = frames.pool(mix, 2**31 + 78, "cpu")
    assert a.shape == (2, 3, 64, 96, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    assert int(a.max()) - int(a.min()) > 100
