"""The entropy path's batch-invariant products (``ops/invariant_matmul``,
kernel K8 on the card) and the codec's batch contract, on the CPU.

The plain version of each product (the PyTorch op an image at a time)
equals the batched op it replaces and gives an image's rows bit for bit at
every batch; the dispatch takes the plain version on the CPU and the
batched op where a gradient is recorded, and launches no kernel; a batch
coded together gives each image's alone-coded y and z strings (the JAX
package's ``test_batched_codec_matches_single``) on the device and steps
backends.  MLICPP_TINY at 64x64: y is 4x4 with slices of 32 channels.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.ops import _build
from mlic_tpu_torch.ops import invariant_matmul as im
from mlic_tpu_torch.tools import batch_contract
from mlic_tpu_torch.weights import init_params

B, L, C = 5, 16, 32          # batch, positions of TINY's 4x4 y, slice width


def _t(*shape, seed=0):
    g = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


def _cases():
    """(name, product, batched op, inputs): the shapes of the context
    modules at MLICPP_TINY, batch B."""
    w_f, b_f = _t(2 * C, 25 * C) * 0.05, _t(2 * C)
    w5, b5 = _t(3 * C, C, 5, 5) * 0.05, _t(3 * C)
    w1, b1 = _t(2 * C, C, 1, 1) * 0.1, _t(2 * C)
    w3 = _t(C, C, 3, 3) * 0.1
    k = torch.softmax(_t(B, L, 2, 16), 1)
    v, q = _t(B, L, 2, 16, seed=1), torch.softmax(_t(B, L, 2, 16, seed=2), 3)
    ctx = _t(B, 2, 16, 16, seed=3)
    x = _t(B, C, 4, 4, seed=4)
    return [
        ("fusion", lambda a: im.linear(a, w_f, b_f),
         lambda a: F.linear(a, w_f, b_f), (_t(B, L, 25 * C, seed=5),)),
        ("kt_v", im.kt_v,
         lambda a, b: torch.einsum("bnhd,bnhe->bhde", a, b), (k, v)),
        ("ctx_q", im.ctx_q,
         lambda a, b: torch.einsum("bhde,bnhd->bnhe", a, b), (ctx, q)),
        ("conv5x5", lambda a: im.conv2d(a, w5, b5),
         lambda a: F.conv2d(a, w5, b5, 1, 2), (x,)),
        ("conv5x5_nhwc_view", lambda a: im.conv2d(a, w5, b5),
         lambda a: F.conv2d(a, w5, b5, 1, 2),
         (x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),)),
        ("conv1x1", lambda a: im.conv2d(a, w1, b1),
         lambda a: F.conv2d(a, w1, b1), (x,)),
        ("conv3x3_no_bias", lambda a: im.conv2d(a, w3),
         lambda a: F.conv2d(a, w3, None, 1, 1), (x,)),
        ("conv3x3_stride2", lambda a: im.conv2d(a, w3, None, 2),
         lambda a: F.conv2d(a, w3, None, 2, 1), (x,)),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_equals_batched_op(case):
    """To 1e-6 of the output's largest magnitude: the two sum the same f32
    products (at most 800 a output here) in other orders."""
    _, product, op, xs = case
    with torch.no_grad():
        got, want = product(*xs), op(*xs)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_rows_are_batch_invariant(case):
    _, product, _, xs = case
    with torch.no_grad():
        full = product(*xs)
        for b in (1, 3):
            part = product(*(x[:b] for x in xs))
            assert torch.equal(part, full[:b])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dispatch_plain_on_cpu_batched_with_gradient(case, monkeypatch):
    _, product, op, xs = case
    sizes = []
    for name in ("linear", "einsum", "conv2d"):
        mod = torch if name == "einsum" else F
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, **k):
            sizes.append(a[1].shape[0] if isinstance(a[0], str)
                         else a[0].shape[0])
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    before = _build.launch_counts()
    with torch.no_grad():
        assert im.route(*xs) == "plain"
        product(*xs)
    assert sizes == [1] * B                  # an image at a time
    sizes.clear()
    grads = [x.clone().requires_grad_() for x in xs]
    out = product(*grads)
    assert im.route(*grads) == "batched" and out.requires_grad
    assert sizes == [B]                      # one call a batch
    assert _build.launch_counts() == before  # no kernel launched


def test_kernel_route_never_falls_back():
    """Asked for K8, a CPU tensor raises instead of taking the plain
    version; the meta device of a FLOP count takes the batched op."""
    x = _t(B, L, 8)
    w = _t(4, 8)
    with torch.no_grad():
        old, im.ROUTE = im.ROUTE, "kernel"
        try:
            with pytest.raises(ValueError, match="CUDA device"):
                im.linear(x, w)
        finally:
            im.ROUTE = old
        assert im.route(x.to("meta")) == "batched"
        assert im.linear(x.to("meta"), w.to("meta")).shape == (B, L, 4)


def test_kernel_source_is_its_own_cuda():
    """K8 computes its products itself, on the CUDA cores: no library
    product, no tensor cores, no atomics, a plain C entry point."""
    src = (_build.CSRC / "invariant_matmul.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for banned in ("cublas", "cudnn", "cutlass", "torch", "triton", "atomic",
                   "mma", "wmma", "tf32"):
        assert banned not in code.lower(), banned
    for needed in ("__global__", 'extern "C"', "fmaf", "cudaGetLastError",
                   "count_device_launch", "MLIC_DEVICE_LAUNCH_COUNTER"):
        assert needed in code, needed
    k8 = _build.KERNELS["invariant_matmul"]
    assert k8.source == "invariant_matmul.cu" and k8.symbol in code


def test_oracle_is_declared_and_only_the_smoke_run_calls_it():
    """K8's chain oracle is a second C entry point of its source, declared
    in ``_build.ORACLES`` and not counted on the device; no module of the
    package but ``_build`` names it, and chip_smoke.py holds K8 to it."""
    sym, argtypes = _build.ORACLES["invariant_matmul"]
    assert argtypes == _build.KERNELS["invariant_matmul"].argtypes
    src = (_build.CSRC / "invariant_matmul.cu").read_text()
    code = " ".join(" ".join(line.split("//")[0] for line in
                             src.splitlines()).split())
    assert f'extern "C" int {sym}(const Problem* p, void* stream)' in code
    body = code[code.index("__global__ void oracle_kernel("):]
    body = body[:body.index("} } ")]
    assert "fmaf" in body and "count_device_launch" not in body
    pkg = _build.CSRC.parent
    for f in pkg.rglob("*.py"):
        if f != pkg / "ops" / "_build.py":
            text = f.read_text()
            assert sym not in text and "ORACLES" not in text, f
    smoke = (pkg.parent / "chip_smoke.py").read_text()
    assert "_build.ORACLES[" in smoke and "def k8_oracle(" in smoke


@pytest.mark.parametrize("win", [2, 7])
def test_kernel_route_refuses_other_windows(win):
    """K8's gather takes windows of 1, 3 and 5 (a K tile of whole
    channels), a rule kept in one place, the C launch function's
    ``valid`` (a launch it refuses raises in ``Kernel.launch``); asked for
    another window, the kernel route raises, on any device, instead of
    taking the plain version."""
    x, w = _t(1, 4, 6, 6), _t(3, 4, win, win)
    old, im.ROUTE = im.ROUTE, "kernel"
    try:
        with torch.no_grad(), pytest.raises(ValueError):
            im.conv2d(x, w)
    finally:
        im.ROUTE = old
    src = (_build.CSRC / "invariant_matmul.cu").read_text()
    rule = src[src.index("bool valid(const Problem* p)"):]
    rule = rule[:rule.index("\n}\n")]
    assert "(w == 1 || w == 3 || w == 5)" in rule and f"w == {win}" not in rule
    assert not hasattr(im, "WINDOWS")


def test_stream_hash_is_of_every_stream_in_order():
    import chip_smoke
    h = chip_smoke.streams_sha256
    a = {"strings": [[b"ab", b"c"], []]}
    assert h(a) == h({"strings": [[b"ab", b"c"], []]})
    assert h(a) != h({"strings": [[b"a", b"bc"], []]})
    assert h(a) != h({"strings": [[b"c", b"ab"], []]})
    assert h(a) != h({"strings": [[b"ab"], [b"c"]]})


def test_problem_struct_matches_the_kernel_source():
    """``Problem``'s fields are those of the C struct, in its order, and
    its size is the C layout's."""
    src = (_build.CSRC / "invariant_matmul.cu").read_text()
    body = src[src.index("struct Problem {"):src.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        code = line.split("//")[0].strip()
        names += re.findall(r"(\w+)\s*(?:\[\d+\])?\s*(?=[,;])", code)
    assert names == [f[0] for f in im.Problem._fields_]
    assert ctypes.sizeof(im.Problem) == 4 * 8 + 12 * 8 + 10 * 4


@pytest.fixture(scope="module")
def tiny():
    m = get_model("MLICPP_TINY")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    return m


@pytest.mark.parametrize("backend", ["device", "steps"])
def test_batched_codec_matches_single(tiny, backend):
    """B images coded in one pass give the same per-image streams as each
    image coded alone, and the batch decodes bit-exactly."""
    codec = Codec(tiny, n_lanes=16, device="cpu", backend=backend)
    codec.update()
    rng = np.random.default_rng(9)
    xs = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    enc_b = codec.compress(xs)
    assert len(enc_b["strings"][0]) == 3 and len(enc_b["strings"][1]) == 3
    for b in range(3):
        enc_1 = codec.compress(xs[b:b + 1])
        assert enc_1["strings"][0][0] == enc_b["strings"][0][b]
        assert enc_1["strings"][1][0] == enc_b["strings"][1][b]
    dec_b = codec.decompress(enc_b["strings"], enc_b["shape"])
    assert torch.equal(dec_b["y_hat"], enc_b["y_hat"])
    assert torch.equal(dec_b["x_hat"], enc_b["x_hat"])


def test_batch_contract_tool_on_cpu(capsys):
    res = batch_contract.main(["--cpu", "--model", "MLICPP_TINY",
                               "--batch", "3", "--size", "64", "64",
                               "--lanes", "16"])
    assert res["y_bytes_differing"] == 0 and res["z_bytes_differing"] == 0
    assert res["decode_idx"] == [0, 1, 2]
    assert set(res["module_entries"]) == set(
        batch_contract.entropy_modules(get_model("MLICPP_TINY")))
    assert '"batch_contract"' in capsys.readouterr().out
    assert batch_contract.decode_indices(128) == [0, 18, 36, 54, 72, 90,
                                                  108, 127]
    frames = batch_contract.contract_frames(
        10, 8, 8, pool=np.arange(2 * 8 * 8 * 3, dtype=np.uint8).reshape(
            2, 8, 8, 3))
    assert len({f.tobytes() for f in frames}) == 10


@pytest.mark.parametrize("small_decoder", [False, True])
def test_coding_path_products_all_dispatch(tiny, small_decoder, monkeypatch):
    """Every batch-invariant product of one compress and one decompress
    goes through the dispatch, as many times as the smoke run's count
    from the configuration (``chip_smoke.k8_per_direction``,
    ``k8_in_analysis``) gives; the analysis transforms mark the
    convolutions the card ordered by the batch."""
    model = tiny
    if small_decoder:
        model = get_model("MLICPP_TINY", small_decoder=True)
        model.load_state_dict(init_params(model,
                                          torch.Generator().manual_seed(0)))
    marked = sorted(n for n, m in model.named_modules()
                    if getattr(m, "invariant", False)
                    and n.startswith(("g_a.", "h_a.")))
    context = sorted(n for n, m in model.named_modules()
                     if getattr(m, "invariant", False)
                     and not n.startswith(("g_a.", "h_a.")))
    S = model.cfg.slice_num
    assert context == sorted([f"local_{i}.fusion" for i in range(S)] + [
        f"{g}_{i}.reprojection" for g in ("ginter", "gintra")
        for i in range(1, S)])
    if small_decoder:
        assert marked == DENSE_ENCODER_MARKS
    else:
        assert marked == ["g_a.rbs0.conv1.dw.point", "g_a.rbs0.skip"]
    _check_dispatch_counts(model, monkeypatch)


# a dense encoder's convolutions that the card ordered by the batch: g_a's
# 1x1 skip over the image, every 3x3 from g_a's last stage on
DENSE_ENCODER_MARKS = sorted(
    ["g_a.out.conv", "g_a.rbs0.skip"]
    + [f"g_a.{b}.conv{i}.conv" for b in ("rb2", "rbs2") for i in (1, 2)]
    + [f"h_a.c{i}.conv" for i in range(5)])


def test_dense_encoder_products_all_dispatch(monkeypatch):
    """Dense MLICPP_TINY (``depthwise=False``) marks the small decoder's
    encoder convolutions and dispatches as many products a direction as
    the smoke run's count gives."""
    model = get_model("MLICPP_TINY", depthwise=False)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    marked = sorted(n for n, m in model.named_modules()
                    if getattr(m, "invariant", False)
                    and n.startswith(("g_a.", "h_a.")))
    assert marked == DENSE_ENCODER_MARKS
    _check_dispatch_counts(model, monkeypatch)


def _check_dispatch_counts(model, monkeypatch):
    import chip_smoke
    calls = {"n": 0}
    dispatch = im._dispatch

    def counted(*a, **k):
        calls["n"] += 1
        return dispatch(*a, **k)
    monkeypatch.setattr(im, "_dispatch", counted)
    codec = Codec(model, n_lanes=16, device="cpu")
    codec.update()
    x = (np.random.default_rng(1).random((2, 64, 64, 3)) * 255).astype(
        np.uint8)
    enc = codec.compress(x)
    n_compress = calls["n"]
    codec.decompress(enc["strings"], enc["shape"])
    cfg = model.cfg
    assert n_compress == chip_smoke.k8_per_direction(cfg) \
        + chip_smoke.k8_in_analysis(cfg)
    assert calls["n"] - n_compress == chip_smoke.k8_per_direction(cfg)
    assert chip_smoke.request_launches(cfg)["invariant_matmul"] == calls["n"]


def test_sass_census_finds_the_hot_loop():
    """``tools.sass_census`` reads a ``cuobjdump -sass`` listing: a
    function's instruction count, and for its hot loop (the backward branch
    whose body holds the most FFMAs) the body's instructions, FFMAs and
    opcodes, shared loads by width."""
    from mlic_tpu_torch.tools.sass_census import census

    def fn(name, body):
        return f"\n\tFunction : {name}\n" + "\n".join(
            f"        /*{a:04x}*/                   {ins} ;" for a, ins in
            enumerate(body)) + "\n"
    body = ["MOV R1, c[0x0][0x28]", "LDS.128 R4, [R2]", "FFMA R8, R4, R5, R8",
            "FFMA R9, R4, R6, R9", "@P0 BRA 0x1", "LDS R3, [R2]",
            "FFMA R9, R3, R3, R9", "@!P1 BRA 0x5", "EXIT"]
    listing = "header\n" + fn("_Z1av", body) + fn("_Z1bv", ["EXIT"])
    rows = census(listing)
    assert [r["function"] for r in rows] == ["_Z1av", "_Z1bv"]
    a = rows[0]
    assert a["instructions"] == 9 and a["loop_instructions"] == 4
    assert a["loop_ffma"] == 2 and a["loop_ffma_share"] == 0.5
    assert dict(a["loop_top"]) == {"FFMA": 2, "LDS.128": 1, "BRA": 1}
    assert rows[1] == {"function": "_Z1bv", "instructions": 1}
