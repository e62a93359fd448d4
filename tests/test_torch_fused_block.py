"""The port's fused block tail against the JAX package's, on the CPU.

``fused_block_tail_plain`` (the plain version beside kernel K5; what the
wrapper runs for CPU tensors) against the Pallas ``fused_block_tail`` in
Mosaic interpret mode, as tests/test_pallas_fused_block.py runs it; the three
residual blocks and g_a / g_s at MLICPP_TINY's widths with the switch on in
both packages; and the rules around the kernel: which tails fuse under which
dtype policy, the dtype guard, shapes the TPU kernel refuses.

Tolerances, as tests/test_pallas_fused_block.py states them for the same
comparison: 1e-5 in f32 (the two sum the same products in different orders),
5e-2 under bf16 (the Pallas body rounds after every tap, the port once per
depthwise output; both accumulate the two contractions in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mlic_tpu.models import layers as fl
from mlic_tpu.models import transforms as ft
from mlic_tpu.ops.pallas_fused_block import fused_block_tail as jax_fused_tail
from mlic_tpu_torch.models import layers as tl
from mlic_tpu_torch.models import transforms as tt
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.ops import _build
from mlic_tpu_torch.ops import fused_block as fb
from mlic_tpu_torch.weights import from_flax, init_params

SWITCH = "MLIC_FUSED_BLOCKS"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _nchw(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2) \
        .contiguous().to(dtype)


def _nhwc_np(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _tail_inputs(seed, b, h, w, c, n):
    """NHWC inputs and flax-layout weights; gamma, beta are effective
    (nonnegative) GDN parameters."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "mid": rng.standard_normal((b, h, w, c)).astype(f),
        "skip": rng.standard_normal((b, h, w, n)).astype(f),
        "dw": (rng.standard_normal((3, 3, 1, c)) / 3).astype(f),
        "bdw": (0.1 * rng.standard_normal(c)).astype(f),
        "pw": (rng.standard_normal((1, 1, c, n)) / np.sqrt(c)).astype(f),
        "bpw": (0.1 * rng.standard_normal(n)).astype(f),
        "gamma": (0.1 * np.eye(n) + 0.02 * np.abs(
            rng.standard_normal((n, n)))).astype(f),
        "beta": (1.0 + np.abs(rng.standard_normal(n))).astype(f),
    }


def _plain(v, act, dtype):
    """The port's plain version on the NHWC/flax-layout inputs of ``v``."""
    out = fb.fused_block_tail_plain(
        _nchw(v["mid"], dtype), _nchw(v["skip"], dtype),
        torch.from_numpy(v["dw"].transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(v["bdw"]),
        torch.from_numpy(v["pw"].transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(v["bpw"]), torch.from_numpy(v["gamma"]),
        torch.from_numpy(v["beta"]), act=act)
    assert out.dtype == dtype
    return _nhwc_np(out)


@pytest.mark.parametrize("c,n", [(8, 16), (12, 20)],
                         ids=["c8_n16", "c12_n20_not_multiple_of_8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gdn", "igdn", "gelu"])
def test_plain_matches_pallas_interpret(act, dtype, c, n):
    seed = 100 * list(fb.ACTS).index(act) + 10 * (dtype == "bfloat16") + c
    v = _tail_inputs(seed, 2, 8, 16, c, n)
    jdt = JDT[dtype]
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_tail(
            jnp.asarray(v["mid"], jdt), jnp.asarray(v["skip"], jdt),
            jnp.asarray(v["dw"]), jnp.asarray(v["bdw"]), jnp.asarray(v["pw"]),
            jnp.asarray(v["bpw"]), jnp.asarray(v["gamma"]),
            jnp.asarray(v["beta"]), act=act)
    assert ref is not None
    got = _plain(v, act, TDT[dtype])
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _both_fused(monkeypatch, flax_mod, torch_mod, shape, dtype, seed,
                tol=None):
    """Flax module (Pallas tail, interpret mode) and its torch twin (plain
    tail), both with the switch on, on one numpy input."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    params = _perturb(jax.jit(flax_mod.init)(jax.random.key(seed),
                                             jx)["params"], seed)
    monkeypatch.setenv(SWITCH, "1")
    with pltpu.force_tpu_interpret_mode():
        ref = flax_mod.apply({"params": params}, jx)
    torch_mod.load_state_dict(from_flax(params), strict=True)
    calls = _count_tails(monkeypatch)
    with torch.no_grad():
        got = torch_mod(_nchw(x, TDT[dtype]))
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(_nhwc_np(got), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)
    return calls


def _count_tails(monkeypatch):
    """Stub the tail the layers call: count, then run the plain version."""
    calls = []

    def stub(*args, **kw):
        calls.append(kw["act"])
        return fb.fused_block_tail_plain(*args, **kw)

    monkeypatch.setattr(tl, "fused_block_tail", stub)
    return calls


BLOCKS = {
    "rbs": (lambda jd: fl.ResidualBlockWithStride(16, 2, dtype=jd,
                                                  gdn_dtype=jd),
            lambda td: tl.ResidualBlockWithStride(8, 16, 2, dtype=td,
                                                  gdn_dtype=td),
            (2, 32, 16, 8), "gdn"),
    "rbu": (lambda jd: fl.ResidualBlockUpsample(12, 2, dtype=jd, gdn_dtype=jd),
            lambda td: tl.ResidualBlockUpsample(12, 12, 2, dtype=td,
                                                gdn_dtype=td),
            (1, 8, 8, 12), "igdn"),
    "rb": (lambda jd: fl.ResidualBlock(16, dtype=jd),
           lambda td: tl.ResidualBlock(16, 16, dtype=td),
           (1, 16, 8, 16), "gelu"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_fused_block_matches_flax_fused(monkeypatch, name, dtype):
    make_flax, make_torch, shape, act = BLOCKS[name]
    mixed = dtype == "bfloat16"
    calls = _both_fused(
        monkeypatch, make_flax(jnp.bfloat16 if mixed else None),
        make_torch(torch.bfloat16 if mixed else None), shape, dtype, seed=3)
    assert calls == [act]


@pytest.mark.parametrize("name", ["g_a", "g_s"])
def test_fused_transforms_match_flax_fused(monkeypatch, name):
    """g_a and g_s at MLICPP_TINY's widths (N=32, M=64), f32, switch on;
    1e-4 for a whole transform, as tests/test_torch_layers.py."""
    flax_mod, torch_mod, shape, tails, seed = {
        "g_a": (ft.AnalysisTransform(N=32, M=64), tt.AnalysisTransform(32, 64),
                (1, 64, 64, 3), ["gdn", "gelu"] * 3, 5),
        "g_s": (ft.SynthesisTransform(N=32, M=64),
                tt.SynthesisTransform(32, 64), (1, 8, 8, 64),
                ["gelu"] + ["igdn", "gelu"] * 3, 6)}[name]
    calls = _both_fused(monkeypatch, flax_mod, torch_mod, shape, "float32",
                        seed=seed, tol=1e-4)
    assert calls == tails


@pytest.mark.parametrize("name", list(BLOCKS))
def test_fused_tail_replaces_unfused_tail(monkeypatch, name):
    """Switch on: same result as switch off (1e-5), and the unfused tail's
    second convolution is not computed as well."""
    _, make_torch, shape, _ = BLOCKS[name]
    mod = make_torch(None)
    sd = {k: 0.3 * torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(i))
          for i, (k, v) in enumerate(mod.state_dict().items())}
    mod.load_state_dict(sd)
    x = _nchw(np.random.default_rng(7).standard_normal(shape), torch.float32)
    monkeypatch.delenv(SWITCH, raising=False)
    with torch.no_grad():
        ref = mod(x)
    monkeypatch.setenv(SWITCH, "1")
    conv2 = mod.conv if name == "rbu" else mod.conv2
    monkeypatch.setattr(conv2, "forward", lambda *_: pytest.fail(
        "the unfused tail ran beside the fused one"))
    with torch.no_grad():
        got = mod(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_dense_blocks_take_unfused_path_exactly(monkeypatch, name):
    mod = {"rbs": lambda: tl.ResidualBlockWithStride(8, 16, 2, depthwise=False),
           "rbu": lambda: tl.ResidualBlockUpsample(12, 12, 2, depthwise=False),
           "rb": lambda: tl.ResidualBlock(16, 16, depthwise=False)}[name]()
    sd = {k: 0.3 * torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(i))
          for i, (k, v) in enumerate(mod.state_dict().items())}
    mod.load_state_dict(sd)
    x = _nchw(np.random.default_rng(8).standard_normal(BLOCKS[name][2]),
              torch.float32)
    monkeypatch.delenv(SWITCH, raising=False)
    with torch.no_grad():
        ref = mod(x)
    monkeypatch.setenv(SWITCH, "1")
    calls = _count_tails(monkeypatch)
    with torch.no_grad():
        got = mod(x)
    assert calls == [] and torch.equal(got, ref)


@pytest.mark.parametrize("policy,expected", [
    ("float32", 13), ("bfloat16", 7), ("bfloat16_mixed", 13)])
def test_launches_per_policy(monkeypatch, policy, expected):
    """g_a + g_s fuse all 13 tails under float32 and bfloat16_mixed; under
    plain bfloat16 GDN keeps its f32 norm, so only the 7 GELU tails fuse."""
    model = get_model("MLICPP_TINY", policy)
    model.load_state_dict(init_params(model,
                                      torch.Generator().manual_seed(0)))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(9).random(
        (1, 64, 64, 3), dtype=np.float32))
    monkeypatch.setenv(SWITCH, "1")
    calls = _count_tails(monkeypatch)
    with torch.no_grad():
        y, _ = model.analyze(x)
        n_ga = len(calls)
        model.synthesize(torch.round(y))
    assert len(calls) == expected
    assert n_ga == (3 if policy == "bfloat16" else 6)
    assert calls.count("gelu") == 7
    monkeypatch.setenv(SWITCH, "0")
    del calls[:]
    with torch.no_grad():
        model.synthesize(torch.round(model.analyze(x)[0]))
    assert calls == []


def test_switch_is_read_at_each_call(monkeypatch):
    monkeypatch.delenv(SWITCH, raising=False)
    assert not fb.use_fused_blocks()
    monkeypatch.setenv(SWITCH, "1")
    assert fb.use_fused_blocks()
    monkeypatch.setenv(SWITCH, "true")
    assert not fb.use_fused_blocks()


def test_skip_dtype_guard_raises():
    v = _tail_inputs(1, 1, 4, 4, 4, 6)
    args = [_nchw(v["mid"], torch.bfloat16), _nchw(v["skip"], torch.float32),
            torch.from_numpy(v["dw"].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(v["bdw"]),
            torch.from_numpy(v["pw"].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(v["bpw"])]
    with pytest.raises(TypeError, match="must match"):
        fb.fused_block_tail(*args, act="gelu")
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="needs gamma"):
        fb.fused_block_tail(*args, act="gdn")
    with pytest.raises(ValueError, match="act must be"):
        fb.fused_block_tail(*args, act="relu")
    with pytest.raises(ValueError, match="skip is"):
        fb.fused_block_tail(args[0], args[1][:, :5], *args[2:], act="gelu")


@pytest.mark.parametrize("act", ["gdn", "igdn", "gelu"])
def test_shape_the_tpu_kernel_refuses_is_computed(act):
    """H = 7 tiles on no TPU row tile (the JAX function returns None); the
    port computes it, equal to the unfused composition (1e-5)."""
    v = _tail_inputs(2, 1, 7, 8, 4, 6)
    assert jax_fused_tail(
        jnp.asarray(v["mid"]), jnp.asarray(v["skip"]), jnp.asarray(v["dw"]),
        jnp.asarray(v["bdw"]), jnp.asarray(v["pw"]), jnp.asarray(v["bpw"]),
        jnp.asarray(v["gamma"]), jnp.asarray(v["beta"]), act=act) is None
    before = _build.launch_counts()
    got = _plain(v, act, torch.float32)
    assert _build.launch_counts() == before
    g = np.asarray(jax.nn.gelu(jnp.asarray(v["mid"])))
    gp = np.pad(g, ((0, 0), (1, 1), (1, 1), (0, 0)))
    a = sum(gp[:, i:i + 7, j:j + 8] * v["dw"][i, j, 0]
            for i in range(3) for j in range(3)) + v["bdw"]
    h = a @ v["pw"][0, 0] + v["bpw"]
    if act == "gelu":
        ref = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    else:
        norm = (h * h) @ v["gamma"] + v["beta"]
        ref = h * (np.sqrt(norm) if act == "igdn" else 1 / np.sqrt(norm))
    np.testing.assert_allclose(got, ref + v["skip"], atol=1e-5, rtol=1e-5)


# The widths that the port's configurations send through _fused_tail
# (models/config.py: N = 32, 96, 128, 160, 192; M = 320 at g_s's first
# block), each with one tail and dtype, plus C != N both ways.
CONFIG_WIDTHS = [(32, 32, "gdn", "float32"), (96, 96, "igdn", "bfloat16"),
                 (128, 128, "gelu", "float32"), (160, 160, "gelu", "bfloat16"),
                 (192, 192, "gdn", "bfloat16"), (320, 320, "gelu", "bfloat16"),
                 (96, 160, "igdn", "float32"), (160, 96, "gdn", "bfloat16")]


@pytest.mark.parametrize("c,n,act,dtype", CONFIG_WIDTHS,
                         ids=[f"c{c}_n{n}_{a}_{d}" for c, n, a, d in
                              CONFIG_WIDTHS])
def test_plain_matches_pallas_at_config_widths(c, n, act, dtype):
    v = _tail_inputs(1000 + c + n, 1, 8, 8, c, n)
    jdt = JDT[dtype]
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_tail(
            jnp.asarray(v["mid"], jdt), jnp.asarray(v["skip"], jdt),
            jnp.asarray(v["dw"]), jnp.asarray(v["bdw"]), jnp.asarray(v["pw"]),
            jnp.asarray(v["bpw"]), jnp.asarray(v["gamma"]),
            jnp.asarray(v["beta"]), act=act)
    assert ref is not None
    got = _plain(v, act, TDT[dtype])
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_too_wide_raises_before_launch(dtype, monkeypatch):
    """A width whose tile the kernel's shared-memory plan puts above a
    block's raises ValueError before any device work, and a width that fits
    passes.  The wrapper asks the plan only for tensors on one CUDA device
    (meta tensors stop at that test, and no kernel launches).  The plan
    comes from the kernel's library (``fb.smem_bytes``), which builds only
    where nvcc is, so a stand-in that grows with C * N takes its place
    here; chip_smoke.py holds the real plan on the card."""
    asked = []

    def plan(c, n, act, dt):
        asked.append((c, n, act, dt))
        return 2 * c * n

    monkeypatch.setattr(fb, "smem_bytes", plan)
    with pytest.raises(ValueError, match="shared memory"):
        fb._check_fits(4096, 4096, "gdn", dtype)
    fb._check_fits(320, 320, "gdn", dtype)
    assert asked == [(4096, 4096, "gdn", dtype), (320, 320, "gdn", dtype)]

    def meta(c, n):
        return [torch.empty(s, device="meta", dtype=d) for s, d in (
            ((1, c, 8, 8), dtype), ((1, n, 8, 8), dtype),
            ((c, 1, 3, 3), torch.float32), ((c,), torch.float32),
            ((n, c, 1, 1), torch.float32), ((n,), torch.float32),
            ((n, n), torch.float32), ((n,), torch.float32))]
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        fb.fused_block_tail(*meta(4096, 4096), act="gdn")
    assert len(asked) == 2 and _build.launch_counts() == before
