"""The port's layers, transforms and context modules against the flax ones.

Each case builds a flax module and its torch twin, initialises the flax
parameters (perturbed with seeded noise so biases and GDN's off-diagonal
gamma are not at their init values), converts them with
``weights.from_flax`` and compares outputs on the same numpy input.
Tolerances: 1e-5 for single f32 layers (as tests/test_pallas_fused_block.py),
1e-4 for whole transforms and the context stack (XLA and torch sum
convolutions in different orders), 5e-2 under bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.models import context as fc
from mlic_tpu.models import layers as fl
from mlic_tpu.models import transforms as ft
from mlic_tpu.ops import math as fm
from mlic_tpu_torch.models import context as tc
from mlic_tpu_torch.models import layers as tl
from mlic_tpu_torch.models import transforms as tt
from mlic_tpu_torch.ops import math as tm
from mlic_tpu_torch.weights import from_flax

BF16 = (jnp.bfloat16, torch.bfloat16)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    if t.dim() == 4:
        t = t.permute(0, 3, 1, 2)
    return t.to(dtype) if dtype is not None else t


def _compare(flax_mod, torch_mod, shapes, tol, seed=0, bf16=False,
             prep=None):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if prep is not None:
        xs = [prep(x) for x in xs]
    jdt, tdt = BF16 if bf16 else (jnp.float32, None)
    jx = [jnp.asarray(x, jdt) for x in xs]
    params = jax.jit(flax_mod.init)(jax.random.key(seed), *jx)["params"]
    params = _perturb(params, seed)
    ref = jax.jit(lambda p, *a: flax_mod.apply({"params": p}, *a))(params, *jx)
    torch_mod.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = torch_mod(*[_to_torch(x, tdt) for x in xs]).float()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _anchor_only(x):
    return np.asarray(fm.ckbd_anchor(jnp.asarray(x)))


LAYER_CASES = {
    "dw3x3": (lambda: fl.DepthwiseConv2D(3, 1),
              lambda: tl.DepthwiseConv2D(8), [(2, 8, 12, 8)]),
    "dw3x3_s2": (lambda: fl.DepthwiseConv2D(3, 2),
                 lambda: tl.DepthwiseConv2D(8, 3, 2), [(2, 8, 12, 8)]),
    "pointwise": (lambda: fl.PointwiseConv(12),
                  lambda: tl.PointwiseConv(8, 12), [(2, 8, 12, 8)]),
    "pointwise_s2": (lambda: fl.PointwiseConv(12, 2),
                     lambda: tl.PointwiseConv(8, 12, 2), [(2, 8, 12, 8)]),
    "conv3x3_dw": (lambda: fl.Conv3x3(16, 2),
                   lambda: tl.Conv3x3(8, 16, 2), [(1, 8, 12, 8)]),
    "conv3x3_dense": (lambda: fl.Conv3x3(16, 1, depthwise=False),
                      lambda: tl.Conv3x3(8, 16, 1, depthwise=False),
                      [(1, 8, 12, 8)]),
    "conv5x5": (lambda: fl.conv5x5(12, 1),
                lambda: tl.conv5x5(8, 12, 1), [(1, 8, 12, 8)]),
    "subpel": (lambda: fl.SubpelConv3x3(6, 2),
               lambda: tl.SubpelConv3x3(8, 6, 2), [(1, 6, 8, 8)]),
    "gdn": (lambda: fl.GDN(), lambda: tl.GDN(8), [(2, 6, 10, 8)]),
    "igdn": (lambda: fl.GDN(inverse=True), lambda: tl.GDN(8, inverse=True),
             [(2, 6, 10, 8)]),
    "rbs": (lambda: fl.ResidualBlockWithStride(16, 2),
            lambda: tl.ResidualBlockWithStride(8, 16, 2), [(2, 16, 8, 8)]),
    "rbu": (lambda: fl.ResidualBlockUpsample(12, 2),
            lambda: tl.ResidualBlockUpsample(8, 12, 2), [(1, 8, 8, 8)]),
    "rb": (lambda: fl.ResidualBlock(16),
           lambda: tl.ResidualBlock(16, 16), [(1, 8, 8, 16)]),
    "rb_skip": (lambda: fl.ResidualBlock(16),
                lambda: tl.ResidualBlock(8, 16), [(1, 8, 8, 8)]),
    "mlp": (lambda: fl.MLP(24, 10), lambda: tl.MLP(12, 24, 10),
            [(2, 30, 12)]),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_f32(case):
    fmod, tmod, shapes = LAYER_CASES[case]
    _compare(fmod(), tmod(), shapes, 1e-5)


BF16_CASES = {
    # GDN in f32 with casts in and out (transform_dtype="bfloat16")
    "gdn_cast": (lambda: fl.GDN(), lambda: tl.GDN(8)),
    "igdn_cast": (lambda: fl.GDN(inverse=True),
                  lambda: tl.GDN(8, inverse=True)),
    # the mixed policy: bf16 x^2 and gamma, f32 accumulation
    "gdn_mixed": (lambda: fl.GDN(dtype=jnp.bfloat16),
                  lambda: tl.GDN(8, dtype=torch.bfloat16)),
    "igdn_mixed": (lambda: fl.GDN(inverse=True, dtype=jnp.bfloat16),
                   lambda: tl.GDN(8, inverse=True, dtype=torch.bfloat16)),
    "rbs_bf16": (lambda: fl.ResidualBlockWithStride(8, 2, dtype=jnp.bfloat16),
                 lambda: tl.ResidualBlockWithStride(8, 8, 2,
                                                    dtype=torch.bfloat16)),
    "rbu_bf16_mixed": (
        lambda: fl.ResidualBlockUpsample(8, 2, dtype=jnp.bfloat16,
                                         gdn_dtype=jnp.bfloat16),
        lambda: tl.ResidualBlockUpsample(8, 8, 2, dtype=torch.bfloat16,
                                         gdn_dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_layer_bf16(case):
    fmod, tmod = BF16_CASES[case]
    _compare(fmod(), tmod(), [(1, 8, 8, 8)], 5e-2, bf16=True)


TRANSFORM_CASES = {
    "g_a": (lambda: ft.AnalysisTransform(16, 24),
            lambda: tt.AnalysisTransform(16, 24), [(1, 32, 32, 3)]),
    "h_a": (lambda: ft.HyperAnalysis(24, 16),
            lambda: tt.HyperAnalysis(24, 16), [(1, 8, 8, 24)]),
    "h_s": (lambda: ft.HyperSynthesis(24, 16),
            lambda: tt.HyperSynthesis(24, 16), [(1, 2, 2, 16)]),
    "g_s": (lambda: ft.SynthesisTransform(16, 24),
            lambda: tt.SynthesisTransform(16, 24), [(1, 2, 2, 24)]),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transform_f32(case):
    fmod, tmod, shapes = TRANSFORM_CASES[case]
    _compare(fmod(), tmod(), shapes, 1e-4)


@pytest.mark.parametrize("case", ["g_a", "h_a"])
def test_encoder_transform_bf16(case):
    """The serving setting (transform_dtype="bfloat16") of the encoder-side
    transforms.  XLA rounds bf16 at other points than torch (it keeps fused
    elementwise chains in f32), so deeper bf16 stacks drift further: at
    these sizes g_s in bf16 leaves 0.3% of its outputs outside 5e-2."""
    kw = dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)
    if case == "g_a":
        fmod = ft.AnalysisTransform(16, 24, **kw[0])
        tmod = tt.AnalysisTransform(16, 24, **kw[1])
        shapes = [(1, 32, 32, 3)]
    else:
        fmod = ft.HyperAnalysis(24, 16, **kw[0])
        tmod = tt.HyperAnalysis(24, 16, **kw[1])
        shapes = [(1, 8, 8, 24)]
    _compare(fmod, tmod, shapes, 5e-2, bf16=True)


CONTEXT_CASES = {
    "local": (lambda: fc.LocalContext(dim=8), lambda: tc.LocalContext(8),
              [(2, 8, 10, 8)], _anchor_only),
    "channel": (lambda: fc.ChannelContext(8, (24, 16)),
                lambda: tc.ChannelContext(16, 8, (24, 16)), [(1, 6, 8, 16)],
                None),
    "qkv": (lambda: fc._QKVConv(8), lambda: tc._QKVConv(8, 8),
            [(1, 6, 8, 8)], None),
    "global_inter": (lambda: fc.LinearGlobalInterContext(16, 16, 2),
                     lambda: tc.LinearGlobalInterContext(16, 16, 2),
                     [(1, 6, 8, 16)], None),
    "global_intra": (lambda: fc.LinearGlobalIntraContext(8),
                     lambda: tc.LinearGlobalIntraContext(8),
                     [(1, 6, 8, 8), (1, 6, 8, 8)], None),
    "entropy_parameters": (lambda: fc.EntropyParameters(16),
                           lambda: tc.EntropyParameters(24, 16),
                           [(1, 4, 6, 24)], None),
    "lrp": (lambda: fc.LatentResidualPrediction(8),
            lambda: tc.LatentResidualPrediction(24, 8), [(1, 4, 6, 24)],
            None),
}


@pytest.mark.parametrize("case", sorted(CONTEXT_CASES))
def test_context_module(case):
    fmod, tmod, shapes, prep = CONTEXT_CASES[case]
    _compare(fmod(), tmod(), shapes, 1e-4, prep=prep)


def test_linear_attention():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 20, 16)).astype(np.float32)
               for _ in range(3))
    ref = fc._linear_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 2)
    got = tc._linear_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_window_geometry_exact():
    np.testing.assert_array_equal(
        tc._relative_position_index(5), fc._relative_position_index(5))
    np.testing.assert_array_equal(
        tc.window_anchor_map(6, 8, 5).numpy(),
        np.asarray(fc.window_anchor_map(6, 8, 5)))


@pytest.mark.parametrize("fn", ["ckbd_anchor", "ckbd_nonanchor",
                                "ckbd_anchor_squeeze",
                                "ckbd_nonanchor_squeeze",
                                "ckbd_anchor_unsqueeze",
                                "ckbd_nonanchor_unsqueeze"])
def test_checkerboard_exact(fn):
    x = np.random.default_rng(4).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    ref = np.asarray(getattr(fm, fn)(jnp.asarray(x)))
    got = getattr(tm, fn)(_to_torch(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_ckbd_squeeze_roundtrip_and_bound():
    y = torch.randn(2, 3, 6, 8, generator=torch.Generator().manual_seed(0))
    a = tm.ckbd_anchor_unsqueeze(tm.ckbd_anchor_squeeze(y))
    n = tm.ckbd_nonanchor_unsqueeze(tm.ckbd_nonanchor_squeeze(y))
    assert torch.equal(a + n, y)
    assert torch.equal(a, tm.ckbd_anchor(y))
    np.testing.assert_array_equal(
        tm.ckbd_mask(6, 8).numpy(), np.asarray(fm.ckbd_mask(6, 8)))
    np.testing.assert_array_equal(
        tm.lower_bound(y, 0.11).numpy(),
        np.asarray(fm.lower_bound(jnp.asarray(y.numpy()), 0.11)))
