"""The port's host-coded backends (``Codec(backend="steps" | "fused")``)
against the JAX package, MLICPP_TINY on [2, 64, 128, 3], on the CPU.

Per phase, the port's step methods against the flax ones on the same
weights and inputs, both fed JAX's symbols: squeezed means and scales
within 1e-5, scale indexes equal except where the flax scale lies within
1e-5 (relative) of a scale-table boundary (counted and printed).  Then the
port's own codec: steps and fused round trips bit-exact, their streams
byte-identical and cross-decodable, every codec decoding every backend's
streams, their y_hat and x_hat equal to the
device backend's, the y and z streams byte-equal to
``mlic_tpu.entropy.rans.coder.encode_with_indexes`` of the port's own
symbols and indexes over JAX's tables, and the VBR twin (with
``quant_offset`` and ``vr_entbttlnck``) at two levels and an
``inputscale``, bit-exact.  The JAX step programs compile at XLA
optimization level 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.entropy.cdf import get_scale_table
from mlic_tpu.entropy.models import GaussianConditionalTables as JaxGC
from mlic_tpu.entropy.models import entropy_bottleneck_tables as jax_eb
from mlic_tpu.entropy.rans import coder as jax_coder
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.ops.invariant_matmul import _dispatch
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import from_flax, init_params, to_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (the
    suite's xdist workers share the cores; see test_torch_codec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (2, 64, 128, 3)
N_LANES = 16
FAST_COMPILE = {"xla_backend_optimization_level": 0}
BOTH = {"vr_entbttlnck": True, "quant_offset": True}


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile(FAST_COMPILE)


@pytest.fixture(scope="module")
def jax_side():
    model = jax_get_model("MLICPP_TINY")
    x = np.random.default_rng(0).random(SHAPE, dtype=np.float32)
    params = jax.jit(lambda r, v: model.init(r, v, True))(
        {"params": jax.random.key(1), "noise": jax.random.key(2)}, x)["params"]
    cls = type(model)
    y, z = _compile(lambda p, v: model.apply({"params": p}, v,
                                             method=cls.analyze), params, x)(
        params, x)
    return {"model": model, "params": params, "x": x, "y": np.array(y),
            "z": np.array(z)}


def _port_model(params):
    m = get_model("MLICPP_TINY")
    m.load_state_dict(from_flax(params), strict=True)
    return m.eval()


def _jax_phases(js):
    """Every phase of the flax step methods, fed their own candidates:
    [(means_sq, scales_sq, indexes, candidates)] NHWC, squeezed."""
    model, p = js["model"], js["params"]
    cls = type(model)
    y, z = jnp.asarray(js["y"]), jnp.asarray(js["z"])
    begin = _compile(lambda p, y, z: model.apply(
        {"params": p}, y, z, 1.0, 1.0, method=cls.codec_begin), p, y, z)
    st, idx, cand = begin(p, y, z)
    out = []
    for i in range(model.cfg.slice_num):
        for method in (cls.codec_step_anchor, cls.codec_step_nonanchor):
            out.append(tuple(np.asarray(a) for a in (
                st["means_sq"], st["scales_sq"], idx, cand)))
            step = _compile(lambda p, y, s, c, _i=i, _m=method: model.apply(
                {"params": p}, y, s, c, _i, method=_m), p, y, st, cand)
            st, idx, cand = step(p, y, st, cand)
    return out


def test_step_methods_match_flax(jax_side):
    want = _jax_phases(jax_side)
    model = _port_model(jax_side["params"])
    table = get_scale_table()
    b = SHAPE[0]
    near = 0
    with torch.no_grad():
        st, idx, cand = model.codec_begin(torch.from_numpy(jax_side["y"]),
                                          torch.from_numpy(jax_side["z"]))
        for k, (mu, sc, j_idx, j_cand) in enumerate(want):
            for got, ref in ((st["means_sq"], mu), (st["scales_sq"], sc)):
                np.testing.assert_allclose(
                    got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5,
                    rtol=1e-5)
            assert idx.dtype == torch.uint8 and cand.dtype == torch.int32
            j_idx = j_idx.reshape(b, -1).astype(np.int32)
            diff = idx.numpy().astype(np.int32) != j_idx
            if diff.any():
                s = np.maximum(sc.reshape(b, -1)[diff], 0.11)
                rel = np.min(np.abs(s[:, None] - table[None, :-1])
                             / table[None, :-1], axis=1)
                assert (rel <= 1e-5).all(), rel.max()
                near += int(diff.sum())
            sym = torch.from_numpy(j_cand.reshape(b, -1).astype(np.int32))
            step = (model.codec_step_anchor if k % 2 == 0
                    else model.codec_step_nonanchor)
            st, idx, cand = step(st, sym, k // 2)
    assert idx is None and cand is None
    print(f"indexes different from flax's at a table boundary: {near}")


@pytest.fixture(scope="module")
def coded(jax_side):
    """The port's codec of every backend on the same weights and frames:
    {backend: (codec, compress result, decompress result)}."""
    model = _port_model(jax_side["params"])
    out = {}
    for backend in ("steps", "fused", "device"):
        codec = Codec(model, n_lanes=N_LANES, device="cpu", backend=backend)
        enc = codec.compress(jax_side["x"])
        out[backend] = (codec, enc, codec.decompress(enc["strings"],
                                                     enc["shape"]))
    return out


@pytest.mark.parametrize("backend", ["steps", "fused"])
def test_host_coded_roundtrip_bit_exact(coded, backend):
    _, enc, dec = coded[backend]
    assert enc["shape"] == (1, 2)
    assert all(len(g) == SHAPE[0] for g in enc["strings"])
    assert all(len(s) > 8 for g in enc["strings"] for s in g)
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    assert dec["x_hat"].shape == SHAPE and torch.isfinite(dec["x_hat"]).all()


def test_steps_and_fused_write_the_same_bytes(coded):
    steps, fused = coded["steps"], coded["fused"]
    assert steps[1]["strings"] == fused[1]["strings"]
    for (codec, enc, _), (_, other, _) in ((steps, fused), (fused, steps)):
        dec = codec.decompress(other["strings"], other["shape"])
        assert torch.equal(dec["y_hat"], other["y_hat"])


def test_every_codec_decodes_every_stream(jax_side, coded, monkeypatch):
    """``decompress`` tells the streams' kind from their z strings and
    headers: a device-backend codec of either format reads the reference's
    streams and the other format's, and a host-coded codec formats v3 and
    v4 (its device tables built on that first stream); a stream of no
    kind raises."""
    steps, dev = coded["steps"], coded["device"]
    host = Codec(steps[0].model, n_lanes=N_LANES, device="cpu",
                 backend="steps")
    host.update()
    assert host._gauss is None and host.tables is None
    monkeypatch.setenv("MLIC_UNIFIED_Z", "0")
    v3 = Codec(steps[0].model, n_lanes=N_LANES, device="cpu")
    enc3 = v3.compress(jax_side["x"])
    assert all(enc3["strings"][1]) and torch.equal(enc3["y_hat"],
                                                   dev[1]["y_hat"])
    v3_coded = (v3, enc3, None)
    for codec in (host, dev[0], v3):
        for _, enc, _ in (steps, dev, v3_coded):
            dec = codec.decompress(enc["strings"], enc["shape"])
            assert torch.equal(dec["y_hat"], enc["y_hat"])
            assert torch.equal(dec["x_hat"], enc["x_hat"])
    bad = [[b"\x00" * 64] * SHAPE[0], [b""] * SHAPE[0]]
    with pytest.raises(ValueError, match="not a format-v4 stream"):
        dev[0].decompress(bad, steps[1]["shape"])


def test_per_image_only_when_coding():
    """The batch-invariant products' plain version splits the batch under
    ``no_grad`` on the CPU (coding) and calls once with a gradient
    (training)."""
    calls = []

    def fn(a):
        calls.append(a.shape[0])
        return a * 2

    x = torch.ones(3, 2)
    with torch.no_grad():
        assert torch.equal(_dispatch(fn, (x,), None), x * 2)
    assert calls == [1, 1, 1]
    calls.clear()
    assert torch.equal(_dispatch(fn, (x.requires_grad_(),), None),
                       x.detach() * 2)
    assert calls == [3]


def test_host_coded_reconstruction_equals_device_backend(coded):
    _, dev, _ = coded["device"]
    for backend in ("steps", "fused"):
        _, enc, dec = coded[backend]
        assert torch.equal(enc["y_hat"], dev["y_hat"]), backend
        assert torch.equal(dec["x_hat"], dev["x_hat"]), backend


def test_streams_equal_jax_coder_on_port_symbols(jax_side, coded):
    """The port's y and z streams are the JAX host coder's bytes for the
    port's own symbols and indexes (collected through ``codec_pass``),
    over the JAX package's tables."""
    codec, enc, _ = coded["steps"]
    model = codec.model
    x = torch.from_numpy(jax_side["x"])
    got = []

    def exchange(tag, indexes, candidate):
        got.append((candidate.numpy(), indexes.numpy().astype(np.int32)))
        return candidate

    with torch.no_grad():
        y, z = model.analyze(x)
        y_hat = model.codec_pass(y, z, exchange)
    assert torch.equal(y_hat, enc["y_hat"])
    assert len(got) == 2 * model.cfg.slice_num
    gc = JaxGC.create()
    eb = jax_eb(to_flax(model.state_dict())["entropy_bottleneck"],
                model.cfg.N)
    z = z.numpy()
    rows = np.broadcast_to(np.arange(z.shape[-1], dtype=np.int32),
                           z.shape[1:]).ravel()
    for b in range(SHAPE[0]):
        sym = np.concatenate([s[b] for s, _ in got])
        idx = np.concatenate([i[b] for _, i in got])
        assert enc["strings"][0][b] == jax_coder.encode_with_indexes(
            sym, idx, gc.quantized_cdf, gc.cdf_length, gc.offset)
        assert enc["strings"][1][b] == jax_coder.encode_with_indexes(
            z[b].ravel(), rows, *eb[:3])


def test_vbr_twin_through_host_coded_backends():
    """MLICPP_TINY_VBR with QuantABCD's offset and the variable-step
    bottleneck: steps round trips bit-exact at two levels and at an
    ``inputscale``; fused writes steps' bytes and the device backend
    reconstructs the same y_hat at the lowest level."""
    m = get_model("MLICPP_TINY_VBR", **BOTH)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    x = np.random.default_rng(1).random(SHAPE, dtype=np.float32)
    steps = Codec(m, device="cpu", backend="steps")
    results = {}
    for s, isc in ((0, 0.0), (2, 0.0), (1, 0.3)):
        enc = steps.compress(x, s=s, inputscale=isc)
        dec = steps.decompress(enc["strings"], enc["shape"], s=s,
                               inputscale=isc)
        assert torch.equal(enc["y_hat"], dec["y_hat"]), (s, isc)
        assert torch.equal(enc["x_hat"], dec["x_hat"]), (s, isc)
        results[(s, isc)] = enc
    assert len({steps._z_qs_for(s, i) for s, i in results}) >= 2
    fused = Codec(m, device="cpu", backend="fused").compress(x, s=0)
    assert fused["strings"] == results[(0, 0.0)]["strings"]
    dev = Codec(m, n_lanes=N_LANES, device="cpu").compress(x, s=0)
    assert torch.equal(dev["y_hat"], results[(0, 0.0)]["y_hat"])
