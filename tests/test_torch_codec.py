"""The port's serving path as a whole against the JAX package, MLICPP_TINY,
batch 2 at 64x128, on the CPU.

Float parity of ``analyze`` (1e-4), agreement of the encode pass's
integer symbols and scale indexes with JAX's given the same y and z
(>= 99.9% of positions: last-ulp float differences may flip a rounding or
a scale index), a bit-exact compress -> decompress round trip, and the
share of the port's streams that the JAX codec decodes (printed: the two
frameworks' tables and entropy parameters differ in the last ulp, so this
is not required).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mlic_tpu.codec import Codec as JaxCodec
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs: the
    suite runs under six pytest-xdist workers on the machine's cores, and
    an operator that forks a thread per core then waits at its barrier for
    threads the other workers hold, tens of times slower than one thread.
    The numbers checked are the same; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (2, 64, 128, 3)
N_LANES = 32


@pytest.fixture(scope="module")
def jax_side():
    model = jax_get_model("MLICPP_TINY")
    x = np.random.default_rng(0).random(SHAPE, dtype=np.float32)
    params = jax.jit(lambda r, v: model.init(r, v, True))(
        {"params": jax.random.key(1), "noise": jax.random.key(2)}, x)["params"]
    cls = type(model)
    y, z = jax.jit(lambda p, v: model.apply({"params": p}, v,
                                            method=cls.analyze))(params, x)
    enc = jax.jit(lambda p, a, b: model.apply(
        {"params": p}, a, b, 1.0, 1.0, False,
        method=cls.codec_encode_pass))(params, y, z)
    return {"model": model, "params": params, "x": x, "y": np.array(y),
            "z": np.array(z), "sym": np.asarray(enc[6]),
            "idx": np.asarray(enc[4]).astype(np.int32)}


def _port_model(params, transform_dtype=None):
    m = get_model("MLICPP_TINY", transform_dtype)
    m.load_state_dict(from_flax(params), strict=True)
    return m.eval()


def test_from_flax_consumes_every_leaf_once(jax_side):
    leaves = jax.tree_util.tree_leaves(jax_side["params"])
    sd = from_flax(jax_side["params"])
    model = get_model("MLICPP_TINY")
    own = model.state_dict()
    assert len(sd) == len(leaves) == len(own)
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    res = model.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_analyze_matches_jax(jax_side):
    model = _port_model(jax_side["params"])
    with torch.no_grad():
        y, z = model.analyze(torch.from_numpy(jax_side["x"]))
    np.testing.assert_allclose(y.numpy(), jax_side["y"], atol=1e-4,
                               rtol=1e-4)
    share = float(np.mean(z.numpy() == jax_side["z"]))
    print(f"z symbols equal to JAX's: {share:.6f}")
    assert share >= 0.999


def test_encode_pass_agrees_with_jax(jax_side):
    model = _port_model(jax_side["params"])
    with torch.no_grad():
        _, sym, idx = model.codec_encode_pass(
            torch.from_numpy(jax_side["y"]), torch.from_numpy(jax_side["z"]))
    s_share = float(np.mean(sym.numpy() == jax_side["sym"]))
    i_share = float(np.mean(idx.numpy() == jax_side["idx"]))
    print(f"encode pass vs JAX: symbols {s_share:.6f}, indexes {i_share:.6f}"
          f" of {sym.numel()} positions")
    assert sym.shape == jax_side["sym"].shape
    assert s_share >= 0.999 and i_share >= 0.999


@pytest.mark.parametrize("transform_dtype", ["float32", "bfloat16"])
def test_cpu_roundtrip_bit_exact(jax_side, transform_dtype):
    model = _port_model(jax_side["params"], transform_dtype)
    codec = Codec(model, n_lanes=N_LANES, device="cpu")
    x8 = (jax_side["x"] * 255).astype(np.uint8)
    enc = codec.compress(x8)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert enc["shape"] == (1, 2)
    assert dec["y_hat"].shape == (2, 4, 8, 64)
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    with torch.no_grad():
        assert torch.equal(dec["x_hat"], model.synthesize(enc["y_hat"]))
    assert dec["x_hat"].shape == SHAPE and torch.isfinite(dec["x_hat"]).all()


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("transform_dtype",
                         ["float32", "bfloat16", "bfloat16_mixed"])
def test_compress_returns_decoder_x_hat(jax_side, monkeypatch,
                                        transform_dtype, fused):
    """``compress`` returns the encode-side reconstruction, and the decoder
    reproduces it bit for bit, with the block tails unfused and fused."""
    monkeypatch.setenv("MLIC_FUSED_BLOCKS", fused)
    codec = Codec(_port_model(jax_side["params"], transform_dtype),
                  n_lanes=N_LANES, device="cpu")
    enc = codec.compress(jax_side["x"])
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert enc["x_hat"].shape == SHAPE and enc["x_hat"].dtype == torch.float32
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])


def test_stage_timings_leave_the_result_alone(jax_side):
    """``timings`` records every stage and changes neither the streams nor
    the decoded latent."""
    codec = Codec(_port_model(jax_side["params"]), n_lanes=N_LANES,
                  device="cpu")
    enc = codec.compress(jax_side["x"])
    t_enc, t_dec = {}, {}
    staged = codec.compress(jax_side["x"], timings=t_enc)
    dec = codec.decompress(staged["strings"], staged["shape"], timings=t_dec)
    assert staged["strings"] == enc["strings"]
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert list(t_enc) == ["analyze", "encode_pass", "rans_encode", "assemble",
                           "synthesize"]
    assert list(t_dec) == ["parse", "entropy_decode", "synthesize"]
    assert all(v >= 0.0 for v in (*t_enc.values(), *t_dec.values()))


def test_decompress_checks_outside_streams(jax_side):
    """Images of the wrong size and malformed containers raise; corrupted
    words decode to garbage without faulting (rANS has no integrity
    check)."""
    model = _port_model(jax_side["params"])
    codec = Codec(model, n_lanes=N_LANES, device="cpu")
    enc = codec.compress(jax_side["x"])
    good = enc["strings"][0]
    bad_cases = [
        [good[0][:40]] + good[1:],                         # truncated
        [good[0][:4] + np.asarray([8, 0], np.uint32).tobytes()] + good[1:],
        [good[0][:4] + b"\x00" * 8] + good[1:],            # no lane states
    ]
    with pytest.raises(ValueError, match="multiples of 64"):
        codec.compress(jax_side["x"][:, :48])
    other = Codec(model, n_lanes=2 * N_LANES, device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        other.decompress(enc["strings"], enc["shape"])
    for strings in bad_cases:
        with pytest.raises(ValueError):
            codec.decompress([strings, enc["strings"][1]], enc["shape"])
    body = bytearray(good[0])
    body[12 + 4 * N_LANES:] = bytes(len(body) - 12 - 4 * N_LANES)
    dec = codec.decompress([[bytes(body)] + good[1:], enc["strings"][1]],
                           enc["shape"])
    assert dec["y_hat"].shape == enc["y_hat"].shape
    assert torch.equal(dec["y_hat"][1], enc["y_hat"][1])


def test_jax_codec_decodes_port_streams(jax_side):
    """Share of the port's streams that the JAX device codec decodes to the
    port's y_hat -- recorded, not required."""
    model = _port_model(jax_side["params"])
    enc = Codec(model, n_lanes=N_LANES, device="cpu").compress(jax_side["x"])
    jcodec = JaxCodec(jax_side["model"], jax_side["params"], backend="device",
                      n_lanes=N_LANES)
    jcodec.update()
    dec = jcodec.decompress(enc["strings"], enc["shape"])
    y_j = np.asarray(dec["y_hat"])
    ok = [np.allclose(y_j[b], enc["y_hat"][b].numpy(), atol=1e-3)
          for b in range(SHAPE[0])]
    print(f"port streams decoded by the JAX codec: {sum(ok)}/{len(ok)}")
    assert y_j.shape == tuple(enc["y_hat"].shape)


def test_init_params_follow_flax_families(jax_side):
    """Seeded random weights: the deterministic initializers (GDN, LayerNorm,
    zero biases, the factorized prior's matrices and quantiles) equal
    flax's; random ones match in range and spread."""
    from mlic_tpu_torch.weights import init_params

    ref = from_flax(jax_side["params"])
    model = get_model("MLICPP_TINY")
    got = init_params(model, torch.Generator().manual_seed(0))
    again = init_params(model, torch.Generator().manual_seed(0))
    assert set(got) == set(ref)
    for k, v in got.items():
        r = ref[k]
        assert v.shape == r.shape and torch.equal(v, again[k]), k
        if r.std() == 0 or ".gdn." in k or ".igdn." in k or "norm" in k:
            torch.testing.assert_close(v, r, rtol=1e-6, atol=1e-7)
        elif "entropy_bottleneck.bias" in k:
            assert v.abs().max() <= 0.5
        elif r.numel() >= 2000:
            assert 0.8 < float(v.std() / r.std()) < 1.25, k
            # lecun_normal: truncated at +-2 of its (corrected) scale
            limit = 2.0 * (1.0 / np.prod(v.shape[1:])) ** 0.5 / 0.8796256610
            assert float(v.abs().max()) <= limit * (1 + 1e-6), k


def test_config_copy_matches(jax_side):
    from mlic_tpu.models.config import CONFIGS as JC
    from mlic_tpu_torch.models.config import CONFIGS as TC
    assert {k: dataclasses.asdict(v) for k, v in JC.items()} == \
        {k: dataclasses.asdict(v) for k, v in TC.items()}
