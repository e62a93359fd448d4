"""Stream format v3 in the port, on the CPU (MLICPP_TINY, seeded weights,
[2, 64, 64, 3], 16 lanes; every comparison exact).

The port's host coder ``encode_global``/``decode_global`` against the JAX
package's on random symbols with 3% escapes; a device codec under
``MLIC_UNIFIED_Z=0``: bit-exact round trips, bit 31 without bit 30 and
non-empty z strings, the y streams the port's and the JAX
``encode_global`` of the port's own padded phases over the port's tables
(and the port's ``decode_global`` of them those phases), the z strings the
JAX ``encode_with_indexes``; v4 and
steps codecs reading v3, an image of a batch decoding alone, the routing
of steps streams whose first word has bit 31 set and of damaged v3
streams; and ``tools.ab_stream_format`` at TINY.
"""

import json

import numpy as np
import pytest
import torch

from mlic_tpu.entropy.models import GaussianConditionalTables as JaxGC
from mlic_tpu.entropy.models import entropy_bottleneck_tables as jax_eb
from mlic_tpu.entropy.rans import coder as jax_coder
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.entropy.rans import coder
from mlic_tpu_torch.entropy.stream import (
    stream_is_damaged_global,
    stream_is_global,
)
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import ab_stream_format
from mlic_tpu_torch.weights import init_params, to_flax

SHAPE = (2, 64, 64, 3)
N_LANES = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (the
    suite's xdist workers share the cores; see test_torch_codec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codec(model, monkeypatch, unified="1", backend="device"):
    monkeypatch.setenv("MLIC_UNIFIED_Z", unified)
    c = Codec(model, n_lanes=N_LANES, device="cpu", backend=backend)
    c.update()
    return c


@pytest.fixture(scope="module")
def coded():
    """{name: (codec, compress result)} of one TINY model and batch: v3,
    v4, and the steps backend."""
    m = get_model("MLICPP_TINY")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    x = np.random.default_rng(2).random(SHAPE, dtype=np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, args in (("v3", ("0",)), ("v4", ("1",)),
                           ("steps", ("1", "steps"))):
            c = _codec(m, mp, *args)
            out[name] = (c, c.compress(x))
    out["x"] = x
    return out


@pytest.mark.parametrize("lanes", [1, 16, 32])
def test_encode_global_and_decode_global_match_jax(lanes):
    gc = JaxGC.create()
    tabs = (gc.quantized_cdf, gc.cdf_length, gc.offset)
    rng = np.random.default_rng(lanes)
    n = 512
    idx = rng.integers(0, len(gc.cdf_length), n)
    sym = np.rint(rng.standard_normal(n) * 4)
    esc = np.zeros(n, bool)
    esc[rng.choice(n, n * 3 // 100, replace=False)] = True
    sym = np.where(esc, rng.choice([-1, 1], n) * (4000 + rng.integers(
        0, 1000, n)), sym).astype(np.int32)
    assert esc.any()
    got = coder.encode_global(sym, idx, lanes, *tabs)
    assert got == jax_coder.encode_global(sym, idx, lanes, *tabs)
    assert stream_is_global(got)
    np.testing.assert_array_equal(coder.decode_global(got, idx, *tabs), sym)
    np.testing.assert_array_equal(jax_coder.decode_global(got, idx, *tabs),
                                  sym)


def test_v3_round_trip_and_header(coded):
    codec, enc = coded["v3"]
    assert not codec.unified_z
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    for y, z in zip(*enc["strings"]):
        head = int(np.frombuffer(y[:4], np.uint32)[0])
        assert head >> 31 == 1 and not head >> 30 & 1 and len(z) > 0
        assert stream_is_global(y) and head & 0xFFFF == N_LANES


def _padded_phases(codec, x):
    """The port's y symbols and scale indexes of ``x`` per image, each phase
    padded to the lanes with pad-row symbols, and z [B, zh, zw, N]."""
    model = codec.model
    with torch.no_grad():
        y, z = model.analyze(torch.from_numpy(x))
        y_hat, sym, idx = model.codec_encode_pass(y, z)
    n_ph = 2 * model.cfg.slice_num
    n_per = sym.shape[1] // n_ph
    pad = -n_per % N_LANES
    pad_row = len(codec._gauss[1]) - 1
    phases = [(np.pad(sym[b].numpy().reshape(n_ph, n_per),
                      ((0, 0), (0, pad))).ravel(),
               np.pad(idx[b].numpy().reshape(n_ph, n_per), ((0, 0), (0, pad)),
                      constant_values=pad_row).ravel())
              for b in range(len(sym))]
    return y_hat, phases, z.numpy()


def test_v3_streams_equal_jax_coder(coded):
    """y: the JAX ``encode_global`` of the port's padded phases over the
    port's own Gaussian rows; z: the JAX ``encode_with_indexes`` over the
    JAX package's factorized-prior tables."""
    codec, enc = coded["v3"]
    model = codec.model
    y_hat, phases, z = _padded_phases(codec, coded["x"])
    assert torch.equal(y_hat, enc["y_hat"])
    _, lengths, offsets, table = codec._gauss
    eb = jax_eb(to_flax(model.state_dict())["entropy_bottleneck"],
                model.cfg.N)
    rows = np.broadcast_to(np.arange(z.shape[-1], dtype=np.int32),
                           z.shape[1:]).ravel()
    for b, (s, i) in enumerate(phases):
        assert enc["strings"][0][b] == jax_coder.encode_global(
            s, i, N_LANES, table, lengths, offsets)
        assert enc["strings"][1][b] == jax_coder.encode_with_indexes(
            z[b].ravel(), rows, *eb[:3])


def test_v3_streams_equal_port_coder(coded):
    """The device encoder's y streams are the port's host ``encode_global``
    of the same padded phases, and ``decode_global`` reads them back."""
    codec, enc = coded["v3"]
    _, lengths, offsets, table = codec._gauss
    _, phases, _ = _padded_phases(codec, coded["x"])
    for b, (s, i) in enumerate(phases):
        y = enc["strings"][0][b]
        assert y == coder.encode_global(s, i, N_LANES, table, lengths,
                                        offsets)
        np.testing.assert_array_equal(
            coder.decode_global(y, i, table, lengths, offsets), s)


def test_every_codec_reads_v3(coded):
    _, enc = coded["v3"]
    for name in ("v4", "steps"):
        codec = coded[name][0]
        dec = codec.decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"]), name
        assert torch.equal(dec["x_hat"], enc["x_hat"]), name
    v3 = coded["v3"][0]
    for name in ("v4", "steps"):
        other = coded[name][1]
        dec = v3.decompress(other["strings"], other["shape"])
        assert torch.equal(dec["y_hat"], other["y_hat"]), name


def test_an_image_of_a_v3_batch_decodes_alone(coded):
    codec, enc = coded["v3"]
    for i in range(SHAPE[0]):
        dec = codec.decompress([[enc["strings"][0][i]],
                                [enc["strings"][1][i]]], enc["shape"])
        assert torch.equal(dec["y_hat"][0], enc["y_hat"][i])


def test_routing_of_bit_31_steps_streams_and_damaged_v3(coded):
    """A steps y stream whose first word has bit 31 set decodes on the host
    (the seed searched until one has it); a v3 stream cut short or padded
    raises."""
    steps = coded["steps"][0]
    for seed in range(20):
        x = np.random.default_rng(100 + seed).random((1, 64, 64, 3),
                                                     dtype=np.float32)
        enc = steps.compress(x)
        y = enc["strings"][0][0]
        if np.frombuffer(y[:4], np.uint32)[0] >> 31:
            break
    else:
        pytest.fail("no steps stream with bit 31 in 20 seeds")
    assert not stream_is_global(y) and not stream_is_damaged_global(y)
    dec = coded["v3"][0].decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    v3, enc3 = coded["v3"]
    for cut in (enc3["strings"][0][0][:-2], enc3["strings"][0][0][:-4],
                enc3["strings"][0][0] + b"\0" * 4):
        assert stream_is_damaged_global(cut) and not stream_is_global(cut)
        bad = [[cut, enc3["strings"][0][1]], enc3["strings"][1]]
        with pytest.raises(ValueError, match="truncated or padded"):
            v3.decompress(bad, enc3["shape"])


def test_ab_stream_format_tool(tmp_path, monkeypatch, capsys):
    """``tools.ab_stream_format`` at TINY on the CPU: batch 2, one segment
    of each format in each regime, every segment bit-exact."""
    monkeypatch.setenv("MLIC_POOL_CACHE", "")
    out = ab_stream_format.main([
        "--cpu", "--seeded", "--model", "MLICPP_TINY", "--batch", "2",
        "--seg", "1", "--reps", "1", "--size", "64", "64", "--lanes", "16"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(out))
    assert out["bit_exact"] and set(out["bpp"]) == {"v3", "v4"}
    for f in ("v3", "v4"):
        assert out["tables"][f]["parametric"]
        assert out["tables"][f]["analytic_enc_rows"] > 0
    for regime in ("staged", "host_upload"):
        assert set(out[regime]) == {"v3", "v4", "v4_over_v3_paired",
                                    "v4_over_v3_median"}
        assert len(out[regime]["v3"]["all"]) == 1
