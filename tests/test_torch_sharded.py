"""The sharded codec on the CPU (``parallel/serving.py``; the shape of
``tests/test_serving_sharded.py``): replicas on a list that names the CPU
several times, MLICPP_TINY at 64x64 and 16 lanes.  Its streams must be
byte-identical to the single codec's for the whole batch (in f32 on the
CPU the shards analyse each image as the batch does) and per shard, its
decode bit-exact against its own encode, under formats v4 and v3; the
two-deep pipeline runs; a batch that does not divide over the shards
raises; ``tools.serve --sharded`` reports the shards."""

import copy
import json

import numpy as np
import pytest
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.parallel.serving import ShardedCodec
from mlic_tpu_torch.tools import serve as tserve
from mlic_tpu_torch.weights import init_params

LANES = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (see
    ``test_torch_train.py``: six xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    m = get_model("MLICPP_TINY")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(1)))
    return m


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).random((8, 64, 64, 3), dtype=np.float32)


@pytest.mark.parametrize("unified_z", ["1", "0"], ids=["v4", "v3"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_streams_match_single_device(model, frames, monkeypatch, n_shards,
                                     unified_z):
    monkeypatch.setenv("MLIC_UNIFIED_Z", unified_z)
    ref = Codec(copy.deepcopy(model), n_lanes=LANES, device="cpu")
    ref.update()
    want = ref.compress(frames)
    sc = ShardedCodec(copy.deepcopy(model), ["cpu"] * n_shards,
                      n_lanes=LANES, encode_recon=True)
    sc.update()
    assert sc.n_shards == n_shards and len(sc.replicas) == n_shards
    assert sc.parametric and sc.analytic_enc_rows
    assert sc.unified_z == (unified_z == "1")
    enc = sc.compress(frames)
    assert "y_hat" not in enc
    assert enc["strings"][0] == want["strings"][0]
    assert enc["strings"][1] == want["strings"][1]
    assert (not any(enc["strings"][1])) == (unified_z == "1")
    per = len(frames) // n_shards
    for i in range(n_shards):        # each shard is the codec of its images
        part = ref.compress(frames[i * per:(i + 1) * per])
        assert enc["strings"][0][i * per:(i + 1) * per] == \
            part["strings"][0]
    dec = sc.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert dec["x_hat"].shape == (8, 64, 64, 3)
    ref_dec = ref.decompress(want["strings"], want["shape"])
    torch.testing.assert_close(dec["y_hat"], ref_dec["y_hat"], rtol=0,
                               atol=0)


def test_pipeline_and_divisibility_guard(model, frames):
    sc = ShardedCodec(copy.deepcopy(model), ["cpu", "cpu"], n_lanes=LANES,
                      encode_recon=True)
    batches = [frames[:4], frames[4:], frames[::-1][:4].copy()]
    outs = list(sc.roundtrip_stream(batches))
    assert len(outs) == 3
    for (enc, dec), x in zip(outs, batches):
        assert enc["strings"][0] == sc.compress(x)["strings"][0]
        assert torch.equal(dec["x_hat"], enc["x_hat"])
    with pytest.raises(ValueError, match="divisible"):
        sc.compress(frames[:3])
    with pytest.raises(ValueError, match="divisible"):
        enc = sc.compress(frames[:4])
        sc.decompress([s[:3] for s in enc["strings"]], enc["shape"])
    with pytest.raises(ValueError, match="at least one device"):
        ShardedCodec(model, [])


def test_serve_cli_sharded(capsys):
    out = tserve.main(["--cpu", "--sharded", "--model", "MLICPP_TINY",
                       "--synthetic", "--n", "4", "--batch", "2", "--size",
                       "64", "128", "--lanes", str(LANES), "--verify"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["sharded"] is True and out["shards"] == 1
    assert out["images"] == 4 and out["verify"] is True
    assert out["parametric"] is True and out["analytic_enc_rows"] > 0
    plain = tserve.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic",
                         "--n", "4", "--batch", "2", "--size", "64", "128",
                         "--lanes", str(LANES)])
    assert plain["sharded"] is False and plain["shards"] == 1
    assert plain["bpp"] == out["bpp"]
