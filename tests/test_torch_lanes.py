"""The port's automatic rANS lane count (``Codec(n_lanes="auto")``) against
the JAX package's, on the CPU.

``auto_lanes`` equals ``mlic_tpu.codec.auto_lanes`` over every model
configuration and a grid of sizes; an auto codec on a 64x64 MLICPP_TINY
tile writes a 16-lane stream, as the JAX codec does for the same image and
weights, and that stream is shorter than a 512-lane one by at least the
lane state saved; a decode-only auto codec follows the header and decodes
bit-exactly; the width warning fires once; a stream wider than the
kernels take is refused with the reason; and the CLI writes a 16-lane
file that a fresh codec decodes.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from mlic_tpu import codec as jcodec
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch.codec import MAX_LANES, Codec, auto_lanes
from mlic_tpu_torch.entropy.stream import stream_lanes
from mlic_tpu_torch.models.config import CONFIGS
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.utils import bitstream
from mlic_tpu_torch.weights import from_flax, init_params


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


SIZES = (16, 48, 64, 100, 128, 192, 256, 500, 512, 768, 1024, 1080, 2048)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_auto_lanes_equals_jax(name):
    cfg = CONFIGS[name]
    for h in SIZES:
        for w in SIZES:
            assert auto_lanes(cfg, h, w) == jcodec.auto_lanes(cfg, h, w), \
                (name, h, w)


@pytest.fixture(scope="module")
def tiny():
    """MLICPP_TINY with flax-initialized weights in both packages and one
    seeded 64x64 image."""
    jmodel = jax_get_model("MLICPP_TINY")
    x = np.random.default_rng(5).random((1, 64, 64, 3), dtype=np.float32)
    params = jax.jit(lambda r, v: jmodel.init(r, v, True))(
        {"params": jax.random.key(1), "noise": jax.random.key(2)},
        x)["params"]
    model = get_model("MLICPP_TINY")
    model.load_state_dict(from_flax(params), strict=True)
    codec = Codec(model, device="cpu")
    enc = codec.compress(x)
    return {"jmodel": jmodel, "params": params, "x": x, "model": model,
            "codec": codec, "enc": enc}


def test_auto_codec_writes_16_lanes_like_jax(tiny):
    assert tiny["codec"].n_lanes == 16
    assert stream_lanes(tiny["enc"]["strings"][0][0]) == 16
    jc = jcodec.Codec(tiny["jmodel"], tiny["params"], backend="device")
    jc.update()
    jenc = jc.compress(tiny["x"])
    assert jc.n_lanes == 16
    assert stream_lanes(jenc["strings"][0][0]) == 16


def test_auto_stream_shorter_than_512_lanes(tiny):
    """The 16-lane stream saves (512 - 16) x 4 B of lane state, less the
    renorm words its lanes emit where the 512 lanes' states would have held
    the same bits (a few words on this tile): the byte accounting of the
    two headers holds exactly, both code the same escapes, and the saving
    is at least 95% of the state's bytes."""
    wide = Codec(tiny["model"], n_lanes=512, device="cpu")
    enc = wide.compress(tiny["x"])
    assert torch.equal(enc["y_hat"], tiny["enc"]["y_hat"])
    s512, s16 = enc["strings"][0][0], tiny["enc"]["strings"][0][0]
    (n512, e512), (n16, e16) = (np.frombuffer(s[4:12], np.uint32).astype(int)
                                for s in (s512, s16))
    extra = (n16 - 2 * 16) - (n512 - 2 * 512)     # renorm words 16 lanes add
    saved = len(s512) - len(s16)
    assert e512 == e16
    assert saved == 4 * (512 - 16) - 2 * extra + 2 * (n512 % 2 - n16 % 2)
    assert 0 <= extra and saved >= 0.95 * 4 * (512 - 16), (saved, extra)


def test_decode_only_auto_codec_follows_header(tiny):
    fresh = Codec(tiny["model"], device="cpu")
    assert fresh.n_lanes is None
    dec = fresh.decompress(tiny["enc"]["strings"], tiny["enc"]["shape"])
    assert fresh.n_lanes == 16
    assert torch.equal(dec["y_hat"], tiny["enc"]["y_hat"])
    assert torch.equal(dec["x_hat"], tiny["enc"]["x_hat"])


def test_width_warning_fires_once(tiny):
    codec = Codec(tiny["model"], device="cpu")
    codec.compress(tiny["x"])
    big = np.zeros((1, 256, 256, 3), np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        codec.compress(big)
        codec.compress(big)
    msgs = [str(w.message) for w in caught if "n_lanes=16" in str(w.message)]
    assert len(msgs) == 1 and "256x256" in msgs[0]
    # an explicit width never warns
    fixed = Codec(tiny["model"], n_lanes=16, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fixed.compress(big)
    assert not [w for w in caught if "n_lanes" in str(w.message)]


@pytest.mark.parametrize("lanes", [2048, 4096])
def test_wider_stream_refused_with_reason(tiny, lanes):
    s = tiny["enc"]["strings"][0][0]
    head = np.frombuffer(s[:4], np.uint32)[0]
    wide = (np.uint32(head & ~np.uint32(0xFFFF)) | np.uint32(lanes)).tobytes()
    assert stream_lanes(wide + s[4:]) == lanes
    fresh = Codec(tiny["model"], device="cpu")
    with pytest.raises(ValueError, match=f"at most {MAX_LANES} lanes"):
        fresh.decompress([[wide + s[4:]], [b""]], tiny["enc"]["shape"])
    assert fresh.n_lanes is None


def test_cli_writes_16_lane_file(tmp_path, tiny):
    Image = pytest.importorskip("PIL.Image")
    from mlic_tpu_torch.tools import test as cli

    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        tmp_path / "a.png")
    out = tmp_path / "out"
    res = cli.main(["--cpu", "--model", "MLICPP_TINY", "--dataset",
                    str(tmp_path), "--save-dir", str(out)])
    assert res["n_images"] == 1
    (path,) = [os.path.join(out, f) for f in os.listdir(out)]
    with open(path, "rb") as f:
        bitstream.read_uints(f, 2)
        strings, shape = bitstream.read_body(f)
    assert stream_lanes(strings[0][0]) == 16
    # a fresh decode-only codec with the CLI's seeded weights decodes it
    # to what an encoder with those weights reconstructs
    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    dec = Codec(model, device="cpu").decompress(strings, shape)
    x = np.asarray(Image.open(tmp_path / "a.png"), np.float32)[None] / 255.0
    enc = Codec(model, device="cpu").compress(x)
    assert torch.equal(dec["x_hat"], enc["x_hat"])
