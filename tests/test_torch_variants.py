"""The port's model variants against the JAX package, on the CPU.

MLICPP_TINY (N=32, M=64, 2 slices) with one field replaced at a time, as
``tests/test_variants.py`` builds them: the small decoder (dense encoder,
N//4 synthesis, h_s at M//4, the wide LRP, the dense (96, 96) channel
context), the dense-convolution twin, the old synthesis head, and ten
slices at M=80.  Both frameworks run the same weights (the port's seeded
ones, mapped to the flax layout by ``weights.to_flax``) and the same z
noise (JAX's draw, read from its bottleneck's output); f32 values agree
within 1e-5 (relative to the tensor's scale where it exceeds 1), the
tolerance of the JAX package's own variant tests.  The round trips are
the port's own,
bit-exact.  The decoder-only deployment (``tools/extract_decoder`` and
``tools/decode``) runs MLICPP_M_SMALL_DEC at its full width on 64x64
frames.  The whole-model JAX programs compile at XLA optimization level 0.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mlic_tpu.models.config import model_config as jax_model_config
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.eval import compress_one_image, decompress_one_image
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import decode as tdecode
from mlic_tpu_torch.tools import extract_decoder as textract
from mlic_tpu_torch.weights import init_params, to_flax
from tools import extract_decoder as jextract


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


BASE = "MLICPP_TINY"
VARIANTS = {
    "small_decoder": {"small_decoder": True},
    "dense": {"depthwise": False},
    "old_head": {"old_synthesis": True},
    "ten_slices": {"M": 80, "slice_num": 10},
}
SHAPE = (2, 64, 64, 3)
CODEC_SHAPE = (2, 64, 128, 3)
SEED = 0
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port(overrides, name=BASE, seed=SEED):
    m = get_model(name, **overrides)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(seed)))
    return m


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_flax(variant):
    """The training forward: x_hat and the y and z likelihoods."""
    overrides = VARIANTS[variant]
    port = _port(overrides)
    params = to_flax(port.state_dict())
    model = type(jax_get_model(BASE))(
        cfg=dataclasses.replace(jax_model_config(BASE), **overrides))
    x = np.random.default_rng(1).random(SHAPE, dtype=np.float32)

    def keep(mdl, name):
        return name == "__call__" and mdl.name in ("entropy_bottleneck", "h_a")

    def f(p, v, key):
        out, inter = model.apply({"params": p}, v, True, rngs={"noise": key},
                                 capture_intermediates=keep,
                                 mutable=["intermediates"])
        return out, inter["intermediates"]

    args = (params, x, jax.random.key(3))
    out, inter = jax.jit(f).lower(*args).compile(FAST_COMPILE)(*args)
    z = np.asarray(inter["h_a"]["__call__"][0])
    z_tilde = np.asarray(inter["entropy_bottleneck"]["__call__"][0][0])
    b, h, w, c = z.shape
    noise = np.ascontiguousarray((z_tilde - z).reshape(b * h * w, c).T)
    with torch.no_grad():
        got = port(torch.from_numpy(x), True, torch.from_numpy(noise))
    _close(got["x_hat"].numpy(), out["x_hat"])
    for k in ("y", "z"):
        _close(_nhwc(got["likelihoods"][k]), out["likelihoods"][k])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_round_trip_bit_exact(variant):
    """The port's compress -> decompress on the CPU: y_hat and x_hat
    bit-identical, finite."""
    codec = Codec(_port(VARIANTS[variant]), device="cpu")
    x = np.random.default_rng(2).integers(0, 256, CODEC_SHAPE,
                                          dtype=np.uint8)
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    assert torch.isfinite(dec["x_hat"]).all()
    assert enc["y_hat"].shape[-1] == codec.model.cfg.M


def test_extract_decoder_keeps_the_jax_keys():
    """The port's ``strip_encoder`` keeps exactly the leaves that JAX's
    ``tools/extract_decoder.strip_encoder`` keeps of the same tree."""
    state = _port(VARIANTS["small_decoder"]).state_dict()
    want = set(_leaves(jextract.strip_encoder(to_flax(state))))
    got = set(_leaves(to_flax(textract.strip_encoder(state))))
    assert got == want
    assert {k[0][0] for k in _leaves(to_flax(state))} \
        - {k[0][0] for k in got} == {"g_a", "h_a"}


@pytest.mark.parametrize("name,level", [("MLICPP_M_SMALL_DEC", None),
                                        ("MLICPP_M_SMALL_DEC_VBR", 2)])
def test_decode_cli_from_a_decoder_only_file(tmp_path, name, level):
    """MLICPP_M_SMALL_DEC(_VBR) at full width: the full weights as a torch
    file, ``extract_decoder`` to a decoder-only file, two 64x64-padded
    frames (one cropped) written by ``compress_one_image``, then
    ``tools.decode --cpu``: its x_hat equals ``decompress_one_image``'s of
    the full model bit for bit, and its PNGs hold that x_hat rounded."""
    full = _port({}, name)
    torch.save(full.state_dict(), tmp_path / "full.pt")
    kept = textract.main(["--checkpoint", str(tmp_path / "full.pt"),
                          "--out", str(tmp_path / "decoder.pt")])
    assert set(kept) == {k for k in full.state_dict()
                         if k.split(".")[0] not in ("g_a", "h_a")}
    bits = tmp_path / "bits"
    bits.mkdir()
    rng = np.random.default_rng(5)
    frames = [rng.random((1, 64, 64, 3), dtype=np.float32),
              rng.random((1, 60, 50, 3), dtype=np.float32)]
    enc_codec = Codec(full, device="cpu")
    for i, x in enumerate(frames):
        compress_one_image(enc_codec, x, str(bits / f"img_{i}.bin"), s=level)
    argv = ["--model", name, "--bitstream-dir", str(bits), "--output-dir",
            str(tmp_path / "png"), "--checkpoint",
            str(tmp_path / "decoder.pt"), "--cpu"]
    argv += ["--vbr"] if level is not None else []
    got = tdecode.main(argv)
    ref_codec = Codec(_port({}, name), device="cpu")
    assert sorted(got) == ["img_0.bin", "img_1.bin"]
    for i, x in enumerate(frames):
        want = decompress_one_image(ref_codec, str(bits / f"img_{i}.bin"),
                                    vbr=level is not None)["x_hat"]
        assert want.shape == x.shape
        np.testing.assert_array_equal(got[f"img_{i}.bin"], want)
        png = np.asarray(Image.open(tmp_path / "png" / f"img_{i}.png"))
        np.testing.assert_array_equal(png, np.clip(
            want[0] * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_decoder_only_file_rule(tmp_path):
    """A decoder-only file loads with the encoder's leaves left at their
    construction values; a file without one of the decoder's leaves is
    refused, naming it."""
    model = _port(VARIANTS["small_decoder"])
    state = textract.strip_encoder(model.state_dict())
    torch.save(state, tmp_path / "decoder.pt")
    fresh = get_model(BASE, **VARIANTS["small_decoder"])
    merged = tdecode.decoder_state(fresh, str(tmp_path / "decoder.pt"))
    assert all(torch.equal(merged[k], state[k]) for k in state)
    assert all(not merged[k].any() for k in merged if k not in state)
    del state["h_s.c0.dw.depth.weight"]
    torch.save(state, tmp_path / "short.pt")
    with pytest.raises(ValueError, match="h_s.c0.dw.depth.weight"):
        tdecode.decoder_state(fresh, str(tmp_path / "short.pt"))


def test_trained_l_loads_strictly_and_round_trips():
    """The flagship MLICPP_L on its trained weights (the bfloat16 orbax
    directory, widened to f32): a strict load, and a bit-exact round trip
    of a dead-leaves frame at a rate far below the seeded models'."""
    from mlic_tpu_torch.data.folder import dead_leaves_pool
    from mlic_tpu_torch.weights import load_checkpoint
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = get_model("MLICPP_L")
    res = model.load_state_dict(load_checkpoint(
        os.path.join(root, "ckpts", "bench_default_MLICPP_L")), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    codec = Codec(model, device="cpu")
    x = dead_leaves_pool(1, 64, SEED, width=128, cache_dir="")
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    bpp = 8.0 * len(enc["strings"][0][0]) / (64 * 128)
    assert 0.0 < bpp < 4.0, bpp


def test_eval_cli_small_decoder_twin_at_a_level(tmp_path):
    """``tools.test --model MLICPP_M_SMALL_DEC_VBR --level 4`` on the CPU:
    one image through a file whose VBR header records the level."""
    from mlic_tpu_torch.tools import test as ttest
    data = tmp_path / "images"
    data.mkdir()
    Image.fromarray(np.random.default_rng(7).integers(
        0, 256, (64, 96, 3), dtype=np.uint8)).save(data / "a.png")
    res = ttest.main(["--cpu", "--model", "MLICPP_M_SMALL_DEC_VBR",
                      "--dataset", str(data), "--save-dir",
                      str(tmp_path / "eval"), "--level", "4"])
    assert res["n_images"] == 1 and np.isfinite(res["psnr"])
    with open(tmp_path / "eval" / "img_000.bin", "rb") as f:
        assert tuple(np.frombuffer(f.read(16), ">u4")) == (64, 96, 4, 0)
