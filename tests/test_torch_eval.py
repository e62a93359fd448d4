"""The port's evaluation path against the JAX package's, on the CPU.

Padding, cropping and the blur equal ``mlic_tpu.eval``'s on the same arrays;
container files are byte-identical to ``mlic_tpu.utils.bitstream``'s and
each package reads the other's; PSNR / SSIM / MS-SSIM agree with
``mlic_tpu.metrics`` (1e-5; 1e-4 for MS-SSIM, a product of five powers);
``evaluate_codec`` runs end to end on MLICPP_TINY with the fused switch off
and on, as tests/test_eval.py does for JAX; the CLI runs on a folder of
generated PNGs; and the slice as a whole -- pad, compress, file, decompress,
crop with the fused tails on -- agrees with the JAX codec on converted
weights.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mlic_tpu import eval as jev
from mlic_tpu import metrics as jmetrics
from mlic_tpu.codec import Codec as JaxCodec
from mlic_tpu.data import folder as jfolder
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu.utils import bitstream as jbits
from mlic_tpu_torch import eval as tev
from mlic_tpu_torch import metrics as tmetrics
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.data import folder as tfolder
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.utils import bitstream as tbits
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


SWITCH = "MLIC_FUSED_BLOCKS"
N_LANES = 32


@pytest.fixture(scope="module")
def codec():
    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model,
                                      torch.Generator().manual_seed(0)))
    codec = Codec(model, n_lanes=N_LANES, device="cpu")
    codec.update()
    return codec


@pytest.mark.parametrize("shape", [(1, 200, 280, 3), (2, 64, 128, 3),
                                   (1, 70, 90, 3)])
def test_pad_and_crop_equal_jax(shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    got, hw = tev.pad_to_multiple(x)
    ref, hw_ref = jev.pad_to_multiple(x)
    assert hw == hw_ref == shape[1:3]
    assert got.shape[1] % 64 == 0 and got.shape[2] % 64 == 0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tev.crop_to(got, hw), x)


@pytest.mark.parametrize("sigma,ksize", [(1.0, 5), (2.0, 7)])
def test_gaussian_blur_equals_jax(sigma, ksize):
    x = np.random.default_rng(1).random((1, 32, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tev._gaussian_blur(x, sigma, ksize),
                                  jev._gaussian_blur(x, sigma, ksize))


def test_container_bytes_equal_jax_and_cross_read():
    rng = np.random.default_rng(2)
    strings = [[rng.bytes(137)], [b""]]
    files = []
    for mod in (tbits, jbits):
        f = io.BytesIO()
        mod.write_uints(f, (500, 750))
        n = mod.write_body(f, (8, 12), strings)
        assert n == 12 + 4 + 137 + 4
        files.append(f.getvalue())
    assert files[0] == files[1]
    for mod in (tbits, jbits):          # each reads what the other wrote
        f = io.BytesIO(files[0])
        assert mod.read_uints(f, 2) == (500, 750)
        got, shape = mod.read_body(f)
        assert got == strings and shape == (8, 12)
    with pytest.raises(ValueError, match="per-image"):
        tbits.write_body(io.BytesIO(), (1, 1), [[b"a", b"b"], [b""]])
    f = io.BytesIO()
    tbits.write_uchars(f, (1, 2, 255))
    f.seek(0)
    assert tbits.read_uchars(f, 3) == (1, 2, 255)


def _image_pair(seed, h=192, w=192):
    rng = np.random.default_rng(seed)
    a = rng.random((2, h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1) \
        .astype(np.float32)
    return a, b


@pytest.mark.parametrize("name,tol", [("psnr", 1e-5), ("ssim", 1e-5),
                                      ("ms_ssim", 1e-4)])
def test_metrics_match_jax(name, tol):
    a, b = _image_pair(3)
    got = getattr(tmetrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(ref), atol=tol, rtol=tol)


def test_ms_ssim_odd_size_and_flat_regions_match_jax():
    """Odd dims take the edge-padded downsample; flat disks the clamps."""
    pool = tfolder.dead_leaves_pool(1, 181, seed=4, width=203, cache_dir="")
    a = pool.astype(np.float32) / 255.0
    b = jev._gaussian_blur(a)
    got = tmetrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b))
    ref = jmetrics.ms_ssim(jnp.asarray(a), jnp.asarray(b))
    assert 0.0 < float(got) <= 1.0
    np.testing.assert_allclose(float(got), float(ref), atol=1e-4, rtol=1e-4)


def test_dead_leaves_pool_equals_jax():
    kw = dict(seed=5, n_disks=40, cache_dir="", width=80)
    got = tfolder.dead_leaves_pool(2, 48, **kw)
    assert got.shape == (2, 48, 80, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jfolder.dead_leaves_pool(2, 48, **kw))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_evaluate_codec_end_to_end(tmp_path, monkeypatch, codec, fused):
    monkeypatch.setenv(SWITCH, fused)
    rng = np.random.default_rng(7)
    imgs = [rng.random((70, 90, 3), dtype=np.float32) for _ in range(2)]
    lines = []
    out = tev.evaluate_codec(codec, imgs, str(tmp_path / fused),
                             log=lines.append)
    assert out["n_images"] == 2 and len(lines) == 2
    assert out["bpp"] > 0 and np.isfinite(out["psnr"])
    assert np.isnan(out["ms_ssim"])                 # below 176 pixels
    files = sorted(p.name for p in (tmp_path / fused).iterdir())
    assert files == ["img_000.bin", "img_001.bin"]
    # the file is the whole message: header (H, W) + body
    with open(tmp_path / fused / "img_000.bin", "rb") as f:
        assert jbits.read_uints(f, 2) == (70, 90)
        strings, shape = jbits.read_body(f)
    assert shape == (2, 2) and len(strings) == 2 and strings[1] == [b""]


def test_evaluate_codec_ms_ssim_and_extra_metric(tmp_path, codec):
    img = np.random.default_rng(8).random((1, 180, 190, 3), dtype=np.float32)
    out = tev.evaluate_codec(
        codec, [img], str(tmp_path), log=lambda *_: None,
        extra_metrics={"mae": lambda x_hat, x: np.abs(x_hat - x).mean()})
    assert 0.0 < out["ms_ssim"] <= 1.0 and out["mae"] > 0


def test_one_image_round_trip_is_bit_exact(tmp_path, monkeypatch, codec):
    monkeypatch.setenv(SWITCH, "1")
    x = np.random.default_rng(9).random((1, 70, 90, 3), dtype=np.float32)
    path = str(tmp_path / "one.bin")
    enc = tev.compress_one_image(codec, x, path)
    dec = tev.decompress_one_image(codec, path)
    assert enc["x_hat_enc"].shape == dec["x_hat"].shape == x.shape
    np.testing.assert_array_equal(dec["x_hat"], enc["x_hat_enc"])
    assert enc["bpp"] == 8.0 * (tmp_path / "one.bin").stat().st_size / (70 * 90)
    with pytest.raises(ValueError, match="per-image"):
        tev.compress_one_image(codec, np.zeros((2, 64, 64, 3), np.float32),
                               path)


def test_vbr_levels_are_not_ported(tmp_path, codec):
    """Since the VBR models were ported, a level is taken: a fixed-rate
    codec ignores it but writes the VBR header (H, W, level, inputscale's
    f32 bits), which ``decompress_one_image(vbr=True)`` reads; an
    ``inputscale`` without a level, which no header could record, is
    refused."""
    x = np.random.default_rng(12).random((1, 64, 64, 3), dtype=np.float32)
    path = str(tmp_path / "a.bin")
    plain = tev.compress_one_image(codec, x, str(tmp_path / "plain.bin"))
    enc = tev.compress_one_image(codec, x, path, s=1, inputscale=0.25)
    with open(path, "rb") as f:
        h, w, s, bits = jbits.read_uints(f, 4)
    assert (h, w, s) == (64, 64, 1)
    assert np.uint32(bits).view(np.float32) == np.float32(0.25)
    assert (tmp_path / "a.bin").stat().st_size == \
        (tmp_path / "plain.bin").stat().st_size + 8
    dec = tev.decompress_one_image(codec, path, vbr=True)
    np.testing.assert_array_equal(dec["x_hat"], enc["x_hat_enc"])
    np.testing.assert_array_equal(plain["x_hat_enc"], enc["x_hat_enc"])
    with pytest.raises(ValueError, match="inputscale"):
        tev.compress_one_image(codec, x, path, inputscale=0.5)
    res = tev.evaluate_codec(codec, [x[0]], str(tmp_path / "ev"), s=0)
    assert res["n_images"] == 1 and res["bpp"] > 0


@pytest.fixture(scope="module")
def vbr_codec():
    model = get_model("MLICPP_TINY_VBR")
    model.load_state_dict(init_params(model,
                                      torch.Generator().manual_seed(0)))
    return Codec(model, n_lanes=N_LANES, device="cpu")


def test_vbr_file_round_trip(tmp_path, vbr_codec):
    """A VBR model through files at every level and at an ``inputscale``:
    each decodes from its header bit-exactly, the rate rises with the
    level, and ``evaluate_codec_vbr`` writes one folder a level."""
    x = np.random.default_rng(13).random((1, 70, 90, 3), dtype=np.float32)
    bpps = []
    for s, isc in ((0, 0.0), (1, 0.0), (2, 0.0), (1, 0.7)):
        path = str(tmp_path / f"l{s}_{isc}.bin")
        enc = tev.compress_one_image(vbr_codec, x, path, s=s, inputscale=isc)
        dec = tev.decompress_one_image(vbr_codec, path, vbr=True)
        np.testing.assert_array_equal(dec["x_hat"], enc["x_hat_enc"])
        bpps.append(enc["bpp"])
    assert bpps[0] < bpps[1] < bpps[2]
    res = tev.evaluate_codec_vbr(vbr_codec, [x[0]], str(tmp_path / "ev"),
                                 levels=[0, 2], log=lambda line: None)
    assert sorted(res) == [0, 2] and res[0]["bpp"] < res[2]["bpp"]
    assert sorted(p.name for p in (tmp_path / "ev").iterdir()) == \
        ["level_0", "level_2"]


class _RateOfDetail:
    """A stand-in codec whose stream grows with the image's horizontal
    detail, so that blurring lowers the rate."""

    def __init__(self):
        self.seen = []

    def compress(self, x):
        n = int(np.abs(np.diff(x, axis=2)).sum())
        self.seen.append(n)
        return {"strings": [[b"\0" * n], [b""]], "shape": (1, 1),
                "x_hat": torch.zeros(x.shape), "cost_time": 0.0}


def test_bpp_constrained_blurs_until_under_bound(tmp_path):
    x = np.random.default_rng(10).random((1, 64, 64, 3)).astype(np.float32)
    path = str(tmp_path / "c.bin")
    fake = _RateOfDetail()
    first = tev.compress_one_image(fake, x, path)["bpp"]
    out = tev.compress_bpp_constrained(fake, x, path, max_bpp=first / 4)
    assert 0 < out["blur_rounds"] < 8 and out["bpp"] <= first / 4
    assert fake.seen[1:] == sorted(fake.seen[1:], reverse=True)
    assert tev.compress_bpp_constrained(
        fake, x, path, max_bpp=first)["blur_rounds"] == 0
    assert tev.compress_bpp_constrained(
        fake, x, path, max_bpp=0.0, max_rounds=2)["blur_rounds"] == 2


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_cli_on_a_folder_of_pngs(tmp_path, monkeypatch, capsys,
                                 with_checkpoint):
    Image = pytest.importorskip("PIL.Image")
    from mlic_tpu_torch.tools import test as cli

    monkeypatch.setenv(SWITCH, "1")
    data = tmp_path / "data" / "sub"
    data.mkdir(parents=True)
    pool = tfolder.dead_leaves_pool(2, 70, seed=11, n_disks=30, cache_dir="",
                                    width=90)
    for i, img in enumerate(pool):
        Image.fromarray(img).save(data / f"im{i}.png")
    (tmp_path / "data" / "notes.txt").write_text("not an image")
    assert len(tfolder.list_images(str(tmp_path / "data"))) == 2
    np.testing.assert_array_equal(
        tfolder.load_image(str(data / "im1.png")), pool[1])
    argv = ["--cpu", "--model", "MLICPP_TINY", "--dataset", str(tmp_path / "data"),
            "--save-dir", str(tmp_path / "out")]
    if with_checkpoint:
        model = get_model("MLICPP_TINY")
        ckpt = tmp_path / "weights.pt"
        torch.save(init_params(model, torch.Generator().manual_seed(3)), ckpt)
        argv += ["--checkpoint", str(ckpt), "--transform-dtype",
                 "bfloat16_mixed"]
    res = cli.main(argv)
    assert res["n_images"] == 2 and res["bpp"] > 0
    assert np.isfinite(res["psnr"])
    assert "avg:" in capsys.readouterr().out
    assert len(list((tmp_path / "out").iterdir())) == 2
    with pytest.raises(FileNotFoundError):
        cli.main(["--cpu", "--dataset", str(tmp_path / "out")])


def test_cli_level_codes_a_vbr_model(tmp_path, capsys):
    """``tools/test.py --level`` on a VBR model writes the VBR header at
    that level; without it the model codes at level 0, as the reference
    CLI does."""
    Image = pytest.importorskip("PIL.Image")
    from mlic_tpu_torch.tools import test as cli

    data = tmp_path / "data"
    data.mkdir()
    Image.fromarray(tfolder.dead_leaves_pool(1, 64, seed=14, n_disks=20,
                                             cache_dir="")[0]).save(
        data / "a.png")
    argv = ["--cpu", "--model", "MLICPP_TINY_VBR", "--dataset", str(data)]
    res = {}
    for level in (None, 0, 2):
        out = tmp_path / f"out{level}"
        extra = [] if level is None else ["--level", str(level)]
        res[level] = cli.main(argv + ["--save-dir", str(out)] + extra)
        with open(out / "img_000.bin", "rb") as f:
            head = jbits.read_uints(f, 4)
        if level is not None:
            assert head[:3] == (64, 64, level)
    assert "avg:" in capsys.readouterr().out
    assert res[None]["psnr"] == res[0]["psnr"]
    assert res[0]["bpp"] < res[2]["bpp"]


def test_train_cli_vbr_smoke(tmp_path, capsys):
    """``tools/train.py --vbr`` on MLICPP_TINY_VBR: two MGDA steps on the
    CPU print the per-level metrics and write a checkpoint; ``--vbr`` on a
    fixed-rate model is refused."""
    from mlic_tpu_torch.tools import train as tcli
    args = ["--cpu", "--model", "MLICPP_TINY_VBR", "--vbr", "--synthetic",
            "--steps", "2", "--batch-size", "1", "--patch-size", "64",
            "--log-freq", "1", "--vbr-gradnorm", "loss", "--train-gain",
            "--ckpt-dir", str(tmp_path)]
    out = tcli.main(args)
    assert out["step"] == 2 and np.isfinite(out["loss"])
    assert {"alpha_0", "alpha_2", "loss_per_level_1", "bpp_per_level_2"} \
        <= set(out)
    assert abs(sum(out[f"alpha_{i}"] for i in range(3)) - 1.0) < 1e-5
    assert (tmp_path / "mlic_tpu_torch" / "checkpoint_2.pt").is_file()
    assert "alpha_1=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="VBR model"):
        tcli.main(["--cpu", "--model", "MLICPP_TINY", "--vbr", "--steps",
                   "1", "--ckpt-dir", str(tmp_path / "b")])


def test_cli_defaults_to_cuda(tmp_path):
    """Without --cpu the CLI asks for the card and raises where there is
    none; it never falls back to the CPU."""
    Image = pytest.importorskip("PIL.Image")
    from mlic_tpu_torch.tools import test as cli

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(tmp_path / "a.png")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--model", "MLICPP_TINY", "--dataset", str(tmp_path)])


def test_slice_matches_jax_codec_with_fused_tails(tmp_path, monkeypatch):
    """One 70x90 image, padded to 128x128, through both packages' file
    round trip with converted weights and the switch on in both (the JAX
    side's Pallas tails in interpret mode).

    The two frameworks' entropy parameters differ in the last ulp, so a
    latent that lies on a rounding boundary may land one step apart and
    move x_hat around that position; elsewhere x_hat differs only by f32
    summation order through g_s.  Stated tolerance: 99% of the samples
    within 1e-3, and the two PSNRs within 0.05 dB."""
    monkeypatch.setenv(SWITCH, "1")
    jmodel = jax_get_model("MLICPP_TINY")
    x = np.random.default_rng(12).random((1, 70, 90, 3), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(lambda r, v: jmodel.init(r, v, True))(
            {"params": jax.random.key(1), "noise": jax.random.key(2)},
            jnp.zeros((1, 64, 64, 3)))["params"]
        jcodec = JaxCodec(jmodel, params, backend="device", n_lanes=N_LANES)
        jcodec.update()
        jenc = jev.compress_one_image(jcodec, x, str(tmp_path / "jax.bin"))
        jdec = jev.decompress_one_image(jcodec, str(tmp_path / "jax.bin"))
    np.testing.assert_array_equal(jdec["x_hat"], jenc["x_hat_enc"])

    model = get_model("MLICPP_TINY")
    model.load_state_dict(from_flax(params), strict=True)
    codec = Codec(model, n_lanes=N_LANES, device="cpu")
    codec.update()
    enc = tev.compress_one_image(codec, x, str(tmp_path / "torch.bin"))
    dec = tev.decompress_one_image(codec, str(tmp_path / "torch.bin"))
    np.testing.assert_array_equal(dec["x_hat"], enc["x_hat_enc"])

    assert dec["x_hat"].shape == jdec["x_hat"].shape == x.shape
    diff = np.abs(dec["x_hat"] - np.asarray(jdec["x_hat"]))
    print(f"x_hat: max abs diff {diff.max():.3g}, "
          f"share within 1e-3 {np.mean(diff <= 1e-3):.5f}, "
          f"bpp torch {enc['bpp']:.4f} jax {jenc['bpp']:.4f}")
    assert np.mean(diff <= 1e-3) >= 0.99
    psnrs = [float(tmetrics.psnr(torch.from_numpy(np.clip(d, 0, 1)),
                                 torch.from_numpy(x)))
             for d in (dec["x_hat"], np.asarray(jdec["x_hat"]))]
    assert abs(psnrs[0] - psnrs[1]) <= 0.05
    assert abs(enc["bpp"] - jenc["bpp"]) <= 0.02 * jenc["bpp"]
