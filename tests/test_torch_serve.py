"""The device backend's serving split and the port's serving CLIs, on the
CPU (MLICPP_TINY and its VBR twin, seeded weights).

``compress_end(compress_begin(x))`` writes the bytes of the unsplit
composition (analyze, encode pass, ``encode_rans_v4``,
``assemble_streams``); two batches in flight write serial coding's bytes,
also when the second outgrows the speculative download; ``roundtrip_stream``
equals serial compress + decompress; ``decompress(wait=False)`` gives the
same x_hat.  Then the CLIs: ``tools.serve --cpu`` (the shape of
``tests/test_serve_cli.py``) with containers that ``tools.decode`` reads
back, ``tools.rd_vbr`` (the shape of ``tests/test_rd_vbr_tool.py``), and
``tools.test --backend steps`` with ``tools.decode`` reading its files.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mlic_tpu_torch.codec import Codec, encode_rans_v4
from mlic_tpu_torch.entropy.stream import assemble_streams
from mlic_tpu_torch.eval import compress_one_image
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import decode as tdecode
from mlic_tpu_torch.tools import rd_vbr as trd_vbr
from mlic_tpu_torch.tools import serve as tserve
from mlic_tpu_torch.tools import test as ttest
from mlic_tpu_torch.weights import init_params


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


def _model(name="MLICPP_TINY"):
    m = get_model(name)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    return m


@pytest.fixture(scope="module")
def codec():
    c = Codec(_model(), n_lanes=N_LANES, device="cpu")
    c.update()
    return c


def _batches():
    """A smooth batch, then noise (longer streams than the smooth batch's
    speculative download), then smooth again."""
    rng = np.random.default_rng(3)
    smooth = np.repeat(np.linspace(0, 255, SHAPE[2], dtype=np.float32)
                       [None, None, :, None], SHAPE[1], 1)
    smooth = np.broadcast_to(smooth, SHAPE).astype(np.uint8)
    noise = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    return [smooth, noise, smooth[:, ::-1].copy()]


def _fresh(codec):
    c = Codec(codec.model, n_lanes=N_LANES, device="cpu")
    c.update()
    return c


def test_split_compress_writes_the_unsplit_bytes(codec):
    x = _batches()[1]
    got = codec.compress_end(codec.compress_begin(x))
    m = codec.model
    with torch.no_grad():
        y, z = m.analyze(torch.from_numpy(x))
        y_hat, sym, idx = m.codec_encode_pass(y, z)
        want = assemble_streams(encode_rans_v4(
            sym, idx, z.reshape(z.shape[0], -1), codec.tables, N_LANES,
            2 * m.cfg.slice_num, codec.z_rows_base), N_LANES)
    assert got["strings"] == [want, [b"", b""]]
    assert got["shape"] == tuple(z.shape[1:3])
    assert torch.equal(got["y_hat"], y_hat)
    assert codec.compress(x)["strings"] == got["strings"]


def test_two_batches_in_flight_write_serial_bytes(codec):
    batches = _batches()
    serial = _fresh(codec)
    want = [serial.compress(x) for x in batches]
    piped = _fresh(codec)
    handles = [piped.compress_begin(batches[0])]
    got = []
    for k in range(len(batches)):
        if k + 1 < len(batches):
            handles.append(piped.compress_begin(batches[k + 1]))
        got.append(piped.compress_end(handles[k]))
    for g, w in zip(got, want):
        assert g["strings"] == w["strings"]
        assert torch.equal(g["x_hat"], w["x_hat"])
    assert piped._words_bucket >= max(
        sum(len(s) for s in g["strings"][0]) // 2 for g in got)


def test_roundtrip_stream_equals_serial(codec):
    batches = _batches()
    serial = _fresh(codec)
    want = []
    for x in batches:
        enc = serial.compress(x)
        want.append((enc, serial.decompress(enc["strings"], enc["shape"])))
    got = list(_fresh(codec).roundtrip_stream(batches))
    assert len(got) == len(want)
    for (ge, gd), (we, wd) in zip(got, want):
        assert ge["strings"] == we["strings"]
        assert torch.equal(gd["x_hat"], wd["x_hat"])
        assert torch.equal(gd["x_hat"], ge["x_hat"])
    assert list(codec.roundtrip_stream([])) == []


def test_decompress_without_waiting(codec):
    enc = codec.compress(_batches()[0])
    dec = codec.decompress(enc["strings"], enc["shape"], wait=False)
    assert torch.equal(dec["x_hat"], enc["x_hat"])


@pytest.mark.parametrize("backend", ["device", "steps"])
def test_an_image_of_a_batch_decodes_alone(codec, backend):
    """A container holds one image of a batch: decoded alone, its y_hat is
    the batch encoder's bit for bit, and its x_hat g_s of that y_hat at
    batch 1 (g_s of the whole batch may round other bits)."""
    c = codec if backend == "device" else Codec(codec.model, device="cpu",
                                                backend=backend)
    enc = c.compress(_batches()[1])
    for i in range(SHAPE[0]):
        dec = c.decompress([[enc["strings"][0][i]], [enc["strings"][1][i]]],
                           enc["shape"])
        assert torch.equal(dec["y_hat"][0], enc["y_hat"][i])
        with torch.no_grad():
            want = c.model.synthesize(enc["y_hat"][i:i + 1])
        assert torch.equal(dec["x_hat"], want)


def test_split_is_device_backend_only():
    steps = Codec(_model(), device="cpu", backend="steps",
                  encode_recon=False)
    with pytest.raises(ValueError, match="device backend"):
        steps.compress_begin(_batches()[0])
    enc = steps.compress(_batches()[0])
    assert enc["x_hat"] is None
    got = list(steps.roundtrip_stream(_batches()[:1]))
    assert got[0][0]["strings"] == enc["strings"]
    with pytest.raises(ValueError, match="unknown backend"):
        Codec(_model(), device="cpu", backend="lut")


def test_serve_cli_verify_and_containers(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MLIC_POOL_CACHE", str(tmp_path / "pool"))
    out_dir = tmp_path / "streams"
    res = tserve.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic",
                       "--n", "4", "--batch", "2", "--size", "128", "192",
                       "--lanes", "16", "--verify", "--out", str(out_dir)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert set(res) == {"images", "img_s", "bpp", "verify", "parametric",
                        "analytic_enc_rows", "device"}
    assert res["images"] == 4 and res["verify"] and res["device"] == "cpu"
    assert res["parametric"] and res["analytic_enc_rows"] > 0
    assert 0 < res["bpp"] < 32 and res["img_s"] > 0
    bins = sorted(os.listdir(out_dir))
    assert bins == [f"frame{i:04d}.bin" for i in range(4)]
    got = tdecode.main(["--model", "MLICPP_TINY", "--bitstream-dir",
                        str(out_dir), "--output-dir", str(tmp_path / "png"),
                        "--cpu"])
    assert sorted(got) == bins
    for x_hat in got.values():
        assert x_hat.shape == (1, 128, 192, 3) and np.isfinite(x_hat).all()
    plain = tserve.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic",
                         "--n", "4", "--batch", "2", "--size", "128", "192",
                         "--lanes", "16"])
    assert plain["bpp"] == res["bpp"] and not plain["verify"]


def test_rd_vbr_cli_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("MLIC_POOL_CACHE", str(tmp_path / "pool"))
    m = _model("MLICPP_TINY_VBR")
    torch.save(m.state_dict(), tmp_path / "vbr.pt")
    out = tmp_path / "rd_vbr.json"
    trd_vbr.main(["--cpu", "--model", "MLICPP_TINY_VBR", "--checkpoint",
                  str(tmp_path / "vbr.pt"), "--out", str(out),
                  "--n-images", "1", "--image-size", "128", "--interp", "1",
                  "--backend", "steps", "--save-dir", str(tmp_path / "eval")])
    curve = json.loads(out.read_text())        # strict JSON (no NaN)
    assert len(curve["bpp"]) == 4              # 3 levels + 1 midpoint
    assert curve["kind"].count("level") == 3
    assert curve["kind"].count("inputscale") == 1
    assert curve["gain"] == sorted(curve["gain"])
    assert curve["monotone_rate"] and all(b > 0 for b in curve["bpp"])
    assert all(v is None for v in curve["ms_ssim"])     # 128 px < 176


def test_eval_and_decode_clis_on_the_steps_backend(tmp_path):
    data = tmp_path / "images"
    data.mkdir()
    img = np.random.default_rng(7).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(data / "a.png")
    res = ttest.main(["--cpu", "--model", "MLICPP_TINY", "--dataset",
                      str(data), "--save-dir", str(tmp_path / "eval"),
                      "--backend", "steps"])
    assert res["n_images"] == 1 and np.isfinite(res["psnr"])
    got = tdecode.main(["--cpu", "--model", "MLICPP_TINY", "--bitstream-dir",
                        str(tmp_path / "eval"), "--output-dir",
                        str(tmp_path / "png")])
    enc = compress_one_image(Codec(_model(), device="cpu", backend="steps"),
                             img[None].astype(np.float32) / 255.0,
                             str(tmp_path / "again.bin"))
    np.testing.assert_array_equal(got["img_000.bin"], enc["x_hat_enc"])
    assert (tmp_path / "again.bin").read_bytes() == (
        tmp_path / "eval" / "img_000.bin").read_bytes()
    png = np.asarray(Image.open(tmp_path / "png" / "img_000.png"))
    np.testing.assert_array_equal(png, np.clip(
        enc["x_hat_enc"][0] * 255.0 + 0.5, 0, 255).astype(np.uint8))
