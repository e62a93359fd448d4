"""The port's RD and profiling tools, run on the CPU at MLICPP_TINY's size
with one rep: each prints one JSON line with the JAX tool's keys.

``tools.rd_curve`` on a torch weights file through the device and steps
backends (the two agree on PSNR, ``evaluate_codec`` checks each round
trip), ``tools.jpeg_anchor`` and ``tools.bdrate`` on their curves,
``tools.profile_codec`` (stage names, ``parametric``), ``tools.
profile_modules`` and ``tools.microbench``'s ctx, encode, decode and
fusedblk sets.
"""

import json

import pytest
import torch

from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import (bdrate, jpeg_anchor, microbench,
                                  profile_codec, profile_modules, rd_curve)
from mlic_tpu_torch.weights import init_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (six
    xdist workers share the cores; ``test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rd_curve_jpeg_anchor_bdrate(tmp_path, capsys):
    model = get_model("MLICPP_TINY")
    weights = tmp_path / "tiny.pt"
    torch.save(init_params(model, torch.Generator().manual_seed(0)), weights)
    curves = {}
    for backend in ("device", "steps"):
        curves[backend] = rd_curve.main([
            "--model", "MLICPP_TINY", "--ckpts", str(weights), str(weights),
            "--lambdas", "0.01", "0.02", "--n-images", "1",
            "--image-size", "64", "--backend", backend, "--cpu",
            "--out", str(tmp_path / f"rd_{backend}.json"),
            "--save-dir", str(tmp_path / "eval")])
        assert _last_json(capsys) == json.loads(
            (tmp_path / f"rd_{backend}.json").read_text())
    for c in curves.values():
        assert {"psnr", "bpp", "ms_ssim", "lambda", "enc_time", "dec_time",
                "n_images", "eval_set"} <= set(c)
        assert c["n_images"] == 1 and c["ms_ssim"] == [None, None]
    assert curves["device"]["psnr"] == curves["steps"]["psnr"]
    jpeg = jpeg_anchor.main(["--cpu", "--n-images", "1", "--image-size",
                             "64", "--qualities", "10", "40", "70", "95",
                             "--out", str(tmp_path / "jpeg.json")])
    assert set(jpeg) >= {"psnr", "bpp", "ms_ssim", "quality", "codec",
                         "eval_set"}
    assert jpeg["bpp"] == sorted(jpeg["bpp"]) and len(jpeg["psnr"]) == 4
    capsys.readouterr()
    got = bdrate.main(["--test", str(tmp_path / "jpeg.json"),
                       "--anchor", str(tmp_path / "jpeg.json")])
    assert got == {"bd_rate": pytest.approx(0.0, abs=1e-9),
                   "bd_psnr": pytest.approx(0.0, abs=1e-9)}


def test_profile_codec(monkeypatch, capsys):
    for k, v in {"PROF_MODEL": "MLICPP_TINY", "PROF_BATCH": "1",
                 "PROF_REPS": "1", "PROF_LANES": "16", "PROF_BF16": "0",
                 "PROF_HEIGHT": "64", "PROF_WIDTH": "64"}.items():
        monkeypatch.setenv(k, v)
    profile_codec.main(["--cpu"])
    out = _last_json(capsys)
    assert out["parametric"] is True and out["analytic_enc_rows"] > 0
    assert set(out["ms_per_image"]) == {
        "c.upload", "c.gain", "c.analyze", "c.encode_pass", "c.rans_encode",
        "c.stream_dl", "c.synthesize", "d.gain", "d.parse", "d.upload",
        "d.device_pass", "d.synthesize"}
    assert {"img_per_s", "accounted_ms", "total_ms", "device"} <= set(out)


def test_profile_codec_refuses_a_fallback(monkeypatch):
    monkeypatch.setattr("mlic_tpu_torch.entropy.parametric.self_check_encode",
                        lambda *a, **k: 5)
    with pytest.warns(UserWarning, match="falling back"), \
            pytest.raises(RuntimeError, match="fell back"):
        profile_codec.build_codec("MLICPP_TINY", 16, False, "", "cpu")


@pytest.mark.parametrize("which", ["profile_modules", "ctx", "encode",
                                   "decode", "fusedblk"])
def test_module_timers(which, monkeypatch, capsys):
    env = {"MB_MODEL": "MLICPP_TINY", "MB_BATCH": "1", "MB_REPS": "1",
           "MB_HEIGHT": "64", "MB_WIDTH": "64", "MB_LANES": "16",
           "MB_SET": which, "PM_MODEL": "MLICPP_TINY", "PM_BATCH": "1",
           "PM_REPS": "1", "PM_HEIGHT": "64", "PM_WIDTH": "64"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tool = profile_modules if which == "profile_modules" else microbench
    tool.main(["--cpu"])
    out = _last_json(capsys)
    assert {"model", "batch", "reps", "latent", "device", "modules"} \
        <= set(out)
    assert out["modules"] and all(
        set(r) == {"module", "ms_per_call", "calls_per_pass", "ms_per_pass"}
        and r["ms_per_call"] > 0 for r in out["modules"])
    labels = " ".join(r["module"] for r in out["modules"])
    want = {"encode": ["K7", "K3", "K6", "v2", "v4"],
            "decode": ["codec_device_pass_v4", "K4 lane layout"],
            "fusedblk": ["fused", "unfused", "bfloat16_mixed"],
            "ctx": ["LocalContext", "EntropyParameters"],
            "profile_modules": ["g_a", "LRP"]}[which]
    assert all(w in labels for w in want), labels
