"""The last modules of the JAX package against the port, on the CPU.

``ResidualBottleneck`` and ``AttentionBlock`` (flax weights through
``weights.from_flax``) and ``MLICPlusPlus.net_decoder_forward`` of
MLICPP_TINY at 64x64 within 1e-5 in f32; ``tools.macs``' parameter counts
(PARITY.md's MLICPP_L rows exact); LPIPS and DISTS within 1e-5 of flax on
seeded weights carried across (``weights.metric_from_flax`` and back), and
both loaders on synthetic torch files read by both packages; the analysis
package (frequency features within 1e-12 in float64, the numpy k-means'
labels equal, the CSV comparison and the cache); and ``tools.bdrate``
equal to the JAX tool's functions.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu import perceptual_metrics as jpm
from mlic_tpu.analysis import cache as jcache
from mlic_tpu.analysis import cluster as jcluster
from mlic_tpu.analysis import compare as jcompare
from mlic_tpu.analysis import freq as jfreq
from mlic_tpu.models import layers as fl
from mlic_tpu.models.mlicpp import MLICPlusPlus as JaxMLIC
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch import perceptual_metrics as tpm
from mlic_tpu_torch.analysis import cache, cluster, compare, freq
from mlic_tpu_torch.models import layers as tl
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import bdrate, macs
from mlic_tpu_torch.weights import (from_flax, init_params, metric_from_flax,
                                    to_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _run(f, *args):
    """``f(*args)`` as one JAX program compiled at XLA optimization level 0
    (a flax module applied op by op compiles each op on its own, slower)."""
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]
    return np.asarray(jax.jit(f).lower(*args).compile(FAST_COMPILE)(*args))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (six
    xdist workers share the cores; ``test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("which", ["bottleneck", "attention",
                                   "attention_dense"])
def test_layers_match_flax(which):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    if which == "bottleneck":
        fmod, tmod = fl.ResidualBottleneck(16), tl.ResidualBottleneck(16)
    else:
        dw = which == "attention"
        fmod, tmod = fl.AttentionBlock(16, dw), tl.AttentionBlock(16, dw)
    tmod.load_state_dict(init_params(tmod, torch.Generator().manual_seed(1)))
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(2))
          for k, v in tmod.state_dict().items()}
    tmod.load_state_dict(sd)
    params = to_flax(sd)
    want = _run(lambda p, v: fmod.apply({"params": p}, v), params, x)
    with torch.no_grad():
        got = tmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, want)
    # the torch state_dict is the flax tree
    shapes = jax.eval_shape(fmod.init, jax.random.key(0),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes["params"]) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)


def test_net_decoder_forward_matches_flax():
    port = get_model("MLICPP_TINY")
    port.load_state_dict(init_params(port, torch.Generator().manual_seed(0)))
    params = to_flax(port.state_dict())
    x = np.zeros((1, 64, 64, 3), np.float32)
    model = jax_get_model("MLICPP_TINY")
    want = _run(lambda p, v: model.apply(
        {"params": p}, v, method=JaxMLIC.net_decoder_forward), params, x)
    with torch.no_grad():
        got = port.net_decoder_forward(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_macs_counts():
    """PARITY.md's MLICPP_L parameter counts, and FLOPs on the meta
    device that grow with the image."""
    assert macs.param_count("MLICPP_L", depthwise=False) == 83_501_408
    assert macs.param_count("MLICPP_L") == 41_719_422
    small = macs.decoder_flops("MLICPP_TINY", 64, 64)
    assert 0 < small < macs.decoder_flops("MLICPP_TINY", 128, 128)
    out = macs.decoder_cost("MLICPP_TINY", 64, 64, device="cpu")
    assert out["gmacs"] == small / 2e9 and "forward_ms" not in out


@pytest.fixture(scope="module")
def metric_images():
    rng = np.random.default_rng(0)
    a = rng.random((1, 32, 32, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape, dtype=np.float32),
                0, 1)
    return a, b


@pytest.mark.parametrize("name", ["lpips", "dists"])
def test_metrics_match_flax(name, metric_images):
    a, b = metric_images
    init, jmod, tmod = ((tpm.init_lpips, jpm.LPIPSVgg(), tpm.LPIPSVgg())
                        if name == "lpips" else
                        (tpm.init_dists, jpm.DISTS(), tpm.DISTS()))
    sd = init(torch.Generator().manual_seed(1))
    if name == "lpips":      # some negative heads: clamped at use
        sd["lin2"] = sd["lin2"] - 0.05
    params = to_flax(sd)
    tmod.load_state_dict(metric_from_flax(params, tmod))
    fn = jax.jit(lambda p, x, y: jmod.apply({"params": p}, x, y)).lower(
        params, jnp.asarray(a), jnp.asarray(b)).compile(FAST_COMPILE)
    for x, y in ((a, b), (a, a)):
        want = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(y)))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        _close(got, want)
    with pytest.raises(ValueError, match="not a"):
        metric_from_flax({"vgg": params["vgg"]}, tmod)


def _vgg_file(path):
    widths = [w for ws in tpm.STAGES5 for w in ws]
    sd, cin = {}, 3
    g = torch.Generator().manual_seed(2)
    for idx, w in zip(tpm.TORCHVISION_CONV_INDEX, widths):
        sd[f"features.{idx}.weight"] = torch.randn(w, cin, 3, 3, generator=g)
        sd[f"features.{idx}.bias"] = torch.randn(w, generator=g)
        cin = w
    torch.save(sd, path)
    return sd


def test_loaders_on_synthetic_files(tmp_path, metric_images):
    vgg = _vgg_file(tmp_path / "vgg16.pth")
    lin = {f"lin{i}.model.1.weight": torch.rand(1, ws[-1], 1, 1)
           for i, ws in enumerate(tpm.STAGES5)}
    torch.save(lin, tmp_path / "lpips_vgg.pth")
    n = 3 + sum(ws[-1] for ws in tpm.STAGES5)
    ab = {"alpha": torch.rand(1, n, 1, 1), "beta": torch.rand(1, n, 1, 1)}
    torch.save(ab, tmp_path / "dists.pt")

    sd = tpm.load_lpips_weights(tpm.LPIPSVgg().state_dict(),
                                str(tmp_path / "vgg16.pth"),
                                str(tmp_path / "lpips_vgg.pth"))
    assert sd["lin0"].shape == (64, 1)
    assert torch.equal(sd["vgg.conv1_1.weight"], vgg["features.0.weight"])
    jparams = jpm.load_lpips_weights(to_flax(tpm.LPIPSVgg().state_dict()),
                                     str(tmp_path / "vgg16.pth"),
                                     str(tmp_path / "lpips_vgg.pth"))
    for k, v in from_flax(jparams).items():
        assert torch.equal(sd[k], v), k
    dsd = tpm.load_dists_weights(tpm.DISTS().state_dict(),
                                 str(tmp_path / "dists.pt"),
                                 str(tmp_path / "vgg16.pth"))
    assert torch.equal(dsd["beta"], ab["beta"].reshape(-1))
    jd = jpm.load_dists_weights(to_flax(tpm.DISTS().state_dict()),
                                str(tmp_path / "dists.pt"),
                                str(tmp_path / "vgg16.pth"))
    for k, v in from_flax(jd).items():
        assert torch.equal(dsd[k], v), k
    # the loaded weights change the metric
    a, _ = metric_images
    m0, m1 = tpm.LPIPSVgg(), tpm.LPIPSVgg()
    m0.load_state_dict(dict(sd, lin0=sd["lin0"] + 1.0))
    m1.load_state_dict(sd)
    x, y = torch.from_numpy(a), torch.zeros(1, 32, 32, 3)
    with torch.no_grad():
        assert not torch.allclose(m0(x, y), m1(x, y))


def _images(n=6):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8)
            for i in range(n)]


def test_freq_matches_jax():
    imgs = _images()
    _close(freq.frequency_features(imgs, 16, "cpu"),
           jfreq.frequency_features(imgs, 16), 1e-12)
    prof, jprof = freq.dataset_band_profile(imgs, 10, "cpu"), \
        jfreq.dataset_band_profile(imgs, 10)
    for k in ("per_image", "mean", "std"):
        _close(prof[k], jprof[k], 1e-12)
    mag = freq.frequency_energy(freq.to_grayscale(imgs[1], "cpu"))
    jmag = jfreq.frequency_energy(jfreq.to_grayscale(imgs[1]))
    _close(mag, jmag, 1e-9)
    _close(freq.normalized_spectrum(mag, 32),
           jfreq.normalized_spectrum(jmag, 32), 1e-9)


def test_cluster_labels_equal_jax(monkeypatch):
    feats = freq.frequency_features(_images(8), 16, "cpu")
    z = (feats - feats.mean(0)) / (feats.std(0) + 1e-9)
    labels, centers = cluster._kmeans_np(z.copy(), 3, seed=5)
    jlabels, jcenters = jcluster._kmeans_np(z.copy(), 3, seed=5)
    assert np.array_equal(labels, jlabels)
    _close(centers, jcenters, 0.0)
    # without sklearn both modules cluster with the numpy k-means
    monkeypatch.setitem(sys.modules, "sklearn", None)
    out = cluster.cluster_images(_images(8), k=3, device="cpu")
    jout = jcluster.cluster_images(_images(8), k=3)
    assert np.array_equal(out["labels"], jout["labels"])
    _close(out["embedding"], jout["embedding"], 1e-9)


def test_compare_and_cache(tmp_path):
    rows = {"a": [("i0", 0.5, 30.0), ("i1", 0.7, 31.0)],
            "b": [("i0", 0.4, 29.0), ("i1", 0.9, 32.0), ("i2", 1.0, 33.0)]}
    paths = []
    for name, rs in rows.items():
        p = tmp_path / f"{name}.csv"
        p.write_text("name,bpp,psnr,ms_ssim\n" + "".join(
            f"{n},{b},{s},\n" for n, b, s in rs))
        paths.append(str(p))
    assert compare.compare_bpp(paths) == jcompare.compare_bpp(paths)
    assert compare.compare_bpp(paths, "psnr") == \
        jcompare.compare_bpp(paths, "psnr")

    calls = []

    def square(v):
        calls.append(v)
        return v * v

    for mod in (cache, jcache):
        c = mod.SimpleCache(str(tmp_path / "cache"), memory_cache_size=1)
        f = c.cached(square)
        calls.clear()
        assert f(3) == 9 and f(3) == 9 and f(4) == 16 and f(3) == 9
        assert calls == [3, 4]              # the second 3 from disk
        c.clear_cache(memory_only=True)
        assert f(4) == 16 and calls == [3, 4]
        c.clear_cache()
        assert not list((tmp_path / "cache").glob("*.pkl"))


def test_bdrate_equals_jax(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_bdrate", os.path.join(ROOT, "tools", "bdrate.py"))
    jb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jb)
    rng = np.random.default_rng(6)
    ab = np.sort(rng.random(6)) + 0.1
    ap = 30 + 10 * np.log(ab) + 0.1 * rng.random(6)
    tb, tp = ab * 0.9, ap + 0.2
    assert bdrate.bd_rate(ab, ap, tb, tp) == jb.bd_rate(ab, ap, tb, tp)
    assert bdrate.bd_psnr(ab, ap, tb, tp) == jb.bd_psnr(ab, ap, tb, tp)
    for name, b, p in (("t", tb, tp), ("a", ab, ap)):
        (tmp_path / f"{name}.json").write_text(json.dumps(
            {"results": {"bpp": b.tolist(), "psnr-rgb": p.tolist()}}))
    got = bdrate.main(["--test", str(tmp_path / "t.json"),
                       "--anchor", str(tmp_path / "a.json")])
    assert got["bd_rate"] == jb.bd_rate(ab, ap, tb, tp)
    with pytest.raises(ValueError, match="overlap"):
        bdrate.bd_rate(ab, ap, tb * 100, tp + 100)
