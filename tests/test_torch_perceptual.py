"""The perceptual losses, the POELIC training step and
``Trainer.evaluate``'s reconstructions against the JAX package, on the CPU.

VGG16's four stages on weights carried across (``weights.vgg_from_flax``
of a flax init, and a torchvision-layout file through ``load_torch_vgg16``
on both sides): features within 1e-5 (relative to the tensor's scale where
it exceeds 1, as in ``test_torch_train.py``).  The Gram, style, feature
distance, hinge and patch functions on seeded arrays, within 1e-5.  One
POELIC step of MLICPP_TINY at [2, 64, 64, 3] against
``make_poelic_train_step`` on the same weights, batch and z noise (JAX's
draw, its bottleneck's output for z = 0): the step's losses within 1e-5,
and every parameter after Adam's update within 1e-5 but where a gradient
element is within a hundred eps of zero (there the last bits of the
gradient move it, by up to twice the rate: ``test_torch_vbr.py``'s rule).  ``Trainer.
evaluate`` rows within 1e-4 of JAX's, its PNGs written under the same
names.  The whole-model JAX programs compile at XLA optimization level 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mlic_tpu import perceptual as jper
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu.train import optimizers as jopt
from mlic_tpu.train import trainer as jtrainer
from mlic_tpu_torch import perceptual as tper
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.train.trainer import (
    Trainer,
    TrainConfig,
    create_train_state,
    poelic_train_step,
)
from mlic_tpu_torch.weights import init_params, to_flax, vgg_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (see
    ``test_torch_train.py``: six xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (2, 64, 64, 3)
LMBDA = 0.0483
LR = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def vgg_pair():
    """The flax VGG16 features with its own init, and the port's module
    carrying the same weights."""
    jvgg = jper.Vgg16Features()
    params = jax.jit(jvgg.init)(jax.random.key(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
    tvgg = tper.Vgg16Features()
    tvgg.load_state_dict(vgg_from_flax(params))
    return jvgg, params, tvgg


def test_vgg_is_frozen_and_carried(vgg_pair):
    jvgg, params, tvgg = vgg_pair
    assert not any(p.requires_grad for p in tvgg.parameters())
    assert len(tvgg.state_dict()) == 20
    back = to_flax(tvgg.state_dict())
    for name in tper.vgg_conv_names():
        np.testing.assert_array_equal(back[name]["kernel"],
                                      np.asarray(params[name]["kernel"]))
    with pytest.raises(ValueError, match="VGG16"):
        vgg_from_flax({"conv1_1": params["conv1_1"]})


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 16, 16, 3),
                                   (1, 40, 28, 3)])
def test_vgg_features_match_flax(vgg_pair, shape):
    jvgg, params, tvgg = vgg_pair
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    want = jvgg.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tvgg(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_load_torch_vgg16_both_sides(tmp_path, vgg_pair):
    """A torchvision-layout ``features`` file loads to the same features
    in both packages."""
    jvgg, params, _ = vgg_pair
    g = torch.Generator().manual_seed(2)
    sd, cin = {}, 3
    for idx, width in zip(tper.TORCHVISION_CONV_INDEX,
                          (w for ws in tper.VGG_STAGES for w in ws)):
        sd[f"features.{idx}.weight"] = torch.randn(width, cin, 3, 3,
                                                   generator=g) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(width, generator=g) * 0.1
        cin = width
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    jparams = jper.load_torch_vgg16(params, path)
    tvgg = tper.load_torch_vgg16(tper.Vgg16Features(), path)
    x = np.random.default_rng(3).random((1, 24, 24, 3), dtype=np.float32)
    want = jvgg.apply({"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        got = tvgg(torch.from_numpy(x))
    for g_, w in zip(got, want):
        _close(_nhwc(g_), w)


def test_loss_functions_match_jax():
    rng = np.random.default_rng(4)
    fa = [rng.standard_normal((2, 8, 6, c)).astype(np.float32) ** 2
          for c in (4, 8)]
    fb = [rng.standard_normal(f.shape).astype(np.float32) ** 2 for f in fa]
    ta = [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
          for f in fa]
    tb = [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
          for f in fb]
    _close(tper.gram_matrix(ta[0]), jper.gram_matrix(jnp.asarray(fa[0])))
    _close(tper.style_loss(ta, tb), jper.style_loss(
        [jnp.asarray(f) for f in fa], [jnp.asarray(f) for f in fb]))
    _close(tper.perceptual_l2(ta, tb), jper.perceptual_l2(
        [jnp.asarray(f) for f in fa], [jnp.asarray(f) for f in fb]))
    logits = rng.standard_normal(50).astype(np.float32)
    for real in (True, False):
        for disc in (True, False):
            _close(tper.gan_loss_hinge(torch.from_numpy(logits), real, disc),
                   jper.gan_loss_hinge(jnp.asarray(logits), real, disc))
    x = rng.random((2, 40, 56, 3)).astype(np.float32)
    for patch in (16, 8):
        np.testing.assert_array_equal(
            tper.image_to_patches(torch.from_numpy(x), patch).numpy(),
            np.asarray(jper.image_to_patches(jnp.asarray(x), patch)))


def _port_model(seed=0):
    m = get_model("MLICPP_TINY")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(seed)))
    return m


def test_poelic_step_matches_jax(vgg_pair):
    """One POELIC step (Adam, clipping at 1.0) against
    ``make_poelic_train_step``: every loss term and every parameter after
    the update; the VGG's parameters take no gradient."""
    jvgg, vparams, tvgg = vgg_pair
    model = _port_model()
    params = to_flax(model.state_dict())
    jmodel = jax_get_model("MLICPP_TINY")
    x = np.random.default_rng(5).random(SHAPE, dtype=np.float32)
    tx = jopt.make_optimizer(LR, 1e-3, 1.0, "adam")
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params),
                                rng=jax.random.key(0))
    step = jtrainer.make_poelic_train_step(
        jmodel, tx, jtrainer.TrainConfig(lmbda=LMBDA),
        lambda p, v: jvgg.apply({"params": p}, v), vparams)
    new, want = step.lower(state, x).compile(FAST_COMPILE)(state, x)

    # The step's z noise: its bottleneck's draw (the key depends on the
    # module's path alone), read as the output for z = 0.
    z0 = jnp.zeros((SHAPE[0], SHAPE[1] // 64, SHAPE[2] // 64,
                    jmodel.cfg.N))
    z_tilde, _ = jmodel.apply(
        {"params": params}, z0, True,
        rngs={"noise": jax.random.split(jax.random.key(0))[1]},
        method=lambda m, v, t: m.entropy_bottleneck(v, t))
    noise = np.array(z_tilde).reshape(-1, jmodel.cfg.N).T.copy()

    cfg = TrainConfig(lmbda=LMBDA, learning_rate=LR)
    st = create_train_state(model, cfg, "cpu")
    got = poelic_train_step(st, x, cfg, tvgg, noise=torch.from_numpy(noise))
    assert set(want) <= set(got)
    for k in ("loss", "bpp_loss", "charbonnier_loss", "perceptual_loss",
              "style_loss", "aux_loss"):
        _close(got[k].numpy(), want[k])
        assert np.isfinite(float(got[k]))
    assert all(p.grad is None for p in tvgg.parameters())
    grads = to_flax({n: p.grad for n, p in model.named_parameters()})
    after = to_flax(model.state_dict())
    flat_want = jax.tree_util.tree_flatten_with_path(new.params)[0]
    assert len(flat_want) == len(list(model.parameters()))
    moved = 0
    for path, w in flat_want:
        leaf, g = after, grads
        for k in path:
            leaf, g = leaf[k.key], g[k.key]
        w = np.asarray(w)
        noise_level = np.abs(g) < 1e-6
        assert np.all(np.abs(leaf - w)[noise_level] <= 2 * LR), path
        _close(leaf[~noise_level], w[~noise_level])
        moved += int(np.any(leaf != np.asarray(
            params_leaf(params, path))))
    assert moved > len(flat_want) // 2


def params_leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_trainer_evaluate_matches_jax(tmp_path):
    """Rows of a 64x64 image and a 50x60 one (padded to 64 inside, the
    metrics on the true pixels) within 1e-4 of JAX's, the reconstructions
    written as ``{tag}_img{i}.png`` (and ``val_img{i}.png`` without a tag)
    within one level of JAX's."""
    model = _port_model(seed=1)
    params = to_flax(model.state_dict())
    jtr = jtrainer.Trainer(jax_get_model("MLICPP_TINY"),
                           jtrainer.TrainConfig(lmbda=LMBDA),
                           input_shape=(1, 64, 64, 3))
    jtr.state = jtr.state.replace(params=params)
    rng = np.random.default_rng(6)
    imgs = [rng.random((64, 64, 3), np.float32),
            rng.random((1, 50, 60, 3), np.float32)]
    want = jtr.evaluate(imgs, save_recon_dir=str(tmp_path / "jax"), tag="t")
    tr = Trainer(model, TrainConfig(lmbda=LMBDA), "cpu",
                 log_fn=lambda line: None)
    got = tr.evaluate(imgs, save_recon_dir=str(tmp_path / "port"), tag="t")
    assert len(got["per_image"]) == 2
    for g, w in zip(got["per_image"], want["per_image"]):
        for k in ("psnr", "bpp", "loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        assert np.isnan(g["ms_ssim"]) and np.isnan(w["ms_ssim"])
    for k in ("psnr", "bpp", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for i, size in enumerate(((64, 64), (60, 50))):
        a = np.asarray(Image.open(tmp_path / "port" / f"t_img{i}.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / f"t_img{i}.png"))
        assert a.shape == b.shape == (size[1], size[0], 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    tr.evaluate(imgs[:1], save_recon_dir=str(tmp_path / "untagged"))
    assert (tmp_path / "untagged" / "val_img0.png").is_file()
    assert model.training                  # evaluate restores the mode
