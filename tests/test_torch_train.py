"""The port's training path against the JAX package, on the CPU.

MLICPP_TINY at [2, 64, 64, 3].  Both frameworks run the same weights (the
port's seeded ones, mapped to the flax layout by ``weights.to_flax``) and
the same z noise (JAX's draw, read from its bottleneck's output).
Tolerances: f32 values 1e-5 (relative to the tensor's scale where it
exceeds 1), gradients 1e-4 relative to each leaf's largest magnitude.
The small functions run un-jitted; the whole model is compiled once, for
one ``jax.value_and_grad`` of RD + aux loss, and once for the evaluation
forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlic_tpu import loss as jloss
from mlic_tpu.data import folder as jfolder
from mlic_tpu.entropy import models as jem
from mlic_tpu.models.mlicpp import MLICPlusPlus as JaxMLIC
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu.ops import math as jmath
from mlic_tpu.train import optimizers as jopt
from mlic_tpu_torch import loss as tloss
from mlic_tpu_torch.data import folder as tfolder
from mlic_tpu_torch.entropy import models as tem
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.ops import math as tmath
from mlic_tpu_torch.train import optimizers as topt
from mlic_tpu_torch.train.trainer import (
    Trainer,
    TrainConfig,
    TrainState,
    _update,
    create_train_state,
    eval_step,
    train_step,
)
from mlic_tpu_torch.utils.checkpoint import CheckpointManager
from mlic_tpu_torch.weights import init_params, to_flax


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


SHAPE = (2, 64, 64, 3)
LMBDA = 0.0483
# The whole-model programs compile at XLA's lowest backend optimization
# level: the numbers are the same program's, and it compiles in half the
# time.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _grad_close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))) + 1e-12, err


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_model(seed=0):
    m = get_model("MLICPP_TINY")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(seed)))
    return m


@pytest.fixture(scope="module")
def jax_side():
    model = jax_get_model("MLICPP_TINY")
    port = _port_model()
    params = to_flax(port.state_dict())
    x = np.random.default_rng(0).random(SHAPE, dtype=np.float32)

    def keep(mdl, name):
        return name == "__call__" and mdl.name in ("entropy_bottleneck", "h_a")

    def loss_fn(p, v, key):
        out, inter = model.apply({"params": p}, v, True, rngs={"noise": key},
                                 capture_intermediates=keep,
                                 mutable=["intermediates"])
        rd = jloss.rate_distortion_loss(out, v, LMBDA, "mse")
        aux = model.apply({"params": p}, method=JaxMLIC.aux_loss)
        return rd["loss"] + aux, (rd, aux, out, inter["intermediates"])

    args = (params, x, jax.random.key(3))
    (_, (rd, aux, out, inter)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)).lower(*args).compile(
            FAST_COMPILE)(*args)
    z = np.asarray(inter["h_a"]["__call__"][0])
    z_tilde = np.asarray(inter["entropy_bottleneck"]["__call__"][0][0])
    b, h, w, c = z.shape
    noise = (z_tilde - z).reshape(b * h * w, c).T       # [C, B*h*w]
    ev_args = (params, x)
    ev = jax.jit(lambda p, v: model.apply({"params": p}, v, False)).lower(
        *ev_args).compile(FAST_COMPILE)(*ev_args)
    return {"params": params, "x": x, "noise": np.ascontiguousarray(noise),
            "rd": jax.tree_util.tree_map(np.asarray, rd),
            "aux": float(aux), "out": jax.tree_util.tree_map(np.asarray, out),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "eval": jax.tree_util.tree_map(np.asarray, ev)}


# ----------------------------- small functions -----------------------------

def test_lower_bound_gradient_rule_both_branches():
    """Gradient passes where x >= bound or g < 0 (ties included), else 0;
    torch.maximum alone would halve it at the ties."""
    x = np.array([-2.0, -1.0, -1.0, 0.5, 0.5, 3.0, -5.0, 0.5], np.float32)
    g = np.array([1.0, -2.0, 3.0, 4.0, -5.0, 0.5, -0.25, 0.0], np.float32)
    bound = 0.5
    want, vjp = jax.vjp(lambda v: jmath.lower_bound(v, bound), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tmath.lower_bound(xt, bound)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    # below the bound: pushed up (g < 0) passes, pushed down is blocked
    assert xt.grad[1] == -2.0 and xt.grad[2] == 0.0 and xt.grad[4] == -5.0
    assert xt.grad[3] == 4.0                          # tie: passes whole


def test_quantize_ste_and_upper_bound():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(64) * 3).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    for jf, tf in ((jmath.quantize_ste, tmath.quantize_ste),
                   (lambda v: jmath.upper_bound(v, 0.7),
                    lambda v: tmath.upper_bound(v, 0.7))):
        want, vjp = jax.vjp(jf, jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        got = tf(xt)
        got.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))


def test_ckbd_split_merge():
    y = np.random.default_rng(2).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    ja, jn = jmath.ckbd_split(jnp.asarray(y))
    ta, tn = tmath.ckbd_split(_nchw(y))
    np.testing.assert_array_equal(_nhwc(ta), np.asarray(ja))
    np.testing.assert_array_equal(_nhwc(tn), np.asarray(jn))
    np.testing.assert_array_equal(_nhwc(tmath.ckbd_merge(ta, tn)),
                                  np.asarray(jmath.ckbd_merge(ja, jn)))


def test_gaussian_likelihood_values_and_gradients():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((2, 4, 4, 8)) * 4).astype(np.float32)
    s = np.abs(rng.standard_normal(y.shape) * 2).astype(np.float32)
    s.flat[:5] = [0.0, 0.05, 0.11, 0.2, 1e-3]          # both bound branches
    mu = rng.standard_normal(y.shape).astype(np.float32)

    def jf(a, b, c):
        return jnp.sum(jnp.log(jem.gaussian_likelihood(a, b, c)))
    want = jem.gaussian_likelihood(*map(jnp.asarray, (y, s, mu)))
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (y, s, mu)))
    ts = [_nchw(a).requires_grad_() for a in (y, s, mu)]
    got = tem.gaussian_likelihood(*ts)
    torch.sum(torch.log(got)).backward()
    _close(_nhwc(got), want)
    for t, g in zip(ts, jg):
        _grad_close(_nhwc(t.grad), g)


def test_bottleneck_training_half():
    """A 4-channel bottleneck with seeded parameters: forward in both modes
    (JAX's noise fed in) with the gradients of its log-likelihood,
    ``_likelihood``, ``ste_quantize`` and ``aux_loss`` with its gradient."""
    teb = tem.EntropyBottleneck(4)
    rng = np.random.default_rng(4)
    params = {k: (rng.standard_normal(p.shape) * 0.3
                  + (0.5 if k.startswith("matrix") else 0.0)).astype(
                      np.float32) for k, p in teb.named_parameters()}
    params["quantiles"] = (np.array([-9.0, 0.2, 11.0], np.float32)
                           + 0.1 * rng.standard_normal((4, 1, 3))).astype(
                               np.float32)
    teb.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    z = (rng.standard_normal((2, 3, 5, 4)) * 3).astype(np.float32)
    jeb = jem.EntropyBottleneck(channels=4)
    EB = jem.EntropyBottleneck

    def everything(p, zz):
        def ll(p, zz, training):
            out, lk = jeb.apply({"params": p}, zz, training,
                                rngs={"noise": jax.random.key(7)})
            return jnp.sum(jnp.log(lk)), (out, lk)
        modes = [jax.value_and_grad(ll, argnums=(0, 1), has_aux=True)(
            p, zz, t) for t in (True, False)]
        v = jnp.transpose(zz.reshape(-1, 4))[:, :7]
        return (modes, v, jeb.apply({"params": p}, v, method=EB._likelihood),
                jeb.apply({"params": p}, zz, method=EB.ste_quantize),
                jax.value_and_grad(lambda q: jeb.apply(
                    {"params": q}, method=EB.aux_loss))(p))

    args = (params, jnp.asarray(z))
    modes, v, lk_v, ste, (aux, gaux) = jax.jit(everything).lower(
        *args).compile(FAST_COMPILE)(*args)
    for training, ((_, (out, lk)), (gp, gz)) in zip((True, False), modes):
        out = np.asarray(out)
        noise = (out - z).reshape(-1, 4).T if training else None
        teb.zero_grad()
        zt = _nchw(z).requires_grad_()
        tout, tlk = teb(zt, training,
                        None if noise is None else torch.from_numpy(
                            np.ascontiguousarray(noise)))
        torch.sum(torch.log(tlk)).backward()
        _close(_nhwc(tout), out)
        _close(_nhwc(tlk), lk)
        _grad_close(_nhwc(zt.grad), gz)
        for k, p in teb.named_parameters():
            if k == "quantiles" and training:
                assert p.grad is None and not np.any(gp[k])
            else:
                _grad_close(p.grad, gp[k])
    _close(teb._likelihood(torch.from_numpy(np.array(v))).detach(), lk_v)
    _close(_nhwc(teb.ste_quantize(_nchw(z))), ste)
    teb.zero_grad()
    taux = teb.aux_loss()
    taux.backward()
    _close(taux.detach(), aux)
    _grad_close(teb.quantiles.grad, gaux["quantiles"])
    assert all(p.grad is None for k, p in teb.named_parameters()
               if k != "quantiles")


# ------------------------------- whole model -------------------------------

def _port_forward(jax_side, training=True):
    model = _port_model()
    noise = torch.from_numpy(jax_side["noise"]) if training else None
    out = model(torch.from_numpy(jax_side["x"]), training, noise)
    return model, out


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_forward_matches_flax(jax_side, training):
    with torch.no_grad():
        _, out = _port_forward(jax_side, training)
    want = jax_side["out"] if training else jax_side["eval"]
    _close(out["x_hat"].numpy(), want["x_hat"])
    for k in ("y", "z"):
        _close(_nhwc(out["likelihoods"][k]), want["likelihoods"][k])


def test_rd_aux_gradient_matches_jax(jax_side):
    """Every parameter's gradient of RD + aux loss, in the flax layout,
    against jax.grad; the quantiles' RD gradient is exactly zero.  A leaf
    whose exact gradient is zero (the key biases of the global contexts:
    a softmax over space does not see a constant added to every position)
    holds rounding noise in both frameworks, so there both must stay below
    1e-8 of the largest gradient instead."""
    model, out = _port_forward(jax_side)
    x = torch.from_numpy(jax_side["x"])
    rd = tloss.rate_distortion_loss(out, x, LMBDA, "mse")
    rd["loss"].backward(retain_graph=True)
    assert torch.count_nonzero(model.entropy_bottleneck.quantiles.grad) == 0
    aux = model.aux_loss()
    aux.backward()
    for k in ("loss", "bpp_loss", "mse_loss"):
        _close(rd[k].detach(), jax_side["rd"][k])
    _close(aux.detach(), jax_side["aux"])
    got = to_flax({n: p.grad for n, p in model.named_parameters()})
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        jax_side["grads"])[0])
    assert set(flat_got) == set(flat_want)
    top = max(float(np.max(np.abs(w))) for w in flat_want.values())
    for path, want in flat_want.items():
        if float(np.max(np.abs(want))) < 1e-8 * top:
            assert float(np.max(np.abs(flat_got[path]))) < 1e-8 * top, path
        else:
            _grad_close(flat_got[path], want)


@pytest.mark.parametrize("metric", ["mse", "ms-ssim", "charbonnier"])
def test_rate_distortion_loss(metric):
    """Values of each metric's loss (MS-SSIM at 192 px: it needs >= 176),
    and of the per-sample variant, on the same output and target."""
    rng = np.random.default_rng(6)
    x = rng.random((2, 192, 192, 3), dtype=np.float32)
    x_hat = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    lks = {"y": rng.uniform(0.01, 1, (2, 12, 12, 16)).astype(np.float32),
           "z": rng.uniform(0.01, 1, (2, 3, 3, 8)).astype(np.float32)}
    args = ({"x_hat": x_hat, "likelihoods": lks}, x)
    want = jax.jit(lambda o, t: jloss.rate_distortion_loss(
        o, t, LMBDA, metric)).lower(*args).compile(FAST_COMPILE)(*args)
    got = tloss.rate_distortion_loss(
        {"x_hat": torch.from_numpy(x_hat),
         "likelihoods": {k: torch.from_numpy(v) for k, v in lks.items()}},
        torch.from_numpy(x), LMBDA, metric)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    if metric == "mse":
        want = jloss.rate_distortion_loss_per_sample(
            {"x_hat": x_hat, "likelihoods": lks}, x, LMBDA)
        got = tloss.rate_distortion_loss_per_sample(
            {"x_hat": torch.from_numpy(x_hat), "likelihoods": {
                k: torch.from_numpy(v) for k, v in lks.items()}},
            torch.from_numpy(x), LMBDA)
        for k in want:
            _close(got[k], want[k])


# -------------------------------- optimizer --------------------------------

class _Small(torch.nn.Module):
    """A few parameters under flax-like names, one of them the quantiles."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(8)
        self.conv = torch.nn.Module()
        self.conv.weight = torch.nn.Parameter(torch.randn(4, 3, 3, 3,
                                                          generator=g))
        self.conv.bias = torch.nn.Parameter(torch.randn(4, generator=g))
        self.norm = torch.nn.Module()
        self.norm.weight = torch.nn.Parameter(torch.rand(5, generator=g))
        self.entropy_bottleneck = torch.nn.Module()
        self.entropy_bottleneck.quantiles = torch.nn.Parameter(
            torch.randn(4, 1, 3, generator=g))


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("freeze", [None, r"\['conv'\]"],
                         ids=["all", "frozen"])
def test_optimizer_matches_optax(opt, clip, freeze):
    """Three updates of both groups from the same gradients, through the
    trainer's backward-and-update, against make_optimizer (under
    ``freeze`` where a pattern is given), with a warmup and a milestone
    inside the three.  The loss sum(p * g) gives each parameter exactly
    the gradient g."""
    model = _Small()
    cfg = TrainConfig(learning_rate=1e-2, aux_learning_rate=1e-3,
                      clip_max_norm=clip, optimizer=opt, lr_milestones=(2,),
                      warmup_steps=1)
    frozen = topt.frozen_names(model, freeze)
    assert len(frozen) == (2 if freeze else 0)
    main, aux = topt.make_optimizers(model, 1e-2, 1e-3, opt, frozen)
    state = TrainState(model, main, aux, 0, torch.Generator())
    warm = optax.linear_schedule(0.0, 1e-2, 1)
    jsched = optax.join_schedules([warm, jopt.multistep_lr(1e-2, [1])], [1])
    tx = jopt.make_optimizer(jsched, 1e-3, clip, opt)
    if freeze:
        tx = jopt.freeze(tx, freeze)
    params = to_flax(model.state_dict())
    opt_state = tx.init(params)
    rng = np.random.default_rng(9)
    for _ in range(3):
        grads_t = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)) for n, p in model.named_parameters()}
        grads = to_flax(grads_t)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        norm = _update(state, cfg, sum(torch.sum(p * grads_t[n]) for n, p in
                                       model.named_parameters()))
        _close(norm, optax.global_norm({k: v for k, v in grads.items()
                                        if k != "entropy_bottleneck"}))
        got = to_flax(model.state_dict())
        for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            _close(leaf, want)
    assert state.step == 3


def test_schedules_match_optax():
    """The rate around each milestone (m-1, m, m+1) and over the warmup."""
    for warmup, milestones in ((0, (5, 9)), (4, (6, 10)), (3, ())):
        sched = topt.lr_schedule(2e-4, milestones, warmup)
        if warmup:
            after = (jopt.multistep_lr(2e-4, [m - warmup for m in milestones])
                     if milestones else (lambda s: 2e-4))
            jsched = optax.join_schedules(
                [optax.linear_schedule(0.0, 2e-4, warmup), after], [warmup])
        else:
            jsched = jopt.multistep_lr(2e-4, milestones)
        counts = set(range(warmup + 2)) | {m + d for m in milestones
                                           for d in (-1, 0, 1)}
        for c in sorted(counts):
            np.testing.assert_allclose(sched(c), float(jsched(c)), rtol=1e-6,
                                       err_msg=f"count {c}")


def test_freeze_selects_the_same_leaves(jax_side):
    """The same regex picks the same parameters as the JAX package's
    ``freeze``, which zeroes their updates."""
    model = get_model("MLICPP_TINY")
    pattern = r"\['g_a'\]\['rb0'\]|gamma|\['local_1'\]\['norm1'\]"
    ones = jax.tree_util.tree_map(np.ones_like, jax_side["params"])
    updates, _ = jopt.freeze(optax.identity(), pattern).update(ones, None)
    want = {jax.tree_util.keystr(p) for p, u in
            jax.tree_util.tree_flatten_with_path(updates)[0]
            if not np.any(u)}
    frozen = topt.frozen_names(model, pattern)
    from mlic_tpu_torch.weights import flax_keystr
    got = {flax_keystr(n, p.ndim) for n, p in model.named_parameters()
           if n in frozen}
    assert got == want and len(got) > 10
    assert any("['scale']" in k for k in got)


# ----------------------------------- data ----------------------------------

def test_batches_byte_identical():
    pool = np.random.default_rng(10).integers(0, 256, (5, 40, 48, 3),
                                              dtype=np.uint8)
    for as_float in (False, True):
        for a, b in zip(jfolder.pool_batches(pool, 3, 32, 4, 11, as_float),
                        tfolder.pool_batches(pool, 3, 32, 4, 11, as_float)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(jfolder.synthetic_batches(2, 32, 3, 12),
                    tfolder.synthetic_batches(2, 32, 3, 12)):
        assert a.tobytes() == b.tobytes()
    img = pool[0, :30]
    for seed in range(4):
        a = jfolder.random_resize_crop(img, 24, np.random.default_rng(seed))
        b = tfolder.random_resize_crop(img, 24, np.random.default_rng(seed))
        assert a.tobytes() == b.tobytes()
    small = pool[1, :20, :20]                          # reflect-padded
    a = jfolder.random_resize_crop(small, 24, np.random.default_rng(1))
    b = tfolder.random_resize_crop(small, 24, np.random.default_rng(1))
    assert a.tobytes() == b.tobytes()


def test_image_folder_dataset_byte_identical(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(13)
    for i, (h, w) in enumerate(((40, 52), (36, 36), (50, 44))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    jd = jfolder.ImageFolderDataset(str(tmp_path), 32, seed=5)
    td = tfolder.ImageFolderDataset(str(tmp_path), 32, seed=5)
    assert jd.files == td.files
    for _ in range(2):
        assert jd.sample_batch(4).tobytes() == td.sample_batch(4).tobytes()
    got = list(td.batches(2, 3))
    assert len(got) == 3 and got[0].shape == (2, 32, 32, 3)


# ------------------------------ the trainer --------------------------------

def _state(seed=0):
    cfg = TrainConfig(learning_rate=1e-3, seed=seed)
    return cfg, create_train_state(_port_model(seed), cfg, "cpu")


def test_steps_lower_the_loss_and_resume_exactly(tmp_path):
    """A few steps on synthetic batches (one, then ``Trainer.fit_epoch``)
    lower the loss; saving, restoring into a fresh trainer and stepping
    gives the uninterrupted run's loss and parameters."""
    cfg = TrainConfig(learning_rate=1e-3)
    trainer = Trainer(_port_model(), cfg, "cpu", log_fn=lambda line: None)
    state = trainer.state
    batches = list(tfolder.synthetic_batches(2, 64, 6, seed=1))
    first = float(train_step(state, batches[0], cfg)["loss"])
    last = trainer.fit_epoch(batches[1:4], log_freq=3)["loss"]
    assert np.isfinite([first, last]).all() and last < first
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    ckpt.save(str(state.step), state, loss=last)
    ref = [float(train_step(state, b, cfg)["loss"]) for b in batches[4:]]
    _, fresh = _state(seed=1)
    ckpt.restore(ckpt.latest_tag(), fresh)
    assert fresh.step == 4
    got = [float(train_step(fresh, b, cfg)["loss"]) for b in batches[4:]]
    assert got == ref
    for (n, p), q in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n
    ev = eval_step(fresh.model.eval(), batches[0], cfg)
    assert ev["x_hat"].shape == (2, 64, 64, 3) and np.isfinite(
        float(ev["psnr"]))


def test_train_cli_writes_and_resumes(tmp_path, capsys):
    """Three steps write checkpoint_3; ``--resume`` continues to step 5
    (with the dual-pass step); MLIC_FUSED_BLOCKS=1 is refused."""
    from mlic_tpu_torch.tools import train as cli
    args = ["--cpu", "--model", "MLICPP_TINY", "--synthetic", "--steps", "3",
            "--batch-size", "2", "--patch-size", "64", "--log-freq", "1",
            "--ckpt-dir", str(tmp_path)]
    first = cli.main(args)
    work = tmp_path / "mlic_tpu_torch"
    assert first["step"] == 3 and (work / "checkpoint_3.pt").is_file()
    assert (work / "logs" / "metrics.jsonl").is_file()
    again = cli.main(args[:5] + ["5", "--resume", "--dual"] + args[6:])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and again["step"] == 5
    assert again["loss"] > 0 and np.isfinite(again["first_loss"])
    assert (work / "checkpoint_5.pt").is_file()
    assert np.isfinite(again["loss"])
    with pytest.raises(SystemExit, match="MLIC_FUSED_BLOCKS"):
        os.environ["MLIC_FUSED_BLOCKS"] = "1"
        try:
            cli.main(args)
        finally:
            os.environ.pop("MLIC_FUSED_BLOCKS")


def test_fine_tuned_weights_round_trip_one_by_one_z():
    """From training to serving on the CPU: a 64x64 image (a z of 1x1)
    round-trips bit-exactly after an update.  (Permuted tensors with
    size-1 axes once kept channels-last strides, and the encoder's and
    decoder's h_s took different convolution algorithms.)"""
    from mlic_tpu_torch.codec import Codec
    cfg, state = _state()
    for b in tfolder.synthetic_batches(2, 64, 1, seed=2):
        train_step(state, b, cfg)
    codec = Codec(state.model, n_lanes=16, device="cpu")
    x = (np.random.default_rng(14).random((2, 64, 64, 3)) * 255).astype(
        np.uint8)
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
