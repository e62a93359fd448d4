"""The port's variable-bitrate family against the JAX package, on the CPU.

MLICPP_TINY_VBR (3 levels, gains 0.15 / 0.4 / 1.0) on [1, 64, 64, 3]
frames for the model and [2, 64, 128, 3] for the codec.  Both frameworks
run the same weights (the port's seeded ones, mapped to the flax layout by
``weights.to_flax``) and, in training, the same z noise (JAX's draw, read
from its bottleneck's output).  Tolerances are those of
``test_torch_train.py``: f32 values 1e-5 (relative to the tensor's scale
where it exceeds 1).  The factorized prior's tables are bit-equal.  The
codec's round trips are the port's own, bit-exact, and its top level
(gain 1.0) writes MLICPP_TINY's bytes.  The whole-model JAX programs
compile at XLA optimization level 0: the stage-2 forward (one program for
every level) of the twin and of its small-decoder twin (TINY_SD_VBR), the
forward with both options on, and two MGDA steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.entropy import models as jem
from mlic_tpu.models.config import model_config
from mlic_tpu.models.vbr import MLICPlusPlusVbr as JaxVbr
from mlic_tpu.train import optimizers as jopt
from mlic_tpu.train import trainer as jtrainer
from mlic_tpu.train import vbr as jvbr
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.entropy import models as tem
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.train.trainer import TrainConfig, create_train_state
from mlic_tpu_torch.train.vbr import frank_wolfe_minnorm, vbr_train_step
from mlic_tpu_torch.utils.checkpoint import load_matching
from mlic_tpu_torch.weights import from_flax, init_params, to_flax


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


NAME = "MLICPP_TINY_VBR"
SHAPE = (1, 64, 64, 3)
CODEC_SHAPE = (2, 64, 128, 3)
N_LANES = 32
SEED = 0
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# (level, inputscale): every level, a continuous gain below and one above
# the top level (larger symbols, more escapes)
LEVELS = [(0, 0.0), (1, 0.0), (2, 0.0), (1, 0.3), (0, 1.7)]
BOTH = {"vr_entbttlnck": True, "quant_offset": True}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port(seed=SEED, **overrides):
    m = get_model(NAME, **overrides)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(seed)))
    return m


def _jax_model(**overrides):
    return JaxVbr(cfg=dataclasses.replace(model_config(NAME), **overrides))


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _stage2_forward(levels, **overrides):
    """JAX's stage-2 training forward at each (level, inputscale) of
    ``levels`` (one program, the level and inputscale traced) with the
    noise of the MGDA step's first draw, and the noise read back."""
    port = _port(**overrides)
    params = to_flax(port.state_dict())
    model = _jax_model(**overrides)
    x = _frames(SHAPE, 1)
    _, noise_rng = jax.random.split(jax.random.key(SEED))

    def keep(mdl, name):
        return name == "__call__" and mdl.name in ("entropy_bottleneck", "h_a")

    def f(p, v, s, isc, key):
        out, inter = model.apply({"params": p}, v, True, 2, s, isc,
                                 rngs={"noise": key},
                                 capture_intermediates=keep,
                                 mutable=["intermediates"])
        return out, inter["intermediates"]

    args = (params, x, jnp.int32(0), jnp.float32(0.0), noise_rng)
    prog = jax.jit(f).lower(*args).compile(FAST_COMPILE)
    outs, noise = {}, None
    for s, isc in levels:
        out, inter = prog(params, x, jnp.int32(s), jnp.float32(isc),
                          noise_rng)
        outs[(s, isc)] = jax.tree_util.tree_map(np.asarray, out)
        z = np.asarray(inter["h_a"]["__call__"][0])
        z_tilde = np.asarray(inter["entropy_bottleneck"]["__call__"][0][0])
        b, h, w, c = z.shape
        noise = np.ascontiguousarray((z_tilde - z).reshape(b * h * w, c).T)
    return {"params": params, "x": x, "outs": outs, "noise": noise}


@pytest.fixture(scope="module")
def fwd():
    return _stage2_forward(LEVELS)


@pytest.mark.parametrize("s,inputscale", LEVELS)
def test_stage2_forward_matches_flax(fwd, s, inputscale):
    """x_hat and both likelihoods of the stage-2 training forward."""
    model = _port()
    with torch.no_grad():
        out = model(torch.from_numpy(fwd["x"]), True,
                    torch.from_numpy(fwd["noise"]), s=s,
                    inputscale=inputscale)
    want = fwd["outs"][(s, inputscale)]
    _close(out["x_hat"].numpy(), want["x_hat"])
    for k in ("y", "z"):
        _close(_nhwc(out["likelihoods"][k]), want["likelihoods"][k])


SD = {"small_decoder": True}     # TINY_SD_VBR of tests/test_vbr.py


@pytest.fixture(scope="module")
def sd_fwd():
    return _stage2_forward([(s, 0.0) for s in range(3)], **SD)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_small_decoder_twin_forward_matches_flax(sd_fwd, s):
    """The small-decoder VBR twin's stage-2 training forward at every
    level: it inherits the small decoder's modules and adds only the VBR
    machinery."""
    model = _port(**SD)
    with torch.no_grad():
        out = model(torch.from_numpy(sd_fwd["x"]), True,
                    torch.from_numpy(sd_fwd["noise"]), s=s)
    want = sd_fwd["outs"][(s, 0.0)]
    _close(out["x_hat"].numpy(), want["x_hat"])
    for k in ("y", "z"):
        _close(_nhwc(out["likelihoods"][k]), want["likelihoods"][k])


def test_eval_step_at_a_level(fwd):
    """``trainer.eval_step`` at level s: the evaluation forward there and
    that level's lambda."""
    from mlic_tpu_torch.loss import rate_distortion_loss
    from mlic_tpu_torch.train.trainer import eval_step
    model = _port().eval()
    x = torch.from_numpy(fwd["x"])
    got = eval_step(model, fwd["x"], TrainConfig(), s=0)
    with torch.no_grad():
        want = rate_distortion_loss(model(x, False, s=0), x,
                                    model.cfg.lmbda[0])
    assert float(got["loss"]) == float(want["loss"])
    assert np.isfinite(float(got["psnr"]))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_stage1_equals_base_forward(fwd, training):
    """Stage 1 is MLICPP_TINY's forward on the shared weights, bit for
    bit."""
    vbr = _port()
    base = get_model("MLICPP_TINY")
    base.load_state_dict(load_matching(base.state_dict(),
                                       vbr.state_dict())[0])
    x = torch.from_numpy(fwd["x"])
    noise = torch.from_numpy(fwd["noise"]) if training else None
    with torch.no_grad():
        got = vbr(x, training, noise, stage=1, s=0)
        want = base(x, training, noise)
    assert torch.equal(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        assert torch.equal(got["likelihoods"][k], want["likelihoods"][k])


def test_from_flax_covers_every_leaf():
    """Every leaf of the flax VBR tree with both options (``Gain``,
    QuantABCD, zqstep) maps onto the port's state_dict, shapes included,
    and the plain model's is that tree without zqstep; ``to_flax`` inverts
    ``from_flax``; ``init_params`` starts Gain at ``gain_init``."""
    model = _jax_model(**BOTH)
    shapes = jax.eval_shape(
        lambda r, v: model.init(r, v, True, 2, 1),
        {"params": jax.random.key(1), "noise": jax.random.key(2)},
        jax.ShapeDtypeStruct(SHAPE, jnp.float32))["params"]
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes)
    sd = from_flax(zeros)
    port = get_model(NAME, **BOTH)
    assert set(sd) == set(port.state_dict())
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    plain = set(get_model(NAME).state_dict())
    assert plain == {k for k in sd if not k.startswith("zqstep_")}
    own = _port(**BOTH).state_dict()
    back = from_flax(to_flax(own))
    assert all(torch.equal(back[k], own[k]) for k in own)
    assert torch.equal(own["Gain"], torch.tensor(model.cfg.gain_init))


@pytest.fixture(scope="module")
def options_fwd():
    """JAX's evaluation forward with both options on, one program for
    levels 0 and 2."""
    params = to_flax(_port(**BOTH).state_dict())
    model = _jax_model(**BOTH)
    x = _frames(SHAPE, 2)
    args = (params, x, jnp.int32(0))
    prog = jax.jit(lambda p, v, lvl: model.apply(
        {"params": p}, v, False, 2, lvl)).lower(*args).compile(FAST_COMPILE)
    return x, {s: prog(params, x, jnp.int32(s)) for s in (0, 2)}


def test_to_flax_copies_the_parameters():
    """``to_flax`` returns arrays of their own: an update of the model in
    place (an optimizer's step) leaves the tree, and a JAX program running
    on it, alone."""
    model = _port()
    tree = to_flax(model.state_dict())
    before = np.array(tree["Gain"]), np.array(tree["qabcd_0"]["bias"])
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    np.testing.assert_array_equal(tree["Gain"], before[0])
    np.testing.assert_array_equal(tree["qabcd_0"]["bias"], before[1])


@pytest.mark.parametrize("s", [0, 2])
def test_options_forward_matches_flax(options_fwd, s):
    """QuantABCD's dead-zone rounding and the variable-step bottleneck
    (its z on the zqstep grid), evaluation mode."""
    port = _port(**BOTH)
    x, outs = options_fwd
    want = outs[s]
    with torch.no_grad():
        got = port(torch.from_numpy(x), False, s=s)
        plain = port(torch.from_numpy(x), False, s=s, quant_offset=False)
    _close(got["x_hat"].numpy(), want["x_hat"])
    for k in ("y", "z"):
        _close(_nhwc(got["likelihoods"][k]), want["likelihoods"][k])
    if s == 2:      # at gain 0.15 the seeded latent rounds to 0 everywhere
        assert not torch.equal(got["x_hat"], plain["x_hat"])


def _eb_params(channels=4, spread=10.0, seed=4):
    """A seeded factorized prior's parameters (numpy, flax names)."""
    rng = np.random.default_rng(seed)
    teb = tem.EntropyBottleneck(channels)
    params = {k: (rng.standard_normal(p.shape) * 0.3
                  + (0.5 if k.startswith("matrix") else 0.0)).astype(
                      np.float32) for k, p in teb.named_parameters()}
    params["quantiles"] = (np.array([-spread, 0.2, spread * 1.1], np.float32)
                           + 0.1 * rng.standard_normal((channels, 1, 3))
                           ).astype(np.float32)
    return params


@pytest.mark.parametrize("qs", [0.5, 1.7])
def test_bottleneck_vbr_matches_flax(qs):
    """``EntropyBottleneckVbr`` at step qs: its output and likelihoods in
    both modes (JAX's noise fed in) and ``quantize_variable``."""
    params = _eb_params()
    teb = tem.EntropyBottleneckVbr(4)
    teb.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    jeb = jem.EntropyBottleneckVbr(channels=4)
    z = (np.random.default_rng(5).standard_normal((2, 3, 5, 4)) * 3).astype(
        np.float32)
    zt = torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2)))
    for training in (True, False):
        out, lk = jeb.apply({"params": params}, jnp.asarray(z), training, qs,
                            rngs={"noise": jax.random.key(7)})
        out = np.asarray(out)
        noise = ((out - z) / qs).reshape(-1, 4).T if training else None
        with torch.no_grad():
            tout, tlk = teb(zt, training, None if noise is None else
                            torch.from_numpy(np.ascontiguousarray(noise)),
                            qs=qs)
        _close(_nhwc(tout), out)
        _close(_nhwc(tlk), lk)
    want = jeb.apply({"params": params}, jnp.asarray(z), qs,
                     method=jem.EntropyBottleneckVbr.quantize_variable)
    _close(_nhwc(teb.quantize_variable(zt, qs).detach()), want)


@pytest.mark.parametrize("qs", [0.5, 1.0, 1.7])
def test_bottleneck_tables_bit_equal_jax(qs):
    params = _eb_params(channels=6, spread=12.0, seed=6)
    got = tem.entropy_bottleneck_tables(params, qs=qs)
    want = jem.entropy_bottleneck_tables(params, 6, qs=qs)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    if qs == 0.5:       # the rows of a step below 1 are about twice as long
        wide = tem.entropy_bottleneck_tables(params, qs=1.0)
        assert got[0].shape[1] > 1.8 * wide[0].shape[1]


def _wide_steps(model):
    """Make the variable-step bottleneck's rows wide enough to cross the
    Gaussian rows' width at a step near 0.5, and zqstep give about 1.0 at
    the top level (1/gain = 1) and 0.5 at level 0 (1/gain = 6.67):
    softplus(0.713 - 0.1718 / gain)."""
    with torch.no_grad():
        q = model.entropy_bottleneck.quantiles
        q[:, 0, 0] = q[:, 0, 1] - 1000.0
        q[:, 0, 2] = q[:, 0, 1] + 1000.0
        model.zqstep_0.weight.fill_(1.0)
        model.zqstep_0.bias.zero_()
        model.zqstep_1.weight.copy_(torch.eye(10))
        model.zqstep_1.bias.zero_()
        model.zqstep_2.weight.fill_(-0.1718 / 10)
        model.zqstep_2.bias.fill_(0.713)
    return model


@pytest.mark.parametrize("case", ["levels", "inputscale", "quant_offset",
                                  "vr_entbttlnck", "small_decoder"])
def test_codec_round_trip_bit_exact(case):
    """The port's compress -> decompress at two requests each: y_hat and
    x_hat bit-identical.  ``vr_entbttlnck`` codes a step near 1 first and
    one near 0.5 second, whose rows are wider than every cached step's:
    the codec rebuilds the first step's tables at the new width, and its
    stream still decodes."""
    overrides = {"quant_offset": {"quant_offset": True},
                 "vr_entbttlnck": BOTH, "small_decoder": SD}.get(case, {})
    requests = {"levels": [(0, 0.0), (2, 0.0)],
                "small_decoder": [(0, 0.0), (1, 0.0), (2, 0.0)],
                "inputscale": [(1, 0.3), (0, 1.7)],
                "quant_offset": [(0, 0.0), (1, 0.45)],
                "vr_entbttlnck": [(2, 0.0), (0, 0.0)]}[case]
    model = _port(**overrides)
    if case == "vr_entbttlnck":
        _wide_steps(model)
    codec = Codec(model, n_lanes=N_LANES, device="cpu")
    codec.update()
    x = (_frames(CODEC_SHAPE, 3) * 255).astype(np.uint8)
    encoded, widths = [], []
    for s, isc in requests:
        enc = codec.compress(x, s=s, inputscale=isc)
        dec = codec.decompress(enc["strings"], enc["shape"], s=s,
                               inputscale=isc)
        assert torch.equal(enc["y_hat"], dec["y_hat"])
        assert torch.equal(enc["x_hat"], dec["x_hat"])
        assert torch.isfinite(dec["x_hat"]).all()
        encoded.append(enc)
        widths.append(codec.tables["cdf_rows"].shape[1])
    sizes = [sum(len(b) for b in e["strings"][0]) for e in encoded]
    if case in ("levels", "small_decoder"):
        assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
    if case == "vr_entbttlnck":
        steps = sorted(codec._zqs_cache.values())
        assert 0.49 < steps[0] < 0.51 and 0.95 < steps[1] < 1.05, steps
        assert widths[0] < widths[1], widths
        assert all(t["cdf_rows"].shape[1] == widths[1]
                   for t in codec._by_step.values())
        s, isc = requests[0]
        dec = codec.decompress(encoded[0]["strings"], encoded[0]["shape"],
                               s=s, inputscale=isc)
        assert torch.equal(encoded[0]["y_hat"], dec["y_hat"])


def test_top_level_writes_the_fixed_rate_bytes():
    """At gain 1.0 (level 2) MLICPP_TINY_VBR's streams and reconstruction
    are MLICPP_TINY's on the shared weights, byte for byte."""
    vbr = _port()
    base = get_model("MLICPP_TINY")
    base.load_state_dict(load_matching(base.state_dict(),
                                       vbr.state_dict())[0])
    x = (_frames(CODEC_SHAPE, 4) * 255).astype(np.uint8)
    got = Codec(vbr, n_lanes=N_LANES, device="cpu").compress(x, s=2)
    want = Codec(base, n_lanes=N_LANES, device="cpu").compress(x)
    assert got["strings"] == want["strings"]
    assert torch.equal(got["x_hat"], want["x_hat"])
    lower = Codec(vbr, n_lanes=N_LANES, device="cpu").compress(x, s=1)
    assert lower["strings"] != want["strings"]


@pytest.mark.parametrize("n,seed", [(3, 0), (6, 1), (4, 2)])
def test_frank_wolfe_matches_jax(n, seed):
    """Random Gram matrices; the last case has two equal gradients."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, 17)).astype(np.float32)
    if seed == 2:
        g[3] = g[1]
    gram = (g @ g.T).astype(np.float32)
    want = np.asarray(jvbr.frank_wolfe_minnorm(jnp.asarray(gram)))
    got = frank_wolfe_minnorm(torch.from_numpy(gram)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5 and (got >= 0).all()


@pytest.mark.parametrize("gradnorm,train_gain,optimizer",
                         [("none", False, "adamw"), ("loss", True, "sgd")])
def test_vbr_train_step_matches_jax(fwd, gradnorm, train_gain, optimizer):
    """One MGDA step against ``mlic_tpu.train.vbr.make_vbr_train_step`` on
    the same weights, batch and noise: per-level losses and bpp, alpha,
    and every parameter after the update.  Without ``train_gain`` Gain's
    gradient is exactly zero, and AdamW still decays it as optax does; with
    it (SGD: the update is the combined gradient) it moves by its summed
    gradient.  Adam's first update of an element is lr * g / (|g| + eps):
    where |g| is within a hundred eps (1e-6), the last bits of g, in which
    the frameworks differ, move it visibly, so there the two may move apart
    by up to twice the rate; every other element is held at 1e-5."""
    lr = 1e-3
    model = _port(train_gain=train_gain)
    params = to_flax(model.state_dict())
    gain0 = model.Gain.detach().clone()
    jmodel = _jax_model(train_gain=train_gain)
    tx = jopt.make_optimizer(lr, 1e-3, 1.0, optimizer)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params),
                                rng=jax.random.key(SEED))
    step = jvbr.make_vbr_train_step(jmodel, tx, jtrainer.TrainConfig(),
                                    gradnorm)
    args = (state, fwd["x"])
    new, want = step.lower(*args).compile(FAST_COMPILE)(*args)

    cfg = TrainConfig(learning_rate=lr, optimizer=optimizer)
    st = create_train_state(model, cfg, "cpu")
    got = vbr_train_step(st, fwd["x"], cfg, gradnorm,
                         noise=torch.from_numpy(fwd["noise"]))
    for k in ("loss", "bpp_loss", "loss_per_level", "bpp_per_level"):
        _close(got[k].numpy(), want[k])
    np.testing.assert_allclose(got["alpha"].numpy(), want["alpha"],
                               atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    after, flax_grads = to_flax(model.state_dict()), to_flax(grads)
    flat_want = jax.tree_util.tree_flatten_with_path(new.params)[0]
    assert len(flat_want) == len(grads)
    for path, w in flat_want:
        leaf, g = after, flax_grads
        for k in path:
            leaf, g = leaf[k.key], g[k.key]
        w = np.asarray(w)
        if optimizer == "adamw":
            noise_level = np.abs(g) < 1e-6
            assert np.all(np.abs(leaf - w)[noise_level] <= 2 * lr), path
            leaf, w = leaf[~noise_level], w[~noise_level]
        _close(leaf, w)
    gain = model.Gain.detach()
    if train_gain:
        assert not torch.equal(gain, gain0)
    else:
        assert torch.count_nonzero(model.Gain.grad) == 0
        # optax decays as p - lr * (wd * p), torch as p * (1 - lr * wd)
        np.testing.assert_allclose(gain.numpy(), new.params["Gain"],
                                   rtol=1.2e-7, atol=0)
        torch.testing.assert_close(gain, gain0 * (1 - lr * 1e-4), rtol=0,
                                   atol=1e-9)
