"""The port's reference-checkpoint tools against the JAX package's, on the
CPU.

``mlic_tpu_torch.tools.convert_reference_checkpoint`` maps a reference
(PyTorch MLIC++) state_dict straight onto the port's; the JAX tool
(``tools/convert_reference_checkpoint.py``) maps it onto flax params, which
``weights.from_flax`` carries to the port.  The two must agree name for
name and bit for bit.  The reference-style dicts are the JAX tool's
``invert`` of flax params drawn by the flax ``init`` (MLICPP_TINY
depthwise and dense, MLICPP_TINY_VBR with the variable-rate hyper prior,
the small decoder at TINY widths), so every layout the mapping holds is
exercised.  Dense TINY's forward on the converted weights agrees with the
flax model's on the same weights within 1e-5, the tolerance of the JAX
package's own variant tests.  The CLI reads a ``.pth.tar`` as the
reference writes it; ``make_bench_ckpt`` reduces a trainer checkpoint to
its weights.  The whole-model JAX programs compile at XLA optimization
level 0.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.models.config import model_config as jax_model_config
from mlic_tpu.models.mlicpp import MLICPlusPlus as JaxMLIC
from mlic_tpu.models.vbr import MLICPlusPlusVbr as JaxMLICVbr
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools import convert_reference_checkpoint as crc
from mlic_tpu_torch.tools import make_bench_ckpt
from mlic_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                          train_step)
from mlic_tpu_torch.utils.checkpoint import CheckpointManager
from mlic_tpu_torch.weights import from_flax, init_params, load_checkpoint
from tools import convert_reference_checkpoint as jcrc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CONFIGS = {
    "tiny": ("MLICPP_TINY", {}),
    "tiny_dense": ("MLICPP_TINY", {"depthwise": False}),
    "tiny_vbr_vr_entbttlnck": ("MLICPP_TINY_VBR", {"vr_entbttlnck": True}),
    "small_decoder_tiny": ("MLICPP_M_SMALL_DEC",
                           {"N": 32, "M": 64, "slice_num": 2}),
}
# Reference buffers the converter skips (compressai's CDF tables and
# lower-bound constants, the Swin index).
BUFFERS = {
    "entropy_bottleneck._quantized_cdf": torch.zeros(32, 10,
                                                     dtype=torch.int32),
    "entropy_bottleneck._offset": torch.zeros(32, dtype=torch.int32),
    "entropy_bottleneck._cdf_length": torch.zeros(32, dtype=torch.int32),
    "entropy_bottleneck.likelihood_lower_bound.bound": torch.tensor(1e-9),
    "entropy_bottleneck.target": torch.tensor([-10.0, 0.0, 10.0]),
    "gaussian_conditional._quantized_cdf": torch.zeros(64, 10,
                                                       dtype=torch.int32),
    "gaussian_conditional.scale_table": torch.linspace(0.11, 256.0, 64),
    "gaussian_conditional.lower_bound_scale.bound": torch.tensor(0.11),
    "local_context.0.relative_position_index": torch.zeros(
        25, 25, dtype=torch.long),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (six
    pytest-xdist workers share the machine's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(key):
    name, overrides = CONFIGS[key]
    return (dataclasses.replace(jax_model_config(name), **overrides),
            get_model(name, **overrides).cfg)


def _jax_model(cfg):
    return JaxMLICVbr(cfg=cfg) if cfg.vbr else JaxMLIC(cfg=cfg)


def _flax_init(cfg) -> dict:
    """The flax ``init``'s params (a 16x16 frame: the parameters' shapes
    do not depend on it), as numpy."""
    model = _jax_model(cfg)
    extra = (2, 1) if cfg.vbr else ()
    args = ({"params": jax.random.key(0), "noise": jax.random.key(1)},
            jnp.zeros((1, 16, 16, 3)))
    params = jax.jit(lambda r, v: model.init(r, v, True, *extra)).lower(
        *args).compile(FAST_COMPILE)(*args)["params"]
    return jax.tree.map(np.asarray, jax.device_get(params))


_INIT = {}


def _params(key):
    if key not in _INIT:
        _INIT[key] = _flax_init(_cfgs(key)[0])
    return _INIT[key]


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_convert_equals_the_jax_tool_through_from_flax(key):
    """flax params -> the JAX tool's ``invert`` (a reference state_dict)
    -> the port's ``convert``: ``from_flax`` of the params, name for name
    and bit for bit, no leftover, every row of both mappings matched the
    same reference keys; the JAX tool's ``convert`` of the same dict
    through ``from_flax`` too; ``to_reference`` gives ``invert``'s dict;
    the port's model loads the result strictly."""
    jcfg, cfg = _cfgs(key)
    params = _params(key)
    ref = jcrc.invert(params, jcfg)
    got, matched, leftovers = crc.convert(ref, cfg)
    want = from_flax(params)
    assert leftovers == []
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], t), name
    jparams, jmatched, jleft = jcrc.convert(ref, jcfg)
    assert sorted(matched) == sorted(jmatched) and jleft == []
    through_jax = from_flax(jparams)
    assert all(torch.equal(got[n], through_jax[n]) for n in want)
    assert [r for r, _, _ in crc.build_mapping(cfg)] == \
        [r for r, _, _ in jcrc.build_mapping(jcfg)]
    back = crc.to_reference(got, cfg)
    assert sorted(back) == sorted(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(back[k].numpy(), a, err_msg=k)
    name, overrides = CONFIGS[key]
    get_model(name, **overrides).load_state_dict(got, strict=True)


def test_dense_tiny_forward_matches_flax_on_converted_weights():
    """Dense MLICPP_TINY in f32: the port on ``convert`` of the reference
    dict and the flax model on the params it came from give the same
    x_hat and likelihoods within 1e-5 (relative where the scale exceeds
    1), on the same frame and z noise (JAX's draw)."""
    jcfg, cfg = _cfgs("tiny_dense")
    params = _params("tiny_dense")
    state, _, leftovers = crc.convert(jcrc.invert(params, jcfg), cfg)
    assert leftovers == []
    port = get_model("MLICPP_TINY", depthwise=False)
    port.load_state_dict(state, strict=True)
    model = _jax_model(jcfg)
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)

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

    def close(a, want):
        a, want = np.asarray(a, np.float64), np.asarray(want, np.float64)
        assert a.shape == want.shape
        scale = max(1.0, float(np.max(np.abs(want))))
        assert float(np.max(np.abs(a - want))) <= 1e-5 * scale

    close(got["x_hat"].numpy(), out["x_hat"])
    for k in ("y", "z"):
        close(got["likelihoods"][k].permute(0, 2, 3, 1).numpy(),
              out["likelihoods"][k])


def _reference_file(path, model, seed=0):
    """A reference-style checkpoint of ``model``'s seeded weights:
    ``module.`` prefixes, compressai's buffers, an optimizer entry."""
    sd = crc.to_reference(init_params(model,
                                      torch.Generator().manual_seed(seed)),
                          model.cfg)
    sd.update(BUFFERS)
    torch.save({"epoch": 3, "optimizer": {"state": {}, "param_groups": []},
                "state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return sd


def test_cli_reads_a_reference_file_and_the_model_loads_it(tmp_path,
                                                          capsys):
    """The CLI on a ``.pth.tar`` with ``module.`` prefixes, CDF buffers and
    an optimizer entry (dense TINY): every tensor converted, no leftover,
    the file read back by ``load_checkpoint`` equal to the weights it came
    from and loaded strictly; ``--strict`` passes too."""
    model = get_model("MLICPP_TINY", depthwise=False)
    want = init_params(model, torch.Generator().manual_seed(0))
    src, out = tmp_path / "ref.pth.tar", tmp_path / "port.pt"
    sd = _reference_file(src, model)
    state = crc.main(["--torch-ckpt", str(src), "--model", "MLICPP_TINY",
                      "--dense", "--strict", "--out", str(out)])
    printed = capsys.readouterr().out
    matched = crc.convert(sd, model.cfg)[1]
    assert f"converted {len(matched)} tensors; unmapped reference keys: " \
           f"0\nwrote {out}: {len(want)} tensors" in printed
    loaded = load_checkpoint(str(out))
    assert sorted(loaded) == sorted(want) == sorted(state)
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    get_model("MLICPP_TINY", depthwise=False).load_state_dict(loaded,
                                                              strict=True)


def test_strict_refuses_an_unknown_key_and_self_test_passes(capsys):
    """``convert(strict=True)`` raises on a key that maps nowhere and is
    not a skipped buffer (without it, the key is a leftover);
    ``--self-test`` round-trips seeded weights exactly."""
    model = get_model("MLICPP_TINY")
    sd = crc.to_reference(init_params(model, torch.Generator().manual_seed(1)),
                          model.cfg)
    sd.update(BUFFERS)
    _, _, leftovers = crc.convert(sd, model.cfg, strict=True)
    assert leftovers == []
    sd["module.g_a.analysis_transform.9.weight"] = torch.zeros(3)
    _, _, leftovers = crc.convert(sd, model.cfg)
    assert leftovers == ["g_a.analysis_transform.9.weight"]
    with pytest.raises(KeyError, match="analysis_transform.9"):
        crc.convert(sd, model.cfg, strict=True)
    assert crc.main(["--self-test"]) is None
    assert "self-test OK: 343/343 tensors" in capsys.readouterr().out


@pytest.mark.parametrize("bf16", [False, True])
def test_make_bench_ckpt_from_a_trainer_checkpoint(tmp_path, bf16):
    """A TINY trainer checkpoint (``CheckpointManager``, after one step:
    optimizer state, step, generator) reduced to its weights; the file
    holds the model's tensors alone, bfloat16 under ``--bf16``, and
    ``load_checkpoint`` gives them back in f32 (rounded to bf16 once)."""
    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    cfg = TrainConfig(learning_rate=1e-3)
    state = create_train_state(model, cfg, "cpu")
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    train_step(state, torch.from_numpy(x), cfg)
    src = CheckpointManager(str(tmp_path / "ckpt")).save("1", state)
    dst = tmp_path / "bench.pt"
    make_bench_ckpt.main([src, str(dst)] + (["--bf16"] if bf16 else []))
    raw = torch.load(dst, map_location="cpu", weights_only=True)
    want = state.model.state_dict()
    assert sorted(raw) == sorted(want)
    assert {t.dtype for t in raw.values()} == \
        {torch.bfloat16 if bf16 else torch.float32}
    got = load_checkpoint(str(dst))
    for k, t in want.items():
        t = t.to(torch.bfloat16).float() if bf16 else t
        assert got[k].dtype == torch.float32 and torch.equal(got[k], t), k


def test_make_bench_ckpt_from_an_orbax_directory(tmp_path):
    """The repository's trained MLICPP_S (an orbax directory, read by
    ``read_orbax``) to a weights file that loads strictly, equal to the
    directory's weights."""
    src = os.path.join(ROOT, "ckpts", "bench_default")
    dst = tmp_path / "bench_default.pt"
    make_bench_ckpt.main([src, str(dst)])
    want, got = load_checkpoint(src), load_checkpoint(str(dst))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    get_model("MLICPP_S").load_state_dict(got, strict=True)
