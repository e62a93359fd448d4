"""Every configuration of ``CONFIGS`` in the port has the flax tree.

``to_flax(init_params(model))`` of each named configuration has exactly
the leaves and shapes of the flax ``init`` tree, taken by
``jax.eval_shape`` (no full-width initialisation in JAX), ``tools.macs``
counts its parameters, and the port builds each with the old synthesis
head and with dense convolutions.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from mlic_tpu.models.config import CONFIGS
from mlic_tpu.models.registry import get_model as jax_get_model
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.tools.macs import param_count
from mlic_tpu_torch.weights import init_params, to_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (see
    ``tests/test_torch_variants.py``); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_config_has_the_flax_tree(name):
    """``to_flax(init_params(m))`` has exactly the leaves and shapes of the
    flax ``init`` tree; the port also builds each configuration with the
    old synthesis head and with dense convolutions."""
    cfg = CONFIGS[name]
    model = jax_get_model(name)
    args = (True, 2, 1) if cfg.vbr else (True,)
    shapes = jax.eval_shape(
        lambda r, v: model.init(r, v, *args),
        {"params": jax.random.key(1), "noise": jax.random.key(2)},
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))["params"]
    port = get_model(name)
    got = dict(_leaves(to_flax(init_params(port,
                                           torch.Generator().manual_seed(0)))))
    assert got == dict(_leaves(shapes))
    # tools.macs counts the flax tree's parameters
    assert param_count(name) == sum(math.prod(s) for s in got.values())
    for overrides in ({"old_synthesis": True}, {"depthwise": False}):
        assert get_model(name, **overrides).state_dict()
