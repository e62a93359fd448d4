"""Weights for the port: from a flax parameter tree, or seeded random.

``from_flax`` maps the JAX package's parameter tree (nested dicts of numpy
arrays) onto the port's state_dict by path: the torch modules carry the
flax names, so only the leaf names and layouts change --

* conv kernels HWIO -> OIHW (depthwise [k,k,1,C] -> [C,1,k,k]),
* Dense kernels (in, out) -> (out, in); LocalContext's ``fusion`` stays a
  Dense over the flattened window in (i*w + j)*C + c order,
* LayerNorm ``scale`` -> ``weight``; everything else keeps name and shape.

``init_params`` draws random weights from the flax initializer families
(their distributions, not their bits) with a ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from mlic_tpu_torch.entropy.models import EntropyBottleneck
from mlic_tpu_torch.models.context import LocalContext
from mlic_tpu_torch.models.layers import GDN
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_flax(params) -> dict:
    """Flax ``params`` tree -> state_dict of f32 CPU tensors, one entry per
    flax leaf."""
    out = {}
    for path, leaf in _leaves(params):
        a = np.array(leaf, np.float32)
        name = path[-1]
        if name == "kernel":
            name = "weight"
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
        elif name == "scale":
            name = "weight"
        key = ".".join(path[:-1] + (name,))
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _lecun_normal(shape, generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated (+-2) normal, std sqrt(1/fan_in)
    corrected for the truncation; fan_in over (in, kh, kw) of OIHW or in of
    a Dense [out, in]."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def init_params(model: MLICPlusPlus, generator: torch.Generator) -> dict:
    """Seeded random state_dict for ``model`` (CPU tensors)."""
    ped = GDN._OFFSET ** 2
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, GDN):
                v = (torch.full(shape, math.sqrt(1.0 + ped)) if pname == "beta"
                     else torch.sqrt(0.1 * torch.eye(shape[0]) + ped))
            elif isinstance(mod, nn.LayerNorm):
                v = torch.ones(shape) if pname == "weight" else torch.zeros(shape)
            elif isinstance(mod, LocalContext):          # rel_pos_table
                v = torch.empty(shape)
                nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                v = v * 0.02
            elif isinstance(mod, EntropyBottleneck):
                v = _eb_init(mod, pname, shape, generator)
            elif pname == "weight":
                v = _lecun_normal(shape, generator)
            else:
                v = torch.zeros(shape)
            out[f"{mod_name}.{pname}" if mod_name else pname] = v
    return out


def _eb_init(mod: EntropyBottleneck, pname: str, shape, generator):
    """The factorized prior's flax initializers (entropy/models.py:120)."""
    if pname.startswith("matrix_"):
        scale = mod.init_scale ** (1.0 / (len(mod.filters) + 1))
        return torch.full(shape, math.log(math.expm1(1.0 / scale / shape[1])))
    if pname.startswith("bias_"):
        return torch.rand(shape, generator=generator) - 0.5
    if pname == "quantiles":
        q = torch.tensor([-mod.init_scale, 0.0, mod.init_scale])
        return q.reshape(1, 1, 3).repeat(shape[0], 1, 1)
    return torch.zeros(shape)                          # factor_k
