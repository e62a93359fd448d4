"""Weights for the port: from a flax parameter tree, from a checkpoint file
or directory, or seeded random.

``from_flax`` maps the JAX package's parameter tree (nested dicts of numpy
arrays) onto the port's state_dict by path: the torch modules carry the
flax names, so only the leaf names and layouts change --

* conv kernels HWIO -> OIHW (depthwise [k,k,1,C] -> [C,1,k,k]),
* Dense kernels (in, out) -> (out, in); LocalContext's ``fusion`` stays a
  Dense over the flattened window in (i*w + j)*C + c order,
* LayerNorm ``scale`` -> ``weight``; everything else keeps name and shape
  (the VBR model's ``Gain``; its QuantABCD and zqstep MLPs are Dense
  layers).

``to_flax`` is its inverse (the flax layout of a state_dict, to compare
parameters and gradients leaf by leaf).  ``load_checkpoint`` reads an orbax
directory of the JAX package or a torch file of the port.
``init_params`` draws random weights from the flax initializer families
(their distributions, not their bits) with a ``torch.Generator``; the VBR
model's ``Gain`` starts at ``cfg.gain_init`` exactly, as in flax.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from mlic_tpu_torch.entropy.models import EntropyBottleneck
from mlic_tpu_torch.models.context import LocalContext
from mlic_tpu_torch.models.layers import GDN
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus
from mlic_tpu_torch.utils.checkpoint import read_orbax


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


def flax_path(name: str, ndim: int) -> tuple:
    """A state_dict name and its tensor's rank -> the flax path: ``weight``
    is a LayerNorm ``scale`` when 1-D, else a ``kernel``."""
    *parents, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    return (*parents, leaf)


def flax_keystr(name: str, ndim: int) -> str:
    """The flax path as ``jax.tree_util.keystr`` prints it:
    ``"['g_a']['rbs0']['conv1']['dw']['depth']['kernel']"``."""
    return "".join(f"['{p}']" for p in flax_path(name, ndim))


def to_flax(state_dict: dict) -> dict:
    """The inverse of ``from_flax``: state_dict -> nested dict of f32 numpy
    arrays in the flax layout (OIHW -> HWIO, Dense (out, in) -> (in, out)).
    The arrays are copies: ``.numpy()`` of a CPU tensor shares its memory,
    and JAX may take a numpy array without copying, so an in-place update
    of the model would otherwise change the tree, even under a JAX program
    still running on it."""
    tree = {}
    for name, t in state_dict.items():
        a = t.detach().float().cpu().numpy().copy()
        path = flax_path(name, a.ndim)
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def load_checkpoint(path: str) -> dict:
    """Weights from a checkpoint -> state_dict of f32 CPU tensors.  ``path``
    is an orbax directory of the JAX package (its ``params``, e.g.
    ``ckpts/bench_default``), a state_dict file, or a training checkpoint
    of the port (``utils.checkpoint.CheckpointManager``: its ``model``)."""
    if os.path.isdir(path):
        tree = read_orbax(path)
        return from_flax(tree.get("params", tree))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v.float() for k, v in obj.items()}


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
            elif pname == "Gain":
                v = torch.tensor(model.cfg.gain_init, dtype=torch.float32)
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
