"""Entropy-model pieces the coding path needs (port of
``mlic_tpu/entropy/models.py``): scale-index building, the factorized
prior's parameters and medians, and its host-side CDF tables."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mlic_tpu_torch.entropy.cdf import build_cdf_tables
from mlic_tpu_torch.ops.math import lower_bound


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float = 0.11) -> torch.Tensor:
    """Index of the smallest table entry >= scale, int32 (models.py:49;
    the count of strictly smaller entries among ``scale_table[:-1]``)."""
    scales = lower_bound(scales, scale_bound)
    return torch.searchsorted(scale_table[:-1].contiguous(),
                              scales.contiguous(), right=False).to(torch.int32)


class EntropyBottleneck(nn.Module):
    """Learned factorized prior over z (models.py:104): the per-channel
    monotone-MLP parameters, kept under the flax names.  Coding reads only
    the medians and the tables built from these parameters."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        self.channels, self.filters, self.init_scale = (
            channels, tuple(filters), init_scale)
        f = (1,) + self.filters + (1,)
        for k in range(len(self.filters) + 1):
            self.register_parameter(f"matrix_{k}", nn.Parameter(
                torch.zeros(channels, f[k + 1], f[k])))
            self.register_parameter(f"bias_{k}", nn.Parameter(
                torch.zeros(channels, f[k + 1], 1)))
            if k < len(self.filters):
                self.register_parameter(f"factor_{k}", nn.Parameter(
                    torch.zeros(channels, f[k + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def numpy_params(self) -> dict:
        return {k: v.detach().cpu().numpy()
                for k, v in self.named_parameters()}


def entropy_bottleneck_tables(eb_params: dict,
                              filters: Sequence[int] = (3, 3, 3, 3)):
    """Host-side CDF tables of the factorized prior (models.py:246, qs=1):
    the monotone MLP evaluated in f32 numpy at integer offsets around each
    channel's median, then ``build_cdf_tables``.  Pure numpy, so the tables
    are bit-exact with the JAX package's for the same parameters.

    Returns (quantized_cdf [C, max+2] int32, cdf_length [C], offset [C],
    medians [C] f32)."""
    quantiles = np.asarray(eb_params["quantiles"], np.float32)
    medians = quantiles[:, 0, 1]
    minima = np.maximum(
        np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64), 0)
    maxima = np.maximum(
        np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64), 0)
    pmf_lengths = minima + maxima + 1
    max_length = int(pmf_lengths.max())
    samples = ((np.arange(max_length)[None, :] - minima[:, None])
               + medians[:, None]).astype(np.float32)[:, None, :]
    n_layers = len(filters) + 1

    def logits_np(x):
        x = x.astype(np.float32)
        for k in range(n_layers):
            m = np.logaddexp(0.0, np.asarray(eb_params[f"matrix_{k}"],
                                             np.float32))
            x = np.einsum("coi,cil->col", m, x) + np.asarray(
                eb_params[f"bias_{k}"], np.float32)
            if k < n_layers - 1:
                fac = np.asarray(eb_params[f"factor_{k}"], np.float32)
                x = x + np.tanh(fac) * np.tanh(x)
        return x

    def sigmoid(v):
        return 0.5 * (1.0 + np.tanh(0.5 * v))

    lower = sigmoid(logits_np(samples - 0.5))[:, 0, :]
    upper = sigmoid(logits_np(samples + 0.5))[:, 0, :]
    pmfs = upper - lower
    rows = np.arange(len(medians))
    tail = lower[rows, 0] + (1.0 - upper[rows, pmf_lengths - 1])
    cdfs, lengths = build_cdf_tables(pmfs, pmf_lengths, tail, max_length)
    return cdfs, lengths, (-minima).astype(np.int32), medians.astype(np.float32)
