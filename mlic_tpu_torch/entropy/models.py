"""Entropy models (port of ``mlic_tpu/entropy/models.py``): the Gaussian
likelihood and scale-index building of the conditional model, and the
factorized prior over z (``EntropyBottleneck``) with its training half --
likelihoods under uniform noise or rounding, STE quantization, the
auxiliary quantile loss -- and its host-side CDF tables; the
variable-rate prior (``EntropyBottleneckVbr``) quantizes z with a step
``qs`` and its tables integrate each slot over +-qs/2; the conditional
Gaussian's host tables (``GaussianConditionalTables``) feed the host rANS
coder of the ``steps`` and ``fused`` codec backends."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.entropy.cdf import build_cdf_tables, get_scale_table
from mlic_tpu_torch.ops.math import lower_bound, quantize_ste

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9


def std_gaussian_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erfc (stable in both tails)."""
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def gaussian_likelihood(y: torch.Tensor, scales: torch.Tensor,
                        means: torch.Tensor,
                        scale_bound: float = 0.11) -> torch.Tensor:
    """P(round(y) | N(means, scales^2)) with the +-1/2 integration window
    (models.py:39)."""
    scales = lower_bound(scales, scale_bound)
    values = torch.abs(y - means)
    upper = std_gaussian_cdf((0.5 - values) / scales)
    lower = std_gaussian_cdf((-0.5 - values) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float = 0.11) -> torch.Tensor:
    """Index of the smallest table entry >= scale, int32 (models.py:49;
    the count of strictly smaller entries among ``scale_table[:-1]``)."""
    scales = lower_bound(scales, scale_bound)
    return torch.searchsorted(scale_table[:-1].contiguous(),
                              scales.contiguous(), right=False).to(torch.int32)


@dataclasses.dataclass
class GaussianConditionalTables:
    """Host-side integer CDF tables of the conditional Gaussian, one row a
    scale of the table (models.py:61): each row codes the integers within
    ``ceil(scale * multiplier)`` of the mean, where P(|X| > width) <=
    ``tail_mass``, with the tail in the escape slot.  numpy and scipy in
    float64 on ``build_cdf_tables``: bit-exact with the JAX package's."""

    scale_table: np.ndarray
    quantized_cdf: np.ndarray  # [n_scales, max_len + 2] int32
    cdf_length: np.ndarray     # [n_scales] int32
    offset: np.ndarray         # [n_scales] int32

    @classmethod
    def create(cls, scale_table: np.ndarray | None = None,
               tail_mass: float = TAIL_MASS) -> "GaussianConditionalTables":
        from scipy import stats
        if scale_table is None:
            scale_table = get_scale_table()
        scale_table = np.asarray(scale_table, dtype=np.float64)
        multiplier = -stats.norm.ppf(tail_mass / 2)
        centers = np.ceil(scale_table * multiplier).astype(np.int64)
        pmf_lengths = 2 * centers + 1
        max_length = int(pmf_lengths.max())
        samples = np.abs(np.arange(max_length)[None, :] - centers[:, None])
        upper = stats.norm.cdf((0.5 - samples) / scale_table[:, None])
        lower = stats.norm.cdf((-0.5 - samples) / scale_table[:, None])
        cdfs, lengths = build_cdf_tables(upper - lower, pmf_lengths,
                                         2 * lower[:, 0], max_length)
        return cls(scale_table=scale_table.astype(np.float32),
                   quantized_cdf=cdfs, cdf_length=lengths,
                   offset=(-centers).astype(np.int32))


class EntropyBottleneck(nn.Module):
    """Learned factorized prior over z (models.py:104): a per-channel
    monotone MLP CDF, kept under the flax names.  ``quantiles`` track the
    (tail, median, 1 - tail) points and learn from the auxiliary loss
    only.  Coding reads the medians and the tables built from these
    parameters; training reads ``forward``, ``ste_quantize`` and
    ``aux_loss``."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = TAIL_MASS):
        super().__init__()
        self.channels, self.filters, self.init_scale = (
            channels, tuple(filters), init_scale)
        self.tail_mass = tail_mass
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

    def _logits_cumulative(self, x: torch.Tensor,
                           stop_gradient: bool) -> torch.Tensor:
        """x: [C, 1, L] -> logits [C, 1, L] (models.py:153); with
        ``stop_gradient`` no gradient reaches the density parameters."""
        n_layers = len(self.filters) + 1
        for k in range(n_layers):
            m, b = getattr(self, f"matrix_{k}"), getattr(self, f"bias_{k}")
            if stop_gradient:
                m, b = m.detach(), b.detach()
            x = torch.matmul(F.softplus(m), x) + b
            if k < n_layers - 1:
                fac = getattr(self, f"factor_{k}")
                if stop_gradient:
                    fac = fac.detach()
                x = x + torch.tanh(fac) * torch.tanh(x)
        return x

    def _likelihood(self, v: torch.Tensor) -> torch.Tensor:
        """v: [C, L] channel-major values -> likelihoods [C, L]
        (models.py:167)."""
        lower = self._logits_cumulative(v[:, None, :] - 0.5, False)
        upper = self._logits_cumulative(v[:, None, :] + 0.5, False)
        sign = -torch.sign(lower + upper).detach()
        lk = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lk[:, 0, :]

    def forward(self, z: torch.Tensor, training: bool = True,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """z: [B, C, H, W] -> (z_tilde, likelihoods), both [B, C, H, W]
        (models.py:178).  Training adds uniform noise in [-1/2, 1/2) laid
        out ``[C, B*H*W]`` with (b, h, w) raveled as in the NHWC latent --
        the layout of the JAX package's draw; ``noise`` gives it, else it
        is drawn from ``generator``.  Evaluation rounds around the
        medians."""
        b, c, h, w = z.shape
        zc = z.permute(1, 0, 2, 3).reshape(c, b * h * w)
        if training:
            if noise is None:
                noise = torch.rand(zc.shape, generator=generator,
                                   device=zc.device, dtype=zc.dtype) - 0.5
            v = zc + noise
        else:
            medians = self.medians()[:, None]
            v = torch.round(zc - medians) + medians
        lk = lower_bound(self._likelihood(v), LIKELIHOOD_BOUND)

        def nchw(t):
            return t.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return nchw(v), nchw(lk)

    def ste_quantize(self, z: torch.Tensor) -> torch.Tensor:
        """STE round to the medians (models.py:194); z is NCHW."""
        medians = self.medians()[None, :, None, None]
        return quantize_ste(z - medians) + medians

    def aux_loss(self) -> torch.Tensor:
        """Pulls the quantiles to (tail/2, 1/2, 1 - tail/2) of the CDF
        (models.py:200); the density parameters are detached."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2.0 / self.tail_mass - 1.0)
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype,
                              device=logits.device).reshape(1, 1, 3)
        return torch.sum(torch.abs(logits - target))

    def numpy_params(self) -> dict:
        return {k: v.detach().cpu().numpy()
                for k, v in self.named_parameters()}


class EntropyBottleneckVbr(EntropyBottleneck):
    """The factorized prior with a variable quantization step ``qs``
    (models.py:208): z lives on the grid ``median + k*qs`` and its
    likelihood integrates the density over +-qs/2.  Without ``qs`` it is
    the plain bottleneck."""

    def quantize_variable(self, z: torch.Tensor, qs) -> torch.Tensor:
        """STE round to the qs grid around the medians; z is NCHW."""
        medians = self.medians()[None, :, None, None]
        return quantize_ste((z - medians) / qs) * qs + medians

    def forward(self, z: torch.Tensor, training: bool = True,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None, qs=None):
        """As ``EntropyBottleneck.forward``, with the noise (``noise``, the
        same [C, B*H*W] layout, or drawn from ``generator``) scaled by
        ``qs`` in training and rounding on the qs grid in evaluation."""
        if qs is None:
            return super().forward(z, training, noise, generator)
        b, c, h, w = z.shape
        zc = z.permute(1, 0, 2, 3).reshape(c, b * h * w)
        if training:
            if noise is None:
                noise = torch.rand(zc.shape, generator=generator,
                                   device=zc.device, dtype=zc.dtype) - 0.5
            v = zc + noise * qs
        else:
            medians = self.medians()[:, None]
            v = torch.round((zc - medians) / qs) * qs + medians
        half = qs / 2.0
        lower = self._logits_cumulative(v[:, None, :] - half, False)
        upper = self._logits_cumulative(v[:, None, :] + half, False)
        sign = -torch.sign(lower + upper).detach()
        lk = torch.abs(torch.sigmoid(sign * upper)
                       - torch.sigmoid(sign * lower))[:, 0, :]
        lk = lower_bound(lk, LIKELIHOOD_BOUND)

        def nchw(t):
            return t.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return nchw(v), nchw(lk)


def entropy_bottleneck_tables(eb_params: dict,
                              filters: Sequence[int] = (3, 3, 3, 3),
                              qs: float = 1.0):
    """Host-side CDF tables of the factorized prior (models.py:246): the
    monotone MLP evaluated in f32 numpy on the grid ``median + k*qs``, each
    slot integrating the density over +-qs/2, then ``build_cdf_tables``.
    Pure numpy with the JAX package's arithmetic, so the tables are
    bit-exact with its tables for the same parameters and ``qs``.

    Returns (quantized_cdf [C, max+2] int32, cdf_length [C], offset [C],
    medians [C] f32)."""
    qs = float(qs)
    quantiles = np.asarray(eb_params["quantiles"], np.float32)
    medians = quantiles[:, 0, 1]
    minima = np.maximum(
        np.ceil((medians - quantiles[:, 0, 0]) / qs).astype(np.int64), 0)
    maxima = np.maximum(
        np.ceil((quantiles[:, 0, 2] - medians) / qs).astype(np.int64), 0)
    pmf_lengths = minima + maxima + 1
    max_length = int(pmf_lengths.max())
    samples = ((np.arange(max_length)[None, :] - minima[:, None]) * qs
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

    lower = sigmoid(logits_np(samples - 0.5 * qs))[:, 0, :]
    upper = sigmoid(logits_np(samples + 0.5 * qs))[:, 0, :]
    pmfs = upper - lower
    rows = np.arange(len(medians))
    tail = lower[rows, 0] + (1.0 - upper[rows, pmf_lengths - 1])
    cdfs, lengths = build_cdf_tables(pmfs, pmf_lengths, tail, max_length)
    return cdfs, lengths, (-minima).astype(np.int32), medians.astype(np.float32)
