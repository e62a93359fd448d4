"""Variable-bitrate MLIC++ (port of ``mlic_tpu/models/vbr.py``; reference
``MLIC++/models/mlicpp_vbr.py``).

On top of the base model:

* ``Gain``, the learned inverse quantization step of each rate level,
  initialised to ``cfg.gain_init``; a level codes y as
  ``round((y - mu) * Gain[s])`` and looks its rows up at ``sigma *
  Gain[s]``, and ``inputscale > 0`` replaces the gain with a continuous
  one;
* QuantABCD ``qabcd_0..2``, a 2-12-12-1 MLP from (bounded sigma, gain) to
  a reconstruction offset, used where ``cfg.quant_offset`` (the fork keeps
  it off);
* with ``cfg.vr_entbttlnck``, the variable-step bottleneck
  (``EntropyBottleneckVbr``) and ``zqstep_0..2``, a 1-10-10-1 MLP from the
  inverse gain to z's quantization step, softplus, bounded below by 0.5;
* the stage-2 training forward with gain-scaled STE rounding and
  likelihoods of the scaled triple (y, sigma, mu) * gain.

The level is a python int: the eager port needs no traced index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.entropy.models import (
    EntropyBottleneck,
    EntropyBottleneckVbr,
)
from mlic_tpu_torch.models.config import ModelConfig
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus
from mlic_tpu_torch.ops.math import lower_bound, quantize_ste


class MLICPlusPlusVbr(MLICPlusPlus):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.Gain = nn.Parameter(torch.tensor(cfg.gain_init,
                                              dtype=torch.float32))
        for i, (n_in, n_out) in enumerate(((2, 12), (12, 12), (12, 1))):
            self.add_module(f"qabcd_{i}", nn.Linear(n_in, n_out))
        if cfg.vr_entbttlnck:
            for i, (n_in, n_out) in enumerate(((1, 10), (10, 10), (10, 1))):
                self.add_module(f"zqstep_{i}", nn.Linear(n_in, n_out))

    def _make_entropy_bottleneck(self, channels: int) -> nn.Module:
        if self.cfg.vr_entbttlnck:
            return EntropyBottleneckVbr(channels)
        return EntropyBottleneck(channels)

    def quant_offset(self, stdev: torch.Tensor, scale) -> torch.Tensor:
        """QuantABCD: (bounded sigma * gain, gain) -> offset, elementwise."""
        inp = torch.stack([stdev, torch.as_tensor(
            scale, dtype=stdev.dtype, device=stdev.device).expand_as(stdev)],
            -1)
        h = F.relu(self.qabcd_0(inp))
        h = F.relu(self.qabcd_1(h))
        return self.qabcd_2(h)[..., 0]

    def _zqstep(self, scale) -> torch.Tensor:
        """z's quantization step from the gain (vbr.py:68):
        lower_bound(softplus(MLP(1 / gain)), 0.5), a 0-d tensor."""
        inp = torch.reshape(1.0 / scale, (1, 1))
        h = F.relu(self.zqstep_0(inp))
        h = F.relu(self.zqstep_1(h))
        return lower_bound(F.softplus(self.zqstep_2(h))[0, 0], 0.5)

    def _gain(self, s) -> torch.Tensor:
        """``abs(Gain[s])`` at the level clipped to the table, 0-d."""
        s = min(max(int(s), 0), len(self.cfg.gain_init) - 1)
        return self.Gain[s].abs()

    def _scale(self, s, inputscale=None) -> torch.Tensor:
        """The training forward's gain (vbr.py:100): detached unless
        ``cfg.train_gain`` (the reference detaches it); ``inputscale > 0``
        overrides it."""
        scale = self._gain(s)
        if not self.cfg.train_gain:
            scale = scale.detach()
        if inputscale is not None:
            isc = torch.full_like(scale, float(inputscale))
            scale = torch.where(isc > 0, isc, scale)
        return scale

    def gain_scale(self, s=0, inputscale=0.0) -> torch.Tensor:
        """Coding-time gain (vbr.py:212): ``abs(Gain[s])``, or
        ``inputscale`` where it is > 0; a 0-d f32 tensor on the model's
        device, made there with no host synchronization."""
        scale = self._gain(s).detach()
        isc = torch.full_like(scale, float(inputscale))
        return torch.where(isc > 0, isc, scale)

    def z_step(self, s=0, inputscale=0.0):
        """Coding-time z step: 1.0 without ``vr_entbttlnck``, else the
        zqstep MLP at the level's gain (a 0-d tensor)."""
        if not self.cfg.vr_entbttlnck:
            return 1.0
        return self._zqstep(self.gain_scale(s, inputscale))

    def _phase_recon(self, symbols, mu_sq, sc_sq, scale):
        """With ``cfg.quant_offset``, QuantABCD's dead-zone reconstruction
        (vbr.py:85): ``sign * (|sym| + offset) / scale + mu``, the offset
        zero where the symbol is 0; encode and decode compute it from
        identical (symbols, mu, sigma, scale)."""
        if not self.cfg.quant_offset:
            return super()._phase_recon(symbols, mu_sq, sc_sq, scale)
        sym = symbols.float()
        q_stdev = lower_bound(sc_sq * scale, 0.11)
        offs = -self.quant_offset(q_stdev, scale)
        off = torch.where(torch.abs(sym) < 1e-4, 0.0, offs)
        return torch.sign(sym) * (torch.abs(sym) + off) * (1.0 / scale) \
            + mu_sq

    def forward(self, x, training: bool = True, noise=None, generator=None,
                stage: int = 2, s=1, inputscale=None, quant_offset=None):
        """Stage 1 is the base model's forward.  Stage 2 (vbr.py:115)
        trains level ``s`` (or the continuous ``inputscale``): y rounded as
        ``round((y - mu) * gain) / gain + mu`` with a straight-through
        gradient (with QuantABCD's offset under ``quant_offset``, default
        ``cfg.quant_offset``), y's likelihoods of the scaled triple, and
        under ``vr_entbttlnck`` z on the zqstep grid, its noise (``noise``
        or ``generator``'s draw, in [-1/2, 1/2)) scaled by the step."""
        if stage == 1:
            return super().forward(x, training, noise, generator)
        if quant_offset is None:
            quant_offset = self.cfg.quant_offset
        scale = self._scale(s, inputscale)
        rescale = 1.0 / scale
        z_qs = self._zqstep(scale) if self.cfg.vr_entbttlnck else None

        if quant_offset:
            def make_round(scales):
                offs = -self.quant_offset(lower_bound(scales * scale, 0.11),
                                          scale)

                def vbr_round(v, means):
                    zm = (v - means) * scale
                    q_abs = torch.abs(quantize_ste(zm))
                    off = torch.where(q_abs < 1e-4, 0.0, offs)
                    return torch.sign(zm) * (q_abs + off) * rescale + means
                return vbr_round
        else:
            def make_round(scales):
                def vbr_round(v, means):
                    return quantize_ste((v - means) * scale) * rescale + means
                return vbr_round

        return self._forward(x, training, noise, generator, scale, z_qs,
                             make_round)

    def mmo_parameters(self) -> dict:
        """The multi-objective trainer's groups (vbr.py:216): ``Gain``
        trains per level, everything else is shared."""
        return {"gain": ["Gain"], "shared": "rest"}
