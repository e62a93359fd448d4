"""Model factory (port of ``mlic_tpu/models/registry.py``)."""

from __future__ import annotations

import dataclasses

from mlic_tpu_torch.models.config import CONFIGS, ModelConfig, model_config
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus
from mlic_tpu_torch.models.vbr import MLICPlusPlusVbr


def get_model(name: str, transform_dtype: str | None = None,
              **overrides) -> MLICPlusPlus:
    """Name -> constructed module with zero parameters (``MLICPlusPlusVbr``
    for the VBR configurations); load weights with ``weights.from_flax``
    or ``weights.init_params``.  ``transform_dtype`` overrides the
    config's (``"bfloat16"`` is the serving setting), and ``overrides``
    any other config field (``train_gain=True``, ``vr_entbttlnck=True``,
    ...)."""
    cfg = model_config(name)
    if transform_dtype is not None:
        overrides["transform_dtype"] = transform_dtype
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return MLICPlusPlusVbr(cfg) if cfg.vbr else MLICPlusPlus(cfg)


__all__ = ["get_model", "model_config", "CONFIGS", "ModelConfig",
           "MLICPlusPlus", "MLICPlusPlusVbr"]
