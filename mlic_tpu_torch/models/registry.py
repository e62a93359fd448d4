"""Model factory (port of ``mlic_tpu/models/registry.py``)."""

from __future__ import annotations

import dataclasses

from mlic_tpu_torch.models.config import CONFIGS, ModelConfig, model_config
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus


def get_model(name: str, transform_dtype: str | None = None) -> MLICPlusPlus:
    """Name -> constructed module with zero parameters; load weights with
    ``weights.from_flax`` or ``weights.init_params``.  ``transform_dtype``
    overrides the config's (``"bfloat16"`` is the serving setting)."""
    cfg = model_config(name)
    if transform_dtype is not None:
        cfg = dataclasses.replace(cfg, transform_dtype=transform_dtype)
    return MLICPlusPlus(cfg)


__all__ = ["get_model", "model_config", "CONFIGS", "ModelConfig",
           "MLICPlusPlus"]
