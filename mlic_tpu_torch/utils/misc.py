"""Small utilities (the port's own copy of ``mlic_tpu/utils/misc.py``;
reference ``utils/utils.py`` and ``utils/func.py``): an attribute dict
config, running averages, patch reshapes, the hardware banner, aligned
metric tables."""

from __future__ import annotations

import json
import platform
from typing import Any



class Config(dict):
    """Attribute-style dict with JSON load and save (reference
    ``utils.py:17-25``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(json.load(f))

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self, f, indent=2, default=str)


class AverageMeter:
    """Running average (reference ``utils.py:90-103``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _permute(x, axes):
    """``x`` with its axes in the order ``axes``: a numpy array or a torch
    tensor."""
    return x.permute(axes) if hasattr(x, "permute") else x.transpose(axes)


def image_to_patches(x, patch: int):
    """[B,H,W,C] -> [B*nh*nw, p, p, C] (reference ``func.py:122-130``), a
    numpy array or a torch tensor (POELIC's style term)."""
    b, h, w, c = x.shape
    nh, nw = h // patch, w // patch
    x = x[:, :nh * patch, :nw * patch]
    return _permute(x.reshape(b, nh, patch, nw, patch, c),
                    (0, 1, 3, 2, 4, 5)).reshape(b * nh * nw, patch, patch, c)


def patches_to_image(p, grid_hw: tuple[int, int]):
    """Inverse of ``image_to_patches`` (reference ``func.py:132-138``)."""
    nh, nw = grid_hw
    n, ph, pw, c = p.shape
    b = n // (nh * nw)
    return _permute(p.reshape(b, nh, nw, ph, pw, c),
                    (0, 1, 3, 2, 4, 5)).reshape(b, nh * ph, nw * pw, c)


def get_system_info_str() -> str:
    """Hardware and runtime banner (reference ``utils.py:138-212``): the
    platform, Python, PyTorch and its CUDA, each visible CUDA device by
    name, the process count of the process group, the host memory."""
    import torch

    from mlic_tpu_torch.parallel.mesh import process_count
    lines = [
        f"platform : {platform.platform()}",
        f"python   : {platform.python_version()}",
        f"torch    : {torch.__version__} (CUDA {torch.version.cuda})",
    ]
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        lines.append(f"devices  : {names}")
    else:
        lines.append("devices  : ['cpu'] (CUDA is not available)")
    lines.append(f"processes: {process_count()}")
    try:
        with open("/proc/meminfo") as f:
            total_kb = int(f.readline().split()[1])
        lines.append(f"host mem : {total_kb / 1e6:.1f} GB")
    except OSError:
        pass
    return "\n".join(lines)


def pretty_print_dict(metrics: dict[str, Any], precision: int = 4) -> str:
    """Aligned key/value table (reference ``utils.py:235-238``)."""
    keys = [str(k) for k in metrics]
    width = max((len(k) for k in keys), default=0)
    rows = []
    for k, v in metrics.items():
        if isinstance(v, float):
            v = f"{v:.{precision}f}"
        rows.append(f"{str(k):<{width}} : {v}")
    return "\n".join(rows)
