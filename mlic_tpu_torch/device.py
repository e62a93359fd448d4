"""Device resolution and the determinism settings of the f32 entropy path."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises instead of falling back to the CPU: a
    caller that wants the CPU path asks for it (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the CPU")
        configure_determinism()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def configure_determinism() -> None:
    """Encode and decode must compute bit-identical entropy parameters
    (h_s, the context stack, EntropyParameters and LRP stay f32): full-f32
    convolutions and matmuls (no TF32) and fixed cuDNN algorithms, so both
    directions pick the same kernels for the same shapes.  The coding path
    uses no atomics-based op (``index_add_``, ``scatter_add_``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
