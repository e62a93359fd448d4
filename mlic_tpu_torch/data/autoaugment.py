"""AutoAugment, the ImageNet policy, on numpy/PIL images: the port's own
copy of ``mlic_tpu/data/autoaugment.py``.

The reference's training transform starts with torchvision's
``transforms.AutoAugment()`` (``MLIC++/playground/train.py:82``).
torchvision is not installed, so this is a PIL implementation of the
published ImageNet policy (Cubuk et al., "AutoAugment", CVPR 2019): 25
sub-policies, each a pair of (op, probability, magnitude bin) applied in
sequence; the magnitude bins follow torchvision's augmentation space (10
bins; a signed op flips its sign with probability 1/2).  Every draw comes
from the caller's numpy generator in the JAX package's order, so a seed
gives its images byte for byte.

Host-side only: it runs in the data loader's thread.
"""

from __future__ import annotations

import numpy as np

# (op, probability, magnitude bin 0-9 or None)
IMAGENET_POLICY = (
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
)

_BINS = 10
_SIGNED = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
           "Brightness", "Color", "Contrast", "Sharpness"}


def _magnitude(op: str, bin_idx: int, size: tuple) -> float:
    """The magnitude of ``op`` at ``bin_idx`` for a PIL image of ``size``
    (width, height)."""
    if op in ("ShearX", "ShearY"):
        return float(np.linspace(0.0, 0.3, _BINS)[bin_idx])
    if op in ("TranslateX", "TranslateY"):
        extent = size[0] if op == "TranslateX" else size[1]
        return float(np.linspace(0.0, 150.0 / 331.0 * extent, _BINS)[bin_idx])
    if op == "Rotate":
        return float(np.linspace(0.0, 30.0, _BINS)[bin_idx])
    if op in ("Brightness", "Color", "Contrast", "Sharpness"):
        return float(np.linspace(0.0, 0.9, _BINS)[bin_idx])
    if op == "Posterize":
        return int(8 - round(bin_idx / ((_BINS - 1) / 4)))
    if op == "Solarize":
        return float(np.linspace(255.0, 0.0, _BINS)[bin_idx])
    return 0.0


def _apply_op(im, op: str, mag: float):
    """One op of the policy on a PIL image."""
    from PIL import Image, ImageEnhance, ImageOps
    if op == "ShearX":
        return im.transform(im.size, Image.AFFINE, (1, mag, 0, 0, 1, 0),
                            Image.BILINEAR)
    if op == "ShearY":
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, mag, 1, 0),
                            Image.BILINEAR)
    if op == "TranslateX":
        return im.transform(im.size, Image.AFFINE, (1, 0, mag, 0, 1, 0),
                            Image.BILINEAR)
    if op == "TranslateY":
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, mag),
                            Image.BILINEAR)
    if op == "Rotate":
        return im.rotate(mag, Image.BILINEAR)
    if op == "Brightness":
        return ImageEnhance.Brightness(im).enhance(1.0 + mag)
    if op == "Color":
        return ImageEnhance.Color(im).enhance(1.0 + mag)
    if op == "Contrast":
        return ImageEnhance.Contrast(im).enhance(1.0 + mag)
    if op == "Sharpness":
        return ImageEnhance.Sharpness(im).enhance(1.0 + mag)
    if op == "Posterize":
        return ImageOps.posterize(im, int(mag))
    if op == "Solarize":
        return ImageOps.solarize(im, mag)
    if op == "AutoContrast":
        return ImageOps.autocontrast(im)
    if op == "Equalize":
        return ImageOps.equalize(im)
    if op == "Invert":
        return ImageOps.invert(im)
    raise ValueError(f"unknown op {op!r}")


def autoaugment(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One sub-policy drawn from ``rng``, applied to a uint8 [H, W, 3]."""
    from PIL import Image
    sub = IMAGENET_POLICY[int(rng.integers(0, len(IMAGENET_POLICY)))]
    im = Image.fromarray(img)
    for op, prob, bin_idx in sub:
        if rng.random() > prob:
            continue
        mag = _magnitude(op, bin_idx, im.size) if bin_idx is not None else 0.0
        if op in _SIGNED and rng.random() < 0.5:
            mag = -mag
        im = _apply_op(im, op, mag)
    return np.asarray(im)
