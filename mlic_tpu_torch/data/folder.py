"""Image input for evaluation: the port's own copy of what
``mlic_tpu/data/folder.py`` offers for it (numpy and, inside ``load_image``,
PIL): recursive image discovery, decoding to uint8, and the procedural
dead-leaves pool used where no dataset is mounted.  The training pipeline
(random crops, prefetching batches) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(root: str) -> list[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in _EXTS:
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def load_image(path: str) -> np.ndarray:
    """uint8 [H,W,3]."""
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True  # tolerate corrupt files (train.py:48)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def dead_leaves_pool(n_images: int, size: int, seed: int = 0,
                     n_disks: int = 180,
                     cache_dir: str | None = None,
                     width: int | None = None) -> np.ndarray:
    """Procedural 'dead leaves' image pool: occluding random disks with a
    power-law radius distribution — the classic natural-image surrogate
    (scale-invariant statistics, sharp occlusion edges), far harder to
    code than smooth gradients.  Used when no dataset is mounted so RD
    curves reflect a nontrivial source.  Returns uint8 [n, size, width, 3]
    (``width`` defaults to ``size`` for square frames; pass e.g.
    ``size=512, width=768`` for non-tiled Kodak-shaped bench frames).
    """
    if width is None:
        width = size
    if cache_dir is None:
        # Under the home directory, so that a large pool is rendered once.
        cache_dir = os.environ.get(
            "MLIC_POOL_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "mlic_pool_cache"))
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        wtag = "" if width == size else f"_w{width}"
        cache = os.path.join(
            cache_dir, f"dl_{n_images}_{size}{wtag}_{seed}_{n_disks}.npz")
        if os.path.exists(cache):
            return np.load(cache)["pool"]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:width].astype(np.float32)
    pool = np.empty((n_images, size, width, 3), np.uint8)
    r_min, r_max = max(min(size, width) / 64.0, 2.0), min(size, width) / 2.0
    for i in range(n_images):
        img = np.tile(rng.random(3, dtype=np.float32)[None, None], (size, width, 1))
        # Inverse-cube radius law ~ scale-invariant leaf sizes.
        u = rng.random(n_disks, dtype=np.float32)
        radii = r_min / np.power(1.0 - u * (1.0 - (r_min / r_max) ** 2), 0.5)
        cx = rng.random(n_disks, dtype=np.float32) * width
        cy = rng.random(n_disks, dtype=np.float32) * size
        colors = rng.random((n_disks, 3), dtype=np.float32)
        # Mild per-disk texture keeps high-frequency content.
        tex_amp = rng.random(n_disks, dtype=np.float32) * 0.1
        for d in range(n_disks):
            mask = (xx - cx[d]) ** 2 + (yy - cy[d]) ** 2 <= radii[d] ** 2
            if not mask.any():
                continue
            tex = tex_amp[d] * np.sin(
                0.5 * (xx[mask] * np.float32(rng.random() * 0.3)
                       + yy[mask] * np.float32(rng.random() * 0.3)))
            img[mask] = np.clip(colors[d][None] + tex[:, None], 0.0, 1.0)
        noise = rng.normal(0.0, 0.01, img.shape).astype(np.float32)
        pool[i] = np.clip((img + noise) * 255.0, 0, 255).astype(np.uint8)
    if cache:
        np.savez_compressed(cache + ".tmp.npz", pool=pool)
        os.replace(cache + ".tmp.npz", cache)
    return pool
