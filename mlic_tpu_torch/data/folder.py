"""Image input for training and evaluation: the port's own copy of
``mlic_tpu/data/folder.py`` (numpy, and PIL inside the functions that
decode or resize): recursive image discovery, decoding to uint8, random
resize and crop, a folder dataset with a threaded prefetch, the procedural
dead-leaves pool used where no dataset is mounted, and the batch streams
over a pool or of synthetic waves.  Every random draw is the JAX package's,
from the same numpy streams, so the batches are byte-identical.  The
``autoaugment`` option waits for the port of ``data/autoaugment.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

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


def random_resize_crop(img: np.ndarray, patch: int, rng: np.random.Generator,
                       resize_logrange: float = 0.0) -> np.ndarray:
    """Optional log-uniform area rescale (reference ``RandomResize``,
    dataset.py:92-117 uses s in e^[-3.2, 3.2]), then a random crop to
    ``patch`` and a random horizontal flip."""
    h, w = img.shape[:2]
    if resize_logrange > 0:
        from PIL import Image
        s = float(np.exp(rng.uniform(-resize_logrange, resize_logrange))) ** 0.5
        # never shrink below the crop size
        s = max(s, (patch + 1) / min(h, w))
        nh, nw = max(int(h * s), patch), max(int(w * s), patch)
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        h, w = nh, nw
    if h < patch or w < patch:
        ph, pw = max(patch - h, 0), max(patch - w, 0)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - patch + 1))
    left = int(rng.integers(0, w - patch + 1))
    out = img[top:top + patch, left:left + patch]
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return out


class ImageFolderDataset:
    """Random crops of the images under a folder (reference ``ImageFolder2``,
    dataset.py:42-117); process ``process_index`` of ``process_count``
    reads its own share of the file list."""

    def __init__(self, root: str, patch_size: int = 256,
                 resize_logrange: float = 0.0,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0):
        self.files = list_images(root)[process_index::process_count]
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.patch = patch_size
        self.resize_logrange = resize_logrange
        self.rng = np.random.default_rng(seed + process_index)

    def __len__(self):
        return len(self.files)

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """[B, patch, patch, 3] float32 in [0,1]."""
        idx = self.rng.integers(0, len(self.files), size=batch_size)
        out = np.empty((batch_size, self.patch, self.patch, 3), np.float32)
        for i, j in enumerate(idx):
            img = load_image(self.files[int(j)])
            out[i] = random_resize_crop(img, self.patch, self.rng,
                                        self.resize_logrange
                                        ).astype(np.float32) / 255.0
        return out

    def batches(self, batch_size: int, steps: int,
                prefetch: int = 2) -> Iterator[np.ndarray]:
        """``steps`` batches, decoded by a thread ``prefetch`` batches
        ahead."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            for _ in range(steps):
                if stop.is_set():
                    return
                q.put(self.sample_batch(batch_size))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


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


def pool_batches(pool: np.ndarray, batch_size: int, patch: int, steps: int,
                 seed: int = 0, as_float: bool = False) -> Iterator[np.ndarray]:
    """Random-crop, random-hflip batches from an in-memory uint8 pool (the
    synthetic stand-in for ``ImageFolderDataset``).  uint8 by default (a
    quarter of the bytes to the device; the trainer normalizes there); the
    random stream is the same either way."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = pool.shape
    dt = np.float32 if as_float else np.uint8
    for _ in range(steps):
        idx = rng.integers(0, n, size=batch_size)
        ys = rng.integers(0, max(h - patch, 0) + 1, size=batch_size)
        xs = rng.integers(0, max(w - patch, 0) + 1, size=batch_size)
        flip = rng.random(batch_size) < 0.5
        out = np.empty((batch_size, patch, patch, 3), dt)
        for b in range(batch_size):
            crop = pool[idx[b], ys[b]:ys[b] + patch, xs[b]:xs[b] + patch]
            if flip[b]:
                crop = crop[:, ::-1]
            out[b] = crop.astype(np.float32) / 255.0 if as_float else crop
        yield out


def synthetic_batches(batch_size: int, patch: int, steps: int,
                      seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic synthetic image stream (smooth waves and noise) for
    tests and runs without a dataset on disk."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:patch, 0:patch].astype(np.float32) / patch
    for _ in range(steps):
        base = np.stack([yy, xx, (yy + xx) / 2], axis=-1)[None]
        phase = rng.random((batch_size, 1, 1, 3)).astype(np.float32)
        freq = rng.integers(1, 6, size=(batch_size, 1, 1, 3)).astype(np.float32)
        img = 0.5 + 0.35 * np.sin(2 * np.pi * (freq * base + phase))
        img += rng.normal(0, 0.02, img.shape).astype(np.float32)
        yield np.clip(img, 0.0, 1.0).astype(np.float32)
