"""Frequency-domain dataset analysis (port of ``mlic_tpu/analysis/freq.py``;
reference ``analysis/freq_ana.py``): centered FFT magnitude spectra,
spectra resampled onto a unit-frequency grid, and the energy share of
radial frequency bands, per image and over a dataset.

The spectra run through ``torch.fft`` in float64 on ``device`` (the card
unless the caller passes ``"cpu"``).  The per-image functions take a numpy
array or a tensor and return float64 tensors on that device; the dataset
functions return numpy arrays, as the clustering that reads them is numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from mlic_tpu_torch.device import resolve_device

_REC601 = (0.299, 0.587, 0.114)


def _f64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        dev = a.device if device is None else resolve_device(device)
        return a.to(dev, torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                           device=resolve_device(device))


def frequency_energy(image, device=None) -> torch.Tensor:
    """Centered FFT magnitude spectrum of a grayscale image [H,W]."""
    return torch.abs(torch.fft.fftshift(torch.fft.fft2(_f64(image, device))))


def normalized_spectrum(magnitude: torch.Tensor,
                        grid: int = 256) -> torch.Tensor:
    """A magnitude spectrum resampled (nearest) onto a [grid, grid]
    unit-frequency grid ([-0.5, 0.5]^2), so that spectra of images of other
    sizes compare."""
    h, w = magnitude.shape
    t = np.linspace(0, 1, grid)
    yi = np.clip((t * (h - 1)).round().astype(int), 0, h - 1)
    xi = np.clip((t * (w - 1)).round().astype(int), 0, w - 1)
    dev = magnitude.device
    return magnitude[torch.as_tensor(yi, device=dev)[:, None],
                     torch.as_tensor(xi, device=dev)[None, :]]


def band_energies(magnitude: torch.Tensor, num_bands: int = 10
                  ) -> torch.Tensor:
    """Energy share of each radial frequency band (annuli around DC)."""
    h, w = magnitude.shape
    dev = magnitude.device
    yy = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    r = torch.sqrt(((yy - h / 2.0) / h) ** 2 + ((xx - w / 2.0) / w) ** 2)
    edges = torch.linspace(0, float(r.max()) + 1e-9, num_bands + 1,
                           dtype=torch.float64, device=dev)
    power = magnitude.to(torch.float64) ** 2
    total = torch.clamp(power.sum(), min=1e-12)
    return torch.stack([power[(r >= edges[i]) & (r < edges[i + 1])].sum()
                        / total for i in range(num_bands)])


def to_grayscale(img, device=None) -> torch.Tensor:
    """[H,W,3] (or [H,W]) uint8 or float -> float64 grayscale [H,W]
    (Rec.601)."""
    t = _f64(img, device)
    if t.dim() == 2:
        return t
    return t[..., :3] @ torch.tensor(_REC601, dtype=torch.float64,
                                     device=t.device)


def _features(images, num_bands: int, device) -> np.ndarray:
    return np.stack([
        band_energies(frequency_energy(to_grayscale(img, device)),
                      num_bands).cpu().numpy() for img in images])


def dataset_band_profile(images, num_bands: int = 10, device=None) -> dict:
    """Per-image band energies and their dataset mean and std (the
    histogram the reference plots over a training set), numpy."""
    arr = _features(images, num_bands, device)
    return {"per_image": arr, "mean": arr.mean(0), "std": arr.std(0)}


def frequency_features(images, num_bands: int = 16,
                       device=None) -> np.ndarray:
    """Feature matrix [n_images, num_bands] for clustering, numpy."""
    return _features(images, num_bands, device)
