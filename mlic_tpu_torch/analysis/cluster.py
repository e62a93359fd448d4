"""Dataset clustering by frequency features (port of
``mlic_tpu/analysis/cluster.py``; reference ``analysis/cluster.py``):
k-means over per-image band energies, and a 2-D PCA projection for
inspection.

The features come from ``freq.frequency_features`` on ``device``; the
clustering is numpy.  As in the JAX module, sklearn's ``MiniBatchKMeans``
is taken where it is installed, else the numpy k-means ``_kmeans_np``
(with ``np.random.default_rng(seed)``, so its labels equal the JAX
module's on the same features).
"""

from __future__ import annotations

import numpy as np

from mlic_tpu_torch.analysis.freq import frequency_features


def _kmeans_np(x: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    labels = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for j in range(len(centers)):
            pts = x[labels == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return labels, centers


def cluster_images(images, k: int = 8, num_bands: int = 16, seed: int = 0,
                   device=None) -> dict:
    """Cluster images by their radial frequency-energy profile.  Returns
    labels, cluster centers, a 2-D PCA embedding of the standardized
    features, and the features."""
    feats = frequency_features(images, num_bands, device)
    mu, sigma = feats.mean(0), feats.std(0) + 1e-9
    z = (feats - mu) / sigma
    try:
        from sklearn.cluster import MiniBatchKMeans
        km = MiniBatchKMeans(n_clusters=k, random_state=seed, n_init=3)
        labels = km.fit_predict(z)
        centers = km.cluster_centers_
    except Exception:
        labels, centers = _kmeans_np(z, k, seed=seed)
    zc = z - z.mean(0)
    _, _, vt = np.linalg.svd(zc, full_matrices=False)
    embedding = zc @ vt[:2].T
    return {"labels": np.asarray(labels), "centers": np.asarray(centers),
            "embedding": embedding, "features": feats}
