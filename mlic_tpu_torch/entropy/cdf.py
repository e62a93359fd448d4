"""Integer CDF table construction for range coding.

The port's own copy of ``mlic_tpu/entropy/cdf.py`` (pure numpy, so its
output is bit-exact with the JAX package's).

Host-side (numpy) equivalent of the C++ ``pmf_to_quantized_cdf`` the
reference reaches through ``net.update(force=True)`` (see reference
``MLIC++/playground/train.py:228-233`` and SURVEY.md §2.9 item 2).  The
semantics are: quantize a float PMF (with an appended tail-mass slot) to an
integer CDF with total 2**precision where every symbol keeps nonzero mass.

Written from scratch; only the *behavioral contract* (nonzero mass, exact
total, deterministic integer arithmetic) is shared with compressai, which is
what makes encoder and decoder agree bit-exactly.
"""

from __future__ import annotations

import numpy as np

PRECISION = 16


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    """Quantize a PMF to an integer CDF summing to ``2**precision``.

    Args:
      pmf: 1-D float array of probabilities (the final entry is conventionally
        the tail/escape mass). Must be finite and non-negative.
      precision: number of bits of the total.

    Returns:
      int32 array of length ``len(pmf) + 1`` with cdf[0] == 0 and
      cdf[-1] == 2**precision, strictly increasing.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    if pmf.ndim != 1:
        raise ValueError("pmf must be 1-D")
    if not np.all(np.isfinite(pmf)) or np.any(pmf < 0):
        raise ValueError("pmf must be finite and non-negative")

    total = 1 << precision
    n = len(pmf)
    if n > total:
        raise ValueError("pmf longer than 2**precision")
    mass = float(pmf.sum())
    p = pmf / mass if mass > 0 else np.full(n, 1.0 / n)

    # Largest-remainder quantization with a floor of 1 per symbol: every
    # symbol keeps mass and the grand total is exact — fully vectorized
    # (the reference's dependency repairs zeros with an O(n^2) steal loop).
    budget = total - n
    exact = p * budget
    freqs = np.floor(exact).astype(np.int64)
    remainder = int(budget - freqs.sum())
    if remainder > 0:
        frac = exact - freqs
        # Deterministic: ties broken by index via stable argsort.
        order = np.argsort(-frac, kind="stable")
        freqs[order[:remainder]] += 1
    freqs += 1  # the floor

    cdf = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(freqs, out=cdf[1:])
    assert cdf[0] == 0 and cdf[-1] == total
    assert np.all(np.diff(cdf) > 0)
    return cdf.astype(np.int32)


def build_cdf_tables(pmfs: np.ndarray, pmf_lengths: np.ndarray, tail_masses: np.ndarray,
                     max_length: int, precision: int = PRECISION):
    """Build padded per-context CDF tables from per-row PMFs.

    Args:
      pmfs: [n, max_length] float array; row i valid up to pmf_lengths[i].
      pmf_lengths: [n] int, number of real symbols per row.
      tail_masses: [n] float, mass assigned to the escape slot.
      max_length: max pmf length (pmfs.shape[1]).

    Returns:
      (quantized_cdfs [n, max_length + 2] int32, cdf_lengths [n] int32)
      where cdf_lengths[i] = pmf_lengths[i] + 2.
    """
    n = pmfs.shape[0]
    out = np.zeros((n, max_length + 2), dtype=np.int32)
    lengths = np.asarray(pmf_lengths, dtype=np.int32) + 2
    for i in range(n):
        L = int(pmf_lengths[i])
        prob = np.concatenate([pmfs[i, :L], [max(float(tail_masses[i]), 0.0)]])
        cdf = pmf_to_quantized_cdf(prob, precision)
        out[i, : L + 2] = cdf
    return out, lengths


def get_scale_table(min_scale: float = 0.11, max_scale: float = 256.0, levels: int = 64) -> np.ndarray:
    """64 log-spaced Gaussian scales (reference ``MLIC++/utils/func.py:16-19``)."""
    return np.exp(np.linspace(np.log(min_scale), np.log(max_scale), levels))
