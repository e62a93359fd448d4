"""Evaluation harness: padded full-image coding through real files, metrics
(port of ``mlic_tpu/eval.py``).

* pad to a multiple of 64 before coding, crop after;
* ``compress_one_image`` writes the header (H, W) -- (H, W, level, f32 bits
  of ``inputscale``) for a variable-rate level -- and the body, and reports
  the file's bpp; ``decompress_one_image`` reads it back;
* ``evaluate_codec`` drives both over a set of images, requires the
  decoder's reconstruction to equal the encoder's bit for bit, and averages
  bpp, PSNR, MS-SSIM and the two wall-clock times; ``evaluate_codec_vbr``
  does so at each gain level.

Images are numpy arrays ``[B,H,W,3]`` (or ``[H,W,3]``), float in [0, 1];
the codec decides the device, and the metrics are computed there.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.metrics import ms_ssim, psnr
from mlic_tpu_torch.utils import bitstream


def pad_to_multiple(x: np.ndarray, mult: int = 64):
    """Replication-pad [B,H,W,C] so H,W are multiples of ``mult``."""
    h, w = x.shape[1], x.shape[2]
    ph = (mult - h % mult) % mult
    pw = (mult - w % mult) % mult
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    return x, (h, w)


def crop_to(x, hw):
    return x[:, :hw[0], :hw[1], :]


def compress_one_image(codec: Codec, x: np.ndarray, path: str,
                       s: Optional[int] = None,
                       inputscale: float = 0.0) -> dict:
    """Pad, compress, write the container file; returns bpp, the encode
    time and the cropped encode-side reconstruction.  Per image (B = 1).
    With a level ``s`` the header carries it and ``inputscale``'s f32 bits,
    so the decoder codes at the encoder's gain; without one the codec codes
    at its default level and ``inputscale`` must stay 0."""
    padded, (h, w) = pad_to_multiple(np.asarray(x))
    if padded.shape[0] != 1:
        raise ValueError("compress_one_image is per-image (B=1); "
                         "loop over the batch for batched coding")
    if s is None:
        if inputscale:
            raise ValueError("inputscale needs a level s: only a VBR "
                             "header records it")
        out = codec.compress(padded)
    else:
        out = codec.compress(padded, s=s, inputscale=inputscale)
    with open(path, "wb") as f:
        if s is None:
            bitstream.write_uints(f, (h, w))
        else:
            bits = int(np.float32(inputscale).view(np.uint32))
            bitstream.write_uints(f, (h, w, s, bits))
        bitstream.write_body(f, out["shape"], out["strings"])
    n_bytes = os.path.getsize(path)
    return {"bpp": 8.0 * n_bytes / (h * w), "enc_time": out["cost_time"],
            "x_hat_enc": crop_to(out["x_hat"].cpu().numpy(), (h, w))}


def decompress_one_image(codec: Codec, path: str, vbr: bool = False) -> dict:
    """Read a container file (with the VBR header where ``vbr``) and
    decode it at the level it records."""
    with open(path, "rb") as f:
        if vbr:
            h, w, s, bits = bitstream.read_uints(f, 4)
            inputscale = float(np.uint32(bits).view(np.float32))
        else:
            h, w = bitstream.read_uints(f, 2)
            s, inputscale = 0, 0.0
        strings, shape = bitstream.read_body(f)
    out = codec.decompress(strings, shape, s=s, inputscale=inputscale)
    return {"x_hat": crop_to(out["x_hat"].cpu().numpy(), (h, w)),
            "dec_time": out["cost_time"]}


def _gaussian_blur(x: np.ndarray, sigma: float = 1.0,
                   ksize: int = 5) -> np.ndarray:
    """Separable Gaussian blur on [B,H,W,C] (host-side, numpy)."""
    ax = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    k /= k.sum()
    out = x
    for axis in (1, 2):
        pad = [(0, 0)] * 4
        pad[axis] = ((ksize - 1) // 2, (ksize - 1) // 2)
        xp = np.pad(out, pad, mode="edge")
        out = sum(k[i] * np.take(xp, np.arange(out.shape[axis]) + i, axis=axis)
                  for i in range(ksize))
    return out.astype(x.dtype)


def compress_bpp_constrained(codec: Codec, x: np.ndarray, path: str,
                             max_bpp: float = 0.100, max_rounds: int = 8,
                             s: Optional[int] = None) -> dict:
    """Blur the input until the file rate is <= max_bpp."""
    out = compress_one_image(codec, x, path, s=s)
    rounds = 0
    while out["bpp"] > max_bpp and rounds < max_rounds:
        x = _gaussian_blur(np.asarray(x, np.float32))
        out = compress_one_image(codec, x, path, s=s)
        rounds += 1
    out["blur_rounds"] = rounds
    return out


def evaluate_codec_vbr(codec: Codec, images, save_dir: str,
                       levels: Optional[Iterable[int]] = None,
                       log=print) -> dict:
    """``evaluate_codec`` at each gain level (all of the model's by
    default), each into ``save_dir/level_<s>``; returns {level: means}
    (eval.py:108)."""
    images = list(images)
    if levels is None:
        levels = range(len(codec.model.cfg.lmbda))
    results = {}
    for s in levels:
        results[int(s)] = evaluate_codec(
            codec, images, os.path.join(save_dir, f"level_{s}"), s=int(s),
            log=log)
        log(f"level {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results[int(s)].items()
            if isinstance(v, float)))
    return results


def evaluate_codec(codec: Codec, images: Iterable[np.ndarray], save_dir: str,
                   s: Optional[int] = None, log=print,
                   extra_metrics: Optional[dict] = None,
                   inputscale: float = 0.0) -> dict:
    """Round-trip every image through a real file (with the VBR header at a
    level ``s``); average the metrics.

    ``extra_metrics``: optional {name: fn(x_hat, img) -> float} on numpy
    arrays."""
    os.makedirs(save_dir, exist_ok=True)
    sums = {"bpp": 0.0, "psnr": 0.0, "ms_ssim": 0.0, "enc_time": 0.0,
            "dec_time": 0.0}
    sums.update({k: 0.0 for k in (extra_metrics or ())})
    n = 0
    for i, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img[None]
        path = os.path.join(save_dir, f"img_{i:03d}.bin")
        enc = compress_one_image(codec, img, path, s, inputscale)
        dec = decompress_one_image(codec, path, vbr=s is not None)
        if not np.array_equal(dec["x_hat"], enc["x_hat_enc"]):
            raise AssertionError(
                f"decode mismatch on image {i} (non-deterministic codec)")
        x_hat = np.clip(dec["x_hat"], 0.0, 1.0)
        a = torch.from_numpy(x_hat).to(codec.device)
        b = torch.from_numpy(img).to(codec.device)
        p = float(psnr(a, b))
        m = float(ms_ssim(a, b)) if min(img.shape[1], img.shape[2]) >= 176 \
            else float("nan")
        sums["bpp"] += enc["bpp"]
        sums["psnr"] += p
        sums["ms_ssim"] += m
        sums["enc_time"] += enc["enc_time"]
        sums["dec_time"] += dec["dec_time"]
        for name, fn in (extra_metrics or {}).items():
            sums[name] += float(fn(x_hat, img))
        n += 1
        log(f"[{i}] bpp={enc['bpp']:.4f} psnr={p:.3f} ms-ssim={m:.5f} "
            f"enc={enc['enc_time']*1e3:.1f}ms dec={dec['dec_time']*1e3:.1f}ms")
    return {k: v / max(n, 1) for k, v in sums.items()} | {"n_images": n}
