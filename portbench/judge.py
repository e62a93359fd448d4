"""The comparison that decides a run's ``correct`` for the codec's loops.

After the window has closed and the program's state is freed, the plain
reference (``portbench/reference/<name>.py``, float32, TF32 off) judges a
sample of the images the window coded, drawn from the seed before the
window opened.  For each sampled image the window kept the frame, the
encoder's y_hat, the decoder's y_hat and x_hat, and the z_hat the decoder
decoded from the stream.  The reference reads the checkpoint itself and
computes:

* ``y_roundtrip``: entries where the decoder's y_hat is not the
  encoder's, bit for bit (the rANS streams and both directions' entropy
  parameters; exact, limit 0);
* ``z_flips``: the share (%) of z symbols that differ from the
  reference's analysis of the frame (g_a, h_a, z's rounding);
* ``y_flips``: the share (%) of y symbols that differ from round(y - mu)
  with the reference's latent y and means (g_a against the coded
  symbols);
* ``y_gap``: the largest |y_hat - y_hat_ref|, y_hat_ref rebuilt by the
  reference from the decoded z_hat and the symbols recovered from the
  program's y_hat (h_s, the contexts, the entropy parameters, LRP);
* ``x_gap``: the largest |x_hat - g_s(y_hat_ref)| (the synthesis);
* ``rate_gap``: how far (%, either way) the sampled images' streams lie
  from the reference's estimated bits of what they code (z under the
  factorized prior, the recovered y symbols under the reference's
  scales): the scale half of the entropy parameters, the CDF rows and the
  coder, which the other numbers do not see while encoder and decoder
  agree.  A stream's coded bits are its 16-bit renormalisation words and
  8 bits a lane for the lanes' final states (each 32-bit state starts at
  2^16, so it ends holding 0-16 bits of the message, 8 on average); its
  12-byte header and the values of its escapes are not counted, nor are
  they in the estimate.  A program that codes
  under other scales than the configuration's moves its rate away from
  the estimate: up where the reference's scales fit the symbols, as
  trained weights' do, and down where they fit them worse.

The reference follows the program from its decoded z_hat and symbols (it
cannot re-code z itself: a bfloat16 analysis rounds some z otherwise, and
every y after it would differ); the analysis that this skips is held by
``z_flips`` and ``y_flips``.  The control (``CONTROL`` precision: float8
transforms, TF32 entropy path) stands in the program's place through
``control_outputs`` and must fail: as an ideal coder under its own
entropy model, its coded bits are its own estimate."""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from portbench.paths import ROOT

NUMBERS = ("y_roundtrip", "z_flips", "y_flips", "y_gap", "x_gap",
           "rate_gap")


def stream_totals(streams) -> tuple:
    """(words, escapes) of format-v4 streams, from their headers."""
    words = escapes = 0
    for s in streams:
        words += int.from_bytes(s[4:8], "little")
        escapes += int.from_bytes(s[8:12], "little")
    return words, escapes


def coded_bits(stream: bytes) -> int:
    """The message bits of one format-v4 stream (see ``rate_gap``)."""
    lanes = int.from_bytes(stream[0:4], "little") & 0x3FFFFFFF
    words, _ = stream_totals([stream])
    return 16 * (words - 2 * lanes) + 8 * lanes


def draw_sample(seed: int, n_batches: int, batch: int, mix: dict) -> dict:
    """{batch index: [image indexes]}: ``sample_batches`` batches among
    the first ``n_batches`` of the window, ``sample_images`` images of
    each, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    k = min(int(mix["sample_batches"]), n_batches)
    per = min(int(mix["sample_images"]), batch)
    picks = sorted(rng.choice(n_batches, size=k, replace=False).tolist())
    return {int(j): sorted(rng.choice(batch, size=per,
                                      replace=False).tolist())
            for j in picks}


class Keeper:
    """``keep(j, enc, dec)`` for a loop: copies the sampled images'
    outputs of batch ``j`` (device copies of a few rows, queued behind
    the batch) and their streams' coded bits, and sums every batch's
    stream words and escapes (the rANS kernels' work, ``observed``)."""

    def __init__(self, sut, pool, sample: dict):
        self.sut, self.pool, self.sample = sut, pool, sample
        self.kept = []
        self.words, self.escapes = [], []
        sut.want_z = set(sample)
        sut.calls = 0
        sut.decoded_z = {}

    def __call__(self, j, enc, dec):
        w, e = stream_totals(enc["strings"][0])
        self.words.append(w)
        self.escapes.append(e)
        rows = self.sample.get(j)
        if rows is None:
            return
        idx = torch.tensor(rows, device=dec["y_hat"].device)
        z = self.sut.decoded_z.pop(j, None)
        n = enc["y_hat"].shape[0]
        if z is not None and z.shape[0] == n:
            z = z.index_select(0, idx)
        else:                   # the decoder decoded no z for this batch
            z = None
        self.kept.append({
            "batch": j,
            "frames": self.pool[j % self.pool.shape[0]].index_select(0, idx),
            "y_enc": enc["y_hat"].index_select(0, idx),
            "y_dec": dec["y_hat"].index_select(0, idx),
            "x_dec": dec["x_hat"].index_select(0, idx),
            "z_dec": z,
            "bits": sum(coded_bits(enc["strings"][0][r]) for r in rows)})

    def close(self) -> list:
        self.sut.want_z = set()
        missing = set(self.sample) - {k["batch"] for k in self.kept}
        if missing:
            raise RuntimeError(f"sampled batches {sorted(missing)} were "
                               "not coded in the window")
        return self.kept

    def observed(self) -> dict:
        return {"words": self.words, "escapes": self.escapes}


def keeper(sut, pool, mix: dict, seed: int, n_batches: int) -> Keeper:
    """The keeper of a window of at least ``n_batches`` batches, its
    sample drawn from ``seed``."""
    return Keeper(sut, pool, draw_sample(seed, n_batches, pool.shape[1],
                                         mix))


def reference_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def reference_model(cfg: dict, device, params=None, precision=None):
    """The reference of configuration ``cfg`` on ``device``, reading the
    configuration's checkpoint itself unless ``params`` are given (one
    reading shared with the control)."""
    ref = reference_module(cfg)
    if params is None:
        params = ref.load_params(os.path.join(ROOT, cfg["checkpoint"]),
                                 device)
    return ref.MLICPP(params, cfg["model"],
                      ref.FLOAT32 if precision is None else precision)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def judge(kept: list, ref) -> dict:
    """The numbers of ``NUMBERS`` over the kept images."""
    tot = {"y_roundtrip": 0, "z_sym": 0, "z_diff": 0, "y_sym": 0,
           "y_diff": 0, "y_gap": 0.0, "x_gap": 0.0, "coded": 0, "est": 0.0}
    for k in kept:
        if k["y_dec"].shape != k["y_enc"].shape or k["z_dec"] is None:
            # outputs missing: every entry counts as differing
            tot["y_roundtrip"] += k["y_enc"].numel()
            continue
        tot["y_roundtrip"] += int((k["y_enc"] != k["y_dec"]).sum())
        y, z = ref.analyze(k["frames"])
        z_ref = ref.z_hat(z)
        z_dec = k["z_dec"].float()
        tot["z_sym"] += z_dec.numel()
        tot["z_diff"] += int((z_ref != z_dec).sum())
        y_hat, flips, count, bits = ref.follow(_nchw(k["y_dec"]), z_dec, y)
        tot["coded"] += k["bits"]
        tot["est"] += bits
        tot["y_sym"] += count
        tot["y_diff"] += int(flips)
        tot["y_gap"] = max(tot["y_gap"], float(
            (_nhwc(y_hat) - k["y_dec"]).abs().max()))
        x_ref = _nhwc(ref.g_s(y_hat))
        tot["x_gap"] = max(tot["x_gap"], float(
            (x_ref - k["x_dec"]).abs().max()))
    return {"y_roundtrip": tot["y_roundtrip"],
            "z_flips": 100.0 * tot["z_diff"] / max(tot["z_sym"], 1),
            "y_flips": 100.0 * tot["y_diff"] / max(tot["y_sym"], 1),
            "y_gap": tot["y_gap"], "x_gap": tot["x_gap"],
            "rate_gap": (100.0 * abs(tot["coded"] / tot["est"] - 1.0)
                         if tot["est"] else float("inf"))}


@torch.no_grad()
def control_outputs(kept: list, control) -> list:
    """The control in the program's place: the kept frames coded by the
    reference in the control's precision, as the kept records of a
    program would hold them."""
    out = []
    for k in kept:
        y, z = control.analyze(k["frames"])
        z_hat = control.z_hat(z)
        y_hat = control.encode(y, z_hat)
        bits = control.follow(y_hat, z_hat)[3]
        x_hat = control.g_s(y_hat)
        out.append({**k, "y_enc": _nhwc(y_hat), "y_dec": _nhwc(y_hat),
                    "x_dec": _nhwc(x_hat), "z_dec": z_hat, "bits": bits})
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def compare(kept: list, config: dict, device) -> tuple:
    """(correct, checks) of the kept records against the configuration's
    reference and limits; run once the program's state is freed."""
    return verdict(judge(kept, reference_model(config, device)),
                   config["limits"])
