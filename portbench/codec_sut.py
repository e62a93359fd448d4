"""The system under test: the port's codec (``mlic_tpu_torch.Codec``) as a
configuration file states it.

Set-up builds the kernels the codec launches (in parallel, into the
program's own ``build/kernels`` inside the checkout; a later run finds
them there), loads the weights, makes the codec and its tables, and
refuses a codec whose ``update`` fell back from the parametric tables.

For the comparison that decides ``correct``, the codec is watched in two
places, the same way in every batch: its ``decompress`` is wrapped to
count calls, and a forward pre-hook on the model's hyper-synthesis keeps
the z_hat that a chosen decompress decoded from its streams (a reference
to the tensor, no copy).  In a traced run each codec call is also
recorded as a host span, so that the trace can say what the host was
doing while the device was idle.
"""

from __future__ import annotations

import os
import time

import torch

from portbench.paths import ROOT

# the kernels a device codec launches: K1 and K2 in ``update``; K7, K3,
# K6 and K4 in coding; K8 in g_a and the contexts (K5 stays off)
KERNELS = ("select_rows", "eval_cdf", "rans_encode_prep", "rans_encode_scan",
           "rans_encode_compact", "rans_decode_phase", "invariant_matmul")


def load_weights(cfg: dict) -> dict:
    """The configuration's checkpoint, read by the program's own loader."""
    from mlic_tpu_torch.weights import load_checkpoint
    return load_checkpoint(os.path.join(ROOT, cfg["checkpoint"]))


def make(cfg: dict, device, seed: int) -> "CodecUnderTest":
    """The system under test of the codec's loops (a loop's ``SUT``)."""
    return CodecUnderTest(cfg, device)


class CodecUnderTest:
    """The codec of configuration ``cfg`` on ``device``."""

    def __init__(self, cfg: dict, device):
        from mlic_tpu_torch.codec import Codec
        from mlic_tpu_torch.models.registry import get_model
        from mlic_tpu_torch.ops import _build

        m = cfg["model"]
        if device.type == "cuda":
            _build.build([_build.KERNELS[k] for k in KERNELS])
        model = get_model(m["program_name"],
                          transform_dtype=m["transform_dtype"],
                          depthwise=m.get("depthwise", True))
        model.load_state_dict(load_weights(cfg), strict=True)
        self.codec = Codec(model, n_lanes=int(cfg["lanes"]), device=device,
                           encode_recon=False)
        self.codec.update()
        if not (self.codec.parametric and self.codec.analytic_enc_rows):
            raise RuntimeError(
                f"Codec.update fell back (parametric "
                f"{self.codec.parametric}, analytic_enc_rows "
                f"{self.codec.analytic_enc_rows}): the cell measures the "
                f"parametric tables")
        self.device = device
        self.decoded_z = {}
        self.want_z = set()
        self.calls = 0
        self._decoding = False
        model.h_s.register_forward_pre_hook(self._keep_z)
        self._decompress = self.codec.decompress
        self.codec.decompress = self._counted_decompress

    def _keep_z(self, module, inputs):
        if self._decoding and self.calls in self.want_z:
            self.decoded_z[self.calls] = inputs[0]

    def _counted_decompress(self, *args, **kwargs):
        self._decoding = True
        try:
            return self._decompress(*args, **kwargs)
        finally:
            self._decoding = False
            self.calls += 1

    def name_spans(self, spans: list) -> None:
        """Record every codec call as (name, start, end) in ``spans``, in
        the profiler's clock (``time.time_ns``; traced runs only)."""
        for attr in ("compress", "compress_begin", "compress_end",
                     "decompress"):
            fn = getattr(self.codec, attr)

            def spanned(*a, _fn=fn, _name=attr, **k):
                t = time.time_ns()
                try:
                    return _fn(*a, **k)
                finally:
                    spans.append((_name, t, time.time_ns()))
            setattr(self.codec, attr, spanned)

    def stages(self, pool, n: int) -> dict:
        """Stage ms of ``n`` serial round trips by the codec's own
        ``timings`` (each stage ends in a synchronize):
        {"compress.analyze": [ms, ...], ...}."""
        out = {}
        for i in range(n):
            marks = {"compress": {}, "decompress": {}}
            enc = self.codec.compress(pool[i % pool.shape[0]],
                                      timings=marks["compress"])
            self.codec.decompress(enc["strings"], enc["shape"],
                                  timings=marks["decompress"])
            for d, t in marks.items():
                for k, v in t.items():
                    out.setdefault(f"{d}.{k}", []).append(v)
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
