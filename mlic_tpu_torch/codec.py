"""The codec: the device backend of ``mlic_tpu/codec.py``, format v4.

``compress`` runs analyze, the encode pass and the on-device rANS encode
(its prep, K7: z section by integer-row gathers, y phases by the analytic
Gaussian CDF), then assembles one stream per image.  ``decompress`` parses the streams
and runs the format-v4 device decode.  Both rANS directions run on the
device; the host only parses and assembles bytes.

``update`` builds the tables: the Gaussian row parameters, the integer
table generated from them on the codec's device, and the factorized
prior's rows, combined so one stream carries z and y.  The table must be
rANS-valid and pass the decode- and encode-shaped self-checks, else
``update`` raises with the count of entries that differ -- there is no
host-table fallback.

Variable-bitrate models code at a gain level ``s`` (or a continuous
``inputscale``): the gain scales the symbols and the rows on the device,
and under a variable-rate bottleneck the level's z step selects
factorized-prior rows built for that step, cached per step.  All cached
steps share one row width, ratcheted up when a step needs wider rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mlic_tpu_torch.device import resolve_device
from mlic_tpu_torch.entropy import parametric
from mlic_tpu_torch.entropy.cdf import get_scale_table
from mlic_tpu_torch.entropy.device_rans import (
    MAX_ENCODE_LANES,
    parametric_device_tables,
    rans_encode_compact,
    rans_encode_prep,
    rans_encode_scan,
)
from mlic_tpu_torch.entropy.models import entropy_bottleneck_tables
from mlic_tpu_torch.entropy.stream import (
    assemble_streams,
    parse_global,
    stream_is_unified,
    stream_lanes,
)
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus

MAX_LANES = MAX_ENCODE_LANES   # K3 and K4 take up to 1024 lanes an image
SELF_CHECK_LANES = 512         # layout width of update's decode-shaped check


def auto_lanes(cfg, h: int, w: int, max_lanes: int = 256,
               min_lanes: int = 16, sym_per_lane: int = 64) -> int:
    """Size-adaptive rANS lane count (``Codec(n_lanes="auto")``; the port's
    copy of ``mlic_tpu/codec.py:76``).

    Lane state costs 4 B a lane per image, and every coding phase pads its
    symbols to a lane multiple, so small images want narrow codecs.  Picks
    the largest power of two keeping >= ``sym_per_lane`` y symbols per
    lane, clamped to [``min_lanes``, ``max_lanes``]: 256 at eval sizes
    (>= ~256^2), 16 lanes for a 64^2 MLICPP_TINY tile, 32 for MLICPP_S.
    Throughput-tuned serving passes an explicit count (512)."""
    h64 = -(-int(h) // 64) * 64
    w64 = -(-int(w) // 64) * 64
    n_sym = (h64 // 16) * (w64 // 16) * cfg.M
    lanes = 1 << (max(n_sym // sym_per_lane, 1).bit_length() - 1)
    return max(min_lanes, min(max_lanes, lanes))


def encode_rans_v4(sym32, idx, z_flat, tables: dict, n_lanes: int,
                   n_phases: int, z_rows_base: int) -> dict:
    """On-device rANS encode of one batch, format v4, in three launches and
    no host synchronization: the prep (K7) turns the y symbols and scale
    indexes (int32 [B, n_y], NHWC raveled) and the hyper-latent z_flat
    (int32 [B, zh*zw*N], coded first with the factorized-prior rows at
    ids ``z_rows_base + channel``) into (start, freq-1, escape) sections in
    the caller's [B, n] layout; the scan (K3) reads them in place and the
    compaction (K6) lays out the per-image word blocks and escapes.
    Returns the dict that ``entropy.stream.assemble_streams`` reads."""
    z_flat, sym32 = z_flat.contiguous(), sym32.contiguous()
    n_z_rows = tables["cdf_rows"].shape[0] - z_rows_base
    (st_z, fm_z, esc_z), (st_y, fm_y, esc_y) = rans_encode_prep(
        sym32, idx.contiguous(), z_flat, tables, z_rows_base, n_z_rows)
    x, words, masks = rans_encode_scan(st_z, fm_z, st_y, fm_y, n_lanes,
                                       n_phases)
    return rans_encode_compact(x, words, masks, esc_z, z_flat, esc_y, sym32,
                               n_lanes, n_phases)


class Codec:
    """compress()/decompress() around an ``MLICPlusPlus`` with weights.

    ``n_lanes``: rANS lanes per image, a power of two <= 1024 (the stream
    header carries it), or ``"auto"`` (the reference's default): resolved
    once, from the first compressed image's size by ``auto_lanes`` or, for
    a codec that decodes first, from the first stream's header.  Serving
    passes an explicit 512.  ``device``: None means CUDA."""

    def __init__(self, model: MLICPlusPlus, n_lanes: int | str = "auto",
                 device=None):
        self.device = resolve_device(device)
        self.n_lanes = None
        if n_lanes != "auto":
            nl = int(n_lanes)
            if not 1 <= nl <= MAX_LANES or nl & (nl - 1):
                raise ValueError(f"n_lanes must be a power of two in [1, "
                                 f"{MAX_LANES}], got {nl}")
            self.n_lanes = nl
        self._auto_resolved = False
        self._warned_auto_width = False
        self.model = model.to(self.device).eval()
        self.tables = None
        self.n_steps = 0
        self.z_rows_base = 0
        self.z_steps_row = 0
        self._gauss = None          # (row params, lengths, offsets, table)
        self._width = 0             # the combined rows' width, ratcheted
        self._by_step = {}          # z step -> combined device tables
        self._eb_cache = {}         # z step -> factorized-prior tables
        self._zqs_cache = {}        # (s, inputscale) -> z step

    @torch.no_grad()
    def update(self, scale_table: np.ndarray | None = None) -> None:
        """Build and check the tables (codec.py:419, 519, 440)."""
        st = get_scale_table() if scale_table is None else scale_table
        params, lengths, offsets = parametric.gaussian_row_params(st)
        params_t = torch.as_tensor(params, device=self.device)
        table = parametric.generate_tables(params_t, lengths)
        checks = {
            "validate_tables (rows)": parametric.validate_tables(
                table, lengths),
            "self_check (entries)": parametric.self_check(
                params_t, table, lengths, SELF_CHECK_LANES),
            "self_check_encode (entries)": parametric.self_check_encode(
                params_t, table, lengths),
        }
        failed = {k: v for k, v in checks.items() if v}
        if failed:
            raise RuntimeError(f"parametric CDF table rejected: {failed} "
                               "differ")
        self._gauss = (params, lengths, offsets, table)
        self._width = 0
        self._by_step, self._eb_cache, self._zqs_cache = {}, {}, {}
        self.n_steps = parametric.bisect_steps(lengths)
        self.z_rows_base = table.shape[0]
        self.tables = self._tables_for(1.0)

    def _eb_for(self, z_qs: float):
        """The factorized prior's tables at step ``z_qs``, cached
        (codec.py:656)."""
        if z_qs not in self._eb_cache:
            self._eb_cache[z_qs] = entropy_bottleneck_tables(
                self.model.entropy_bottleneck.numpy_params(), qs=z_qs)
        return self._eb_cache[z_qs]

    def _combined(self, z_qs: float) -> dict:
        """Device tables of the Gaussian rows and the factorized prior's
        rows at step ``z_qs`` (codec.py:440), at the ratcheted width."""
        params, lengths, offsets, table = self._gauss
        eb_cdfs, eb_len, eb_off, _ = self._eb_for(z_qs)
        n_g = table.shape[0]
        width = max(table.shape[1], eb_cdfs.shape[1])
        self._width = max(-(-width // 64) * 64, self._width)
        rows = np.zeros((n_g + eb_cdfs.shape[0], self._width), np.int32)
        rows[:n_g, :table.shape[1]] = table
        rows[n_g:, :eb_cdfs.shape[1]] = eb_cdfs
        return parametric_device_tables(
            params, np.concatenate([lengths, eb_len]),
            np.concatenate([offsets, eb_off]), rows, self.device)

    def _tables_for(self, z_qs: float) -> dict:
        """The combined tables of step ``z_qs``, cached (codec.py:499).
        When a step needs wider rows than the cache holds, every cached
        step is rebuilt at the new width, and ``z_steps_row`` (the z
        bisection's depth) grows with it, so one width serves all."""
        tabs = self._by_step.get(z_qs)
        if tabs is None:
            width0 = self._width
            tabs = self._combined(z_qs)
            if self._width != width0:
                for q in self._by_step:
                    self._by_step[q] = self._combined(q)
            self._by_step[z_qs] = tabs
            self.z_steps_row = int(np.ceil(np.log2(self._width)))
            self.tables = self._by_step.get(1.0, tabs)
        return tabs

    def _scale_for(self, s: int, inputscale: float):
        """The level's gain, a 0-d f32 tensor made on the device by an
        index and a ``where`` (no host synchronization); the fixed rate's
        python 1.0 skips it (codec.py:635)."""
        if not self.model.cfg.vbr:
            return 1.0
        return self.model.gain_scale(s, inputscale)

    def _z_qs_for(self, s: int, inputscale: float) -> float:
        """The level's z step as a host float: 1.0 without a variable-rate
        bottleneck, else one download per (level, inputscale), cached
        (codec.py:644)."""
        if not self.model.cfg.vr_entbttlnck:
            return 1.0
        key = (int(s), float(inputscale))
        if key not in self._zqs_cache:
            self._zqs_cache[key] = float(self.model.z_step(s, inputscale))
        return self._zqs_cache[key]

    def _resolve_lanes(self, lanes: int) -> None:
        """Fix an ``n_lanes="auto"`` codec to ``lanes``, once."""
        self._auto_resolved = True
        self.n_lanes = int(lanes)

    def _check_auto_width(self, h: int, w: int) -> None:
        """An auto codec keeps the width it resolved on its first image:
        decode stays bit-exact at any width, but a much larger image then
        codes with needlessly few lanes (longer decode scans).  Warns once
        when an image would pick >= 4x the lanes (codec.py:615)."""
        if not self._auto_resolved or self._warned_auto_width:
            return
        want = auto_lanes(self.model.cfg, h, w)
        if want >= 4 * self.n_lanes:
            import warnings
            warnings.warn(
                f"Codec resolved n_lanes={self.n_lanes} from its first "
                f"image, but a {h}x{w} image would pick {want}; the lane "
                "count is fixed per codec: construct a separate Codec for "
                "large images to keep decode scans short.", stacklevel=3)
            self._warned_auto_width = True

    def _stage(self, timings, name: str, t: float) -> float:
        """With a ``timings`` dict, wait for the device and record the ms
        since ``t`` under ``name``; returns the start of the next stage."""
        if timings is None:
            return t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        timings[name] = (now - t) * 1e3
        return now

    @torch.no_grad()
    def compress(self, x, s: int = 0, inputscale: float = 0.0,
                 timings: dict | None = None) -> dict:
        """x: [B,H,W,3] uint8, or float in [0,1]; H, W multiples of 64;
        a VBR model codes at level ``s``, or at ``inputscale`` where it is
        > 0 (a fixed-rate model ignores both).  Returns {"strings":
        [y_strings, z_strings], "shape": (h/4... z dims), "y_hat":
        [B,h,w,M], "x_hat": [B,H,W,3], "cost_time": s}; the z strings are
        empty in format v4 (z travels in the y stream) and x_hat is the
        encode-side reconstruction g_s(y_hat), which ``decompress`` must
        reproduce bit for bit (``mlic_tpu/codec.py:971``).  A ``timings``
        dict receives the host-clock ms of each stage, each ended by a
        device synchronize: analyze, encode_pass, rans_encode, assemble,
        synthesize."""
        t0 = time.perf_counter()
        if self.tables is None:
            self.update()
        t = time.perf_counter()
        x = torch.as_tensor(x).to(self.device)
        if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 64 \
                or x.shape[2] % 64:
            raise ValueError(f"compress takes [B, H, W, 3] images with H and "
                             f"W multiples of 64, got {tuple(x.shape)}")
        if x.dtype != torch.uint8:
            x = x.float()
        if self.n_lanes is None:
            self._resolve_lanes(auto_lanes(self.model.cfg, x.shape[1],
                                           x.shape[2]))
        else:
            self._check_auto_width(x.shape[1], x.shape[2])
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        tables = self._tables_for(z_qs)
        y, z_symbols = self.model.analyze(x, z_qs)
        t = self._stage(timings, "analyze", t)
        y_hat, sym32, idx = self.model.codec_encode_pass(y, z_symbols, scale,
                                                         z_qs)
        t = self._stage(timings, "encode_pass", t)
        b, zh, zw, _ = z_symbols.shape
        comp = encode_rans_v4(sym32, idx, z_symbols.reshape(b, -1),
                              tables, self.n_lanes,
                              2 * self.model.cfg.slice_num, self.z_rows_base)
        t = self._stage(timings, "rans_encode", t)
        streams = assemble_streams(comp, self.n_lanes)
        t = self._stage(timings, "assemble", t)
        x_hat = self.model.synthesize(y_hat)
        self._stage(timings, "synthesize", t)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"strings": [streams, [b""] * b], "shape": (zh, zw),
                "y_hat": y_hat, "x_hat": x_hat,
                "cost_time": time.perf_counter() - t0}

    @torch.no_grad()
    def decompress(self, strings, shape, s: int = 0, inputscale: float = 0.0,
                   timings: dict | None = None) -> dict:
        """strings: [y_strings, z_strings] from ``compress``; shape: the z
        spatial dims; ``s`` and ``inputscale`` as the encoder's.  Returns
        {"x_hat", "y_hat", "cost_time"}, NHWC.  A ``timings`` dict receives
        the ms of each stage, as in ``compress``: parse, entropy_decode,
        synthesize."""
        t0 = time.perf_counter()
        if self.tables is None:
            self.update()
        t = time.perf_counter()
        words, img_begin, escs, esc_begin = [], [], [], []
        n_words = n_esc = 0
        for stream in strings[0]:
            if not stream_is_unified(stream):
                raise ValueError("not a format-v4 stream")
            lanes = stream_lanes(stream)
            if lanes > MAX_LANES:
                raise ValueError(
                    f"stream has {lanes} lanes: the rANS kernels (K3, K4) "
                    f"take at most {MAX_LANES} lanes an image")
            if self.n_lanes is None:        # decode-only: follow the header
                self._resolve_lanes(lanes)
            _, w, e = parse_global(stream)
            if lanes != self.n_lanes:
                raise ValueError(f"stream has {lanes} lanes, codec built "
                                 f"for {self.n_lanes}")
            if len(w) < 2 * lanes:
                raise ValueError(f"stream holds {len(w)} words, fewer than "
                                 f"the {2 * lanes} lane states")
            img_begin.append(n_words)
            esc_begin.append(n_esc)
            words.append(w)
            escs.append(e)
            n_words += len(w)
            n_esc += len(e)
        dev = self.device

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        words_t = torch.from_numpy(
            np.concatenate(words).view(np.int16)).to(dev)
        esc_t = i32(np.concatenate(escs) if n_esc else np.zeros(1))
        zh, zw = shape
        img_begin_t, esc_begin_t = i32(img_begin), i32(esc_begin)
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        tables = self._tables_for(z_qs)
        t = self._stage(timings, "parse", t)
        y_hat = self.model.codec_device_pass_v4(
            int(zh), int(zw), words_t, img_begin_t, tables,
            self.n_lanes, self.n_steps, self.z_steps_row, self.z_rows_base,
            esc_t, esc_begin_t, scale, z_qs)
        t = self._stage(timings, "entropy_decode", t)
        x_hat = self.model.synthesize(y_hat)
        self._stage(timings, "synthesize", t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {"x_hat": x_hat, "y_hat": y_hat,
                "cost_time": time.perf_counter() - t0}
