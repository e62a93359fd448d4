"""The codec: the three backends of ``mlic_tpu/codec.py``.

``backend="device"`` (the port's default; the JAX package defaults to
``"steps"``) codes with both rANS directions on the device, format v4 by
default: ``compress`` runs analyze, the encode pass and the on-device rANS
encode (its prep, K7: z section by integer-row gathers, y phases by the
analytic Gaussian CDF or, where ``update`` fell back, by gathers; K3; K6),
then assembles one stream per image; ``decompress`` parses the streams and
runs the device decode (K4).  The host only parses and assembles bytes.
``compress`` is ``compress_end(compress_begin(x))``: the first half queues
the device work and the copy of the streams to pinned host memory with no
host synchronization, the second waits for that copy and assembles, so a
serving loop keeps two batches in flight (``roundtrip_stream``).

One switch, read when a device codec is made, as the JAX package reads
it: ``MLIC_UNIFIED_Z=0`` writes format v3 -- z coded on the host per
image into a z string of its own (``compress_end``), y alone in the lane
stream, coded on the device by the same kernels with an empty z section.
Two switches of the JAX package are not read.  ``MLIC_DEVICE_ENCODE=0``
downloads the y symbols and packs v3 on the host: the device encoder
writes the same bytes, and the JAX package's reasons for the host path
(the TPU's host link, its int16 narrowing and overflow redo) do not apply
to a card, so the port always codes on the device;
``entropy.rans.coder.encode_global`` stays as the tests' oracle of the v3
bytes.  ``MLIC_SPLIT_ENCODE`` (one XLA program or two for the encode) has
no counterpart in eager PyTorch.

``backend="steps"`` and ``"fused"`` code as the reference does
(``compress``/``decompress`` of ``MLIC++/models/mlicpp.py``): z with the
factorized prior's tables and y with the Gaussian tables, on the host,
through the port's rANS coder (``entropy/rans``), one compressai-format y
string and one z string per image.  Each checkerboard phase crosses to the
host and back: its scale indexes go down, and its symbols go down (encode)
or come up decoded (decode).  Both names run ``codec_pass``, the model's
step methods (``codec_begin``, ``codec_step_anchor``,
``codec_step_nonanchor``, ``codec_finish``) with the exchange as a Python
callable: the JAX package's split between one compiled program (``fused``)
and one program a step (``steps``) has no counterpart in eager PyTorch, so
``fused`` is kept as a name only.  The step methods run the phase helpers
of the device path's slice loop, so every backend computes the same y_hat.

``decompress`` reads three kinds of stream, whatever the codec's backend
or format, and tells them apart per batch: empty z strings mean format v4
(z inline in the y stream); z strings with y streams that carry bit 31
but not bit 30 and whose length is exactly what their header gives
(``entropy.stream.stream_is_global``) mean format v3, decoded on the
device with z from the host; any other streams are the reference's, decoded
on the host.  The length matters: a host-coded y stream opens with the low
word of a rans64 state, so its bit 31 is set about half the time.

``update`` builds the tables: for every backend the Gaussian tables
(``GaussianConditionalTables``) and the factorized prior's; for the device
backend (or on the first format-v3/v4 stream a host-coded codec decodes)
also the Gaussian row parameters, the integer table generated from them on
the codec's device, and the combined rows, so one stream carries z and y.
The table is checked as the JAX package checks it (``codec.py:572-609``):
it must be rANS-valid (``validate_tables``) and pass the decode-shaped
``self_check``, else the codec falls back to the host-built tables
(fallback B: ``parametric`` False, y coded by its integer rows both ways);
if only the encode-shaped ``self_check_encode`` fails, the table stays and
y's (start, freq) are gathered from its rows (fallback A:
``analytic_enc_rows`` 0).  A fallback warns once an ``update``, naming the
check and the count that differed.  Every ``update`` generates and checks
the table anew: the JAX package's disk cache (``MLIC_TABLE_CACHE``) saved
TPU round trips of minutes, and on the card a cold ``update`` takes tens
of milliseconds, so the port keeps none and a failed check is retried by
the next ``update``.

A device-path call records its spans (``spans.py``: the call, its stages
with CUDA events at their bounds, the slice loop's phases, the waits)
into ``spans.PROFILED`` while ``torch.profiler`` runs; otherwise it
records nothing and makes no event.  ``update`` and a codec's first
calls record their seconds as set-up (``spans.SETUP``) always.

Variable-bitrate models code at a gain level ``s`` (or a continuous
``inputscale``): the gain scales the symbols and the rows on the device,
and under a variable-rate bottleneck the level's z step selects
factorized-prior rows built for that step, cached per step.  All cached
device steps share one row width, ratcheted up when a step needs wider
rows.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from mlic_tpu_torch import spans
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
from mlic_tpu_torch.entropy.models import (
    GaussianConditionalTables,
    entropy_bottleneck_tables,
)
from mlic_tpu_torch.entropy.rans import (
    RansDecoder,
    decode_with_indexes,
    encode_with_indexes,
)
from mlic_tpu_torch.entropy.stream import (
    pack_streams,
    parse_global,
    stream_is_damaged_global,
    stream_is_global,
    stream_is_unified,
    stream_lanes,
)
from mlic_tpu_torch.models.mlicpp import MLICPlusPlus

MAX_LANES = MAX_ENCODE_LANES   # K3 and K4 take up to 1024 lanes an image
SELF_CHECK_LANES = 512         # layout width of update's decode-shaped check
CHECKS = ("validate_tables", "self_check", "self_check_encode")
_CHECK_UNITS = {"validate_tables": "rows", "self_check": "entries",
                "self_check_encode": "entries"}


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
                   n_phases: int, z_rows_base: int,
                   y_gather: bool = False) -> dict:
    """On-device rANS encode of one batch, format v4, in three launches and
    no host synchronization: the prep (K7) turns the y symbols and scale
    indexes (int32 [B, n_y], NHWC raveled) and the hyper-latent z_flat
    (int32 [B, zh*zw*N], coded first with the factorized-prior rows at
    ids ``z_rows_base + channel``) into (start, freq-1, escape) sections in
    the caller's [B, n] layout; the scan (K3) reads them in place and the
    compaction (K6) lays out the per-image word blocks and escapes.  With
    an empty z_flat ([B, 0]) it writes the y phases of format v3.
    ``y_gather``: y's entries by gathers from the integer rows (``update``'s
    fallbacks).  Returns the dict that ``entropy.stream.assemble_streams``
    reads."""
    z_flat, sym32 = z_flat.contiguous(), sym32.contiguous()
    n_z_rows = tables["cdf_rows"].shape[0] - z_rows_base
    (st_z, fm_z, esc_z), (st_y, fm_y, esc_y) = rans_encode_prep(
        sym32, idx.contiguous(), z_flat, tables, z_rows_base, n_z_rows,
        y_gather)
    x, words, masks = rans_encode_scan(st_z, fm_z, st_y, fm_y, n_lanes,
                                       n_phases)
    return rans_encode_compact(x, words, masks, esc_z, z_flat, esc_y, sym32,
                               n_lanes, n_phases)


BACKENDS = ("steps", "fused", "device")


def _download_bucket(n: int, minimum: int = 1 << 12) -> int:
    """Length of the speculative stream download (codec.py:60): ``n`` with
    3% headroom, rounded up to a sixteenth of its power of two."""
    n = max(int(n * 1.03), minimum)
    step = (1 << (n - 1).bit_length()) >> 4
    return -(-n // step) * step


class _ExchangeState:
    """The host side of the host-coded backends' per-phase exchange
    (codec.py:227): in ``encode`` mode it keeps each phase's candidate
    symbols and indexes and hands the candidates back; in ``decode`` mode
    it decodes each image's phase from that image's stream and hands the
    symbols back.  Arrays are [B, n]; each image owns its stream."""

    def __init__(self):
        self.mode = "idle"
        self.chunks: list = []          # (symbols, indexes) [B, n] a phase
        self.decoders: list = []        # one RansDecoder an image
        self.tables = None              # (cdfs, lengths, offsets)

    def exchange(self, tag: str, indexes, candidate):
        """One phase: ``indexes`` uint8 and ``candidate`` int32 (None when
        decoding) device tensors [B, n] -> the phase's symbols, int32 on
        the same device.  One download a phase either way; decoding adds
        the upload of the symbols."""
        if self.mode == "encode":
            both = torch.stack([candidate, indexes.to(torch.int32)]).cpu()
            self.chunks.append(tuple(both.numpy()))
            return candidate
        if self.mode == "decode":
            idx = indexes.cpu().numpy().astype(np.int32)
            sym = np.stack([dec.decode_stream(idx[b], *self.tables)
                            for b, dec in enumerate(self.decoders)])
            return torch.from_numpy(sym).to(indexes.device)
        raise RuntimeError(f"exchange called in mode {self.mode!r} "
                           f"(tag {tag})")


class Codec:
    """compress()/decompress() around an ``MLICPlusPlus`` with weights.

    ``backend``: ``"device"`` (format v4, both rANS directions on the
    device; the port's default), ``"steps"`` or ``"fused"`` (the
    reference's host-coded streams; the JAX package's default is
    ``"steps"``); it chooses how ``compress`` codes, and ``decompress``
    reads the streams of every backend.  ``n_lanes``: rANS lanes per
    image of the device backend, a power of two <= 1024 (the stream
    header carries it), or ``"auto"`` (the reference's default): resolved
    once, from the first compressed image's size by ``auto_lanes`` or, for
    a codec that decodes first, from the first stream's header.  Serving
    passes an explicit 512.  ``encode_recon=False`` drops the encode-side synthesis (``x_hat``
    is then None in ``compress``'s result).  ``device``: None means
    CUDA.  A device codec reads ``MLIC_UNIFIED_Z`` here (``unified_z``:
    format v4, or v3 with z coded on the host).
    ``parametric`` and ``analytic_enc_rows`` say, after ``update``, which
    tables the device codes with (the JAX package's names)."""

    def __init__(self, model: MLICPlusPlus, n_lanes: int | str = "auto",
                 device=None, backend: str = "device",
                 encode_recon: bool = True):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: one of "
                             f"{BACKENDS}")
        self.device = resolve_device(device)
        self.backend = backend
        self.encode_recon = encode_recon
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
        # the host-coded backends write the reference's streams, not v4
        self.unified_z = backend == "device" and os.environ.get(
            "MLIC_UNIFIED_Z", "1") == "1"
        self.parametric = False     # set by update (device tables)
        self.analytic_enc_rows = 0  # Gaussian rows K7 codes analytically
        self._gc = None             # GaussianConditionalTables
        self._x = _ExchangeState()
        self.tables = None          # the device backend's combined tables
        self.n_steps = 0
        self.z_rows_base = 0
        self.z_steps_row = 0
        self._scale_table = None
        self._gauss = None          # (row params, lengths, offsets, table)
        self._width = 0             # the combined rows' width, ratcheted
        self._by_step = {}          # z step -> combined device tables
        self._eb_cache = {}         # z step -> factorized-prior tables
        self._zqs_cache = {}        # (s, inputscale) -> z step
        self._words_bucket = 0      # speculative download lengths,
        self._esc_bucket = 0        # ratcheted (compress_end)
        self._serial = spans.codec_serial()  # its spans and set-up carry it
        self._calls = [0, 0]        # encode and decode calls: span ids
        self._first = {"compress_begin", "compress_end", "decompress"}

    def _recorder(self, name: str, call: int, prefix: str):
        """A ``spans.Recorder`` of call ``name`` if spans are recorded,
        else None."""
        return spans.recorder(name, call, prefix, self.device, self._serial)

    def _first_call(self, name: str, t0: float) -> None:
        """The set-up seconds of this codec's first call ``name``."""
        if name in self._first:
            self._first.remove(name)
            spans.setup("setup.first_call", t0, self._serial)

    @torch.no_grad()
    def update(self, scale_table: np.ndarray | None = None,
               force: bool = True) -> bool:
        """Build the tables (codec.py:419): the Gaussian and factorized
        prior's host tables for every backend; for the device backend the
        checked parametric table, or a fallback, and the combined device
        tables (codec.py:519, 440).  With ``force=False`` a codec that has
        its tables keeps them; returns whether it built them."""
        if self._gc is not None and not force:
            return False
        t0 = time.perf_counter()
        st = get_scale_table() if scale_table is None else scale_table
        self._gc = GaussianConditionalTables.create(st)
        self._x.tables = (self._gc.quantized_cdf, self._gc.cdf_length,
                          self._gc.offset)
        self._eb_cache, self._zqs_cache = {}, {}
        self._scale_table, self._gauss = st, None
        if self.backend == "device":
            self._update_device()
        spans.setup("setup.update", t0, self._serial)
        return True

    def _checked_table(self, params, lengths) -> tuple:
        """The parametric table generated on the codec's device and its
        verdicts {check: entries or rows that differ, -1 where not run},
        checked as codec.py:572-583 does: the encode-shaped check runs only
        on a table that passed the other two."""
        params_t = torch.as_tensor(params, device=self.device)
        table = parametric.generate_tables(params_t, lengths)
        verdicts = dict.fromkeys(CHECKS, -1)
        verdicts["validate_tables"] = parametric.validate_tables(table,
                                                                 lengths)
        if not verdicts["validate_tables"]:
            verdicts["self_check"] = parametric.self_check(
                params_t, table, lengths, SELF_CHECK_LANES)
        if not verdicts["self_check"]:
            verdicts["self_check_encode"] = parametric.self_check_encode(
                params_t, table, lengths)
        return table, verdicts

    def _update_device(self) -> None:
        """The device tables at ``update``'s scale table (codec.py:519):
        the parametric table if it passes every check; fallback A (the
        table, y's entries gathered from its rows) if only
        ``self_check_encode`` fails; fallback B (the host-built
        largest-remainder tables and a pad row [0, 2^16-1, 2^16] of length
        3, codec.py:599-609; y coded by its integer rows both ways) if
        ``validate_tables`` or ``self_check`` fails."""
        params, lengths, offsets = parametric.gaussian_row_params(
            self._scale_table)
        table, verdicts = self._checked_table(params, lengths)
        failed = [(k, v) for k, v in verdicts.items() if v > 0]
        if failed and failed[0][0] != "self_check_encode":
            n, t = self._gc.quantized_cdf.shape
            table = np.zeros((n + 1, t), np.int32)
            table[:n] = self._gc.quantized_cdf
            table[n, :3] = [0, (1 << 16) - 1, 1 << 16]
            lengths = np.append(self._gc.cdf_length, 3).astype(np.int32)
            offsets = np.append(self._gc.offset, 0).astype(np.int32)
            params = None
            self.parametric, self.analytic_enc_rows = False, 0
            self.n_steps = int(np.ceil(np.log2(np.max(lengths))))
            what = "the host-built tables, y coded by its integer rows"
        else:
            self.parametric = True
            self.analytic_enc_rows = 0 if failed else params.shape[0]
            self.n_steps = parametric.bisect_steps(lengths)
            what = "gathers of the table's rows for y's encode"
        if failed:
            name, count = failed[0]
            warnings.warn(f"Codec.update: the parametric CDF table failed "
                          f"{name} ({count} {_CHECK_UNITS[name]} differ); "
                          f"falling back to {what}", stacklevel=4)
        self._gauss = (params, lengths, offsets, table)
        self._width = 0
        self._by_step = {}
        self.z_rows_base = table.shape[0]
        self.tables = self._tables_for(1.0)

    def _require_tables(self) -> None:
        if self._gc is None:
            self.update()

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
                "large images to keep decode scans short.", stacklevel=4)
            self._warned_auto_width = True

    def _stage(self, timings, name: str, t: float, rec=None) -> float:
        """The end of stage ``name``: with a ``timings`` dict, wait for the
        device and record the ms since ``t`` under ``name``; with a
        ``spans.Recorder``, close the stage's span.  Returns the start of
        the next stage."""
        if timings is not None:
            self._sync()
            now = time.perf_counter()
            timings[name] = (now - t) * 1e3
            t = now
        if rec is not None:
            rec.stage(name)
        return t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a) -> torch.Tensor:
        """A host array or tensor on the codec's device; from the host
        through pinned memory with a copy that does not wait for the
        device's queue."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.contiguous().pin_memory().to(self.device,
                                                  non_blocking=True)
        return t.to(self.device)

    def _images(self, x) -> torch.Tensor:
        """x: [B,H,W,3] uint8 or float, H and W multiples of 64, on the
        device; float images as f32."""
        x = self._to_device(x)
        if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 64 \
                or x.shape[2] % 64:
            raise ValueError(f"compress takes [B, H, W, 3] images with H and "
                             f"W multiples of 64, got {tuple(x.shape)}")
        return x if x.dtype == torch.uint8 else x.float()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def compress(self, x, s: int = 0, inputscale: float = 0.0,
                 timings: dict | None = None) -> dict:
        """x: [B,H,W,3] uint8, or float in [0,1]; H, W multiples of 64;
        a VBR model codes at level ``s``, or at ``inputscale`` where it is
        > 0 (a fixed-rate model ignores both).  Returns {"strings":
        [y_strings, z_strings], "shape": (h/4... z dims), "y_hat":
        [B,h,w,M], "x_hat": [B,H,W,3], "cost_time": s}: one string of each
        per image; the device backend's z strings are empty (format v4
        carries z in the y stream).  x_hat is the encode-side
        reconstruction g_s(y_hat), which ``decompress`` must reproduce bit
        for bit (``mlic_tpu/codec.py:971``).  A ``timings`` dict receives
        the device backend's host-clock ms of each stage, each ended by a
        device synchronize: analyze, encode_pass, rans_encode, assemble,
        synthesize."""
        t0 = time.perf_counter()
        if self.backend == "device":
            out = self.compress_end(self.compress_begin(x, s, inputscale,
                                                        timings), timings)
        else:
            out = self._compress_host_coded(x, s, inputscale)
        self._sync()
        out["cost_time"] = time.perf_counter() - t0
        return out

    @torch.no_grad()
    def compress_begin(self, x, s: int = 0, inputscale: float = 0.0,
                       timings: dict | None = None) -> dict:
        """The device half of a device-backend ``compress``
        (codec.py:789): uploads the batch and queues analyze, the encode
        pass, the rANS encode and the copy of its counts and speculative
        word and escape prefixes to pinned host memory, with no host
        synchronization once the tables and the level's z step exist.
        Format v3 also queues the copy of z.  Returns the handle
        ``compress_end`` takes.  A later batch's ``compress_begin`` may
        come before this one's ``compress_end``: the device runs the two in
        the order they were queued."""
        if self.backend != "device":
            raise ValueError("compress_begin/compress_end split the device "
                             f"backend; this codec is {self.backend!r}")
        t0 = time.perf_counter()
        self._require_tables()
        call = self._calls[0]
        self._calls[0] += 1
        rec = self._recorder("call.compress_begin", call, "encode.")
        t = time.perf_counter()
        x = self._images(x)
        if self.n_lanes is None:
            self._resolve_lanes(auto_lanes(self.model.cfg, x.shape[1],
                                           x.shape[2]))
        else:
            self._check_auto_width(x.shape[1], x.shape[2])
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        tables = self._tables_for(z_qs)
        y, z_symbols = self.model.analyze(x, z_qs)
        t = self._stage(timings, "analyze", t, rec)
        y_hat, sym32, idx = self.model.codec_encode_pass(
            y, z_symbols, scale, z_qs, None if rec is None else rec.step)
        t = self._stage(timings, "encode_pass", t, rec)
        b, zh, zw, _ = z_symbols.shape
        z_flat = z_symbols.reshape(b, -1)
        comp = encode_rans_v4(
            sym32, idx, z_flat if self.unified_z else z_flat[:, :0],
            tables, self.n_lanes, 2 * self.model.cfg.slice_num,
            self.z_rows_base, y_gather=not self.analytic_enc_rows)
        parts = [torch.cat([comp["img_n"], comp["ecount"]]),
                 comp["buf"][:self._words_bucket],
                 comp["ebuf"][:self._esc_bucket]]
        if not self.unified_z:
            parts.append(z_flat)
        done = None
        if self.device.type == "cuda":
            host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                    for p in parts]
            for h, p in zip(host, parts):
                h.copy_(p, non_blocking=True)
            parts = host
            done = torch.cuda.Event()
            done.record()
        self._stage(timings, "rans_encode", t, rec)
        if rec is not None:
            rec.end()
        if self._first:
            self._first_call("compress_begin", t0)
        return {"comp": comp, "host": parts, "done": done, "y_hat": y_hat,
                "shape": (zh, zw), "z_qs": z_qs, "t0": t0, "call": call}

    @torch.no_grad()
    def compress_end(self, h: dict, timings: dict | None = None) -> dict:
        """The host half (codec.py:844): waits for ``compress_begin``'s
        copy, fetches the rest of the words or escapes where a stream
        outgrew the speculative prefix (which then grows, so a session
        does so a few times), assembles the streams, codes format v3's z
        strings on the host, and queues the encode-side synthesis.
        Returns ``compress``'s result; ``x_hat`` may still be in flight.
        A ``timings`` dict gets the host's stages: assemble, z_encode (v3)
        and synthesize."""
        t0 = t = time.perf_counter()
        rec = self._recorder("call.compress_end", h["call"], "encode.")
        if h["done"] is not None:
            if rec is not None:
                rec.step("wait")
            h["done"].synchronize()
            if rec is not None:
                rec.step()
        host = [p.numpy() for p in h["host"]]
        streams = self._assemble(h["comp"], *host[:3], rec)
        t = self._stage(timings, "assemble", t, rec)
        zh, zw = h["shape"]
        if self.unified_z:
            z_strings = [b""] * len(streams)
        else:
            z_strings = self._encode_z(host[-1].reshape(
                len(streams), zh, zw, -1), h["z_qs"])
            t = self._stage(timings, "z_encode", t, rec)
        y_hat = h["y_hat"]
        x_hat = self.model.synthesize(y_hat) if self.encode_recon else None
        self._stage(timings, "synthesize", t,
                    rec if self.encode_recon else None)
        if rec is not None:
            rec.end()
        if self._first:
            self._first_call("compress_end", t0)
        return {"strings": [streams, z_strings],
                "shape": h["shape"], "y_hat": y_hat, "x_hat": x_hat,
                "cost_time": time.perf_counter() - h["t0"]}

    def _assemble(self, comp: dict, counts, buf, ebuf, rec=None) -> list:
        """The device encoder's streams from the downloaded counts and
        speculative prefixes, the rest fetched where they fall short (in
        ``rec``'s step ``fetch``)."""
        img_n, ecount = np.split(counts.astype(np.int64), 2)
        n_w, n_e = int(img_n.sum()), int(ecount.sum())
        fetch = rec is not None and (n_w > len(buf) or n_e > len(ebuf))
        if fetch:
            rec.step("fetch")
        if n_w > len(buf):
            buf = comp["buf"][:n_w].cpu().numpy()
        if n_e > len(ebuf):
            ebuf = comp["ebuf"][:n_e].cpu().numpy()
        if fetch:
            rec.step()
        self._words_bucket = max(self._words_bucket, min(
            _download_bucket(n_w), comp["buf"].numel()))
        self._esc_bucket = max(self._esc_bucket, min(
            _download_bucket(n_e, 1024), comp["ebuf"].numel()))
        return pack_streams(img_n, ecount, buf[:n_w].view(np.uint16),
                            ebuf[:n_e], self.n_lanes, self.unified_z)

    def _compress_host_coded(self, x, s: int, inputscale: float) -> dict:
        """The steps and fused backends' compress (codec.py:933-973): z and
        then y coded on the host, one stream of each per image."""
        self._require_tables()
        x = self._images(x)
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        y, z_symbols = self.model.analyze(x, z_qs)
        z_np = z_symbols.cpu().numpy()
        z_strings = self._encode_z(z_np, z_qs)
        self._x.mode, self._x.chunks = "encode", []
        try:
            y_hat = self.model.codec_pass(y, z_symbols, self._x.exchange,
                                          scale, z_qs)
            chunks = self._x.chunks
        finally:
            self._x.mode, self._x.chunks = "idle", []
        y_strings = [encode_with_indexes(
            np.concatenate([sym[b] for sym, _ in chunks]),
            np.concatenate([idx[b] for _, idx in chunks]), *self._x.tables)
            for b in range(len(z_np))]
        x_hat = self.model.synthesize(y_hat) if self.encode_recon else None
        return {"strings": [y_strings, z_strings],
                "shape": tuple(z_np.shape[1:3]), "y_hat": y_hat,
                "x_hat": x_hat}

    def _z_rows(self, z_qs: float, shape) -> tuple:
        """The factorized prior's tables at step ``z_qs`` and the row of
        each z position of an image (its channel), raveled NHWC."""
        eb_cdfs, eb_lengths, eb_offsets, _ = self._eb_for(z_qs)
        rows = np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)
        return rows.ravel(), (eb_cdfs, eb_lengths, eb_offsets)

    def _encode_z(self, z_np: np.ndarray, z_qs: float) -> list:
        """Factorized-prior coding of z [B, zh, zw, N], per image
        (codec.py:779)."""
        rows, tabs = self._z_rows(z_qs, z_np.shape[1:])
        return [encode_with_indexes(z.ravel(), rows, *tabs) for z in z_np]

    def _decode_z_host(self, z_strings, z_qs: float, zh: int,
                       zw: int) -> np.ndarray:
        """The z symbols [B, zh, zw, N] int32 of each image's z string
        (codec.py:767)."""
        shape = (zh, zw, self.model.cfg.N)
        rows, tabs = self._z_rows(z_qs, shape)
        return np.stack([decode_with_indexes(z, rows, *tabs).reshape(shape)
                         for z in z_strings])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def decompress(self, strings, shape, s: int = 0, inputscale: float = 0.0,
                   timings: dict | None = None, wait: bool = True) -> dict:
        """strings: [y_strings, z_strings] from ``compress``; shape: the z
        spatial dims; ``s`` and ``inputscale`` as the encoder's.  Returns
        {"x_hat", "y_hat", "cost_time"}, NHWC.  Empty z strings: format
        v4, decoded on the device.  z strings and y streams that read as
        format v3 (``stream_is_global``, not v4): z decoded on the host, y
        on the device.  Other streams are the reference's, decoded on the
        host as the steps backend codes.  A ``timings`` dict receives the
        device decode's ms of each stage, as in ``compress``: parse,
        z_decode (v3), entropy_decode, synthesize.  ``wait=False`` (formats
        v3 and v4) returns once the decode and the synthesis are queued,
        without waiting for the device: the caller waits for ``x_hat``, and
        ``cost_time`` then measures the queueing (codec.py:976)."""
        t0 = time.perf_counter()
        self._require_tables()
        y_strings, z_strings = strings
        v3 = all(z_strings) and self._is_v3(y_strings)
        if all(z_strings) and not v3:
            out = self._decompress_host_coded(strings, shape, s, inputscale)
            self._sync()
            out["cost_time"] = time.perf_counter() - t0
            return out
        if self._gauss is None:
            self._update_device()
        call = self._calls[1]
        self._calls[1] += 1
        rec = self._recorder("call.decompress", call, "decode.")
        t = time.perf_counter()
        words_t, img_begin_t, esc_t, esc_begin_t = self._parse(y_strings,
                                                              v3)
        zh, zw = shape
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        tables = self._tables_for(z_qs)
        t = self._stage(timings, "parse", t, rec)
        step = None if rec is None else rec.step
        if v3:
            z = self._decode_z_host(z_strings, z_qs, zh, zw)
            t = self._stage(timings, "z_decode", t, rec)
            y_hat = self.model.codec_device_pass(
                self._to_device(z), words_t, img_begin_t, tables,
                self.n_lanes, self.n_steps, self.z_rows_base - 1, esc_t,
                esc_begin_t, scale, z_qs, step)
        else:
            y_hat = self.model.codec_device_pass_v4(
                int(zh), int(zw), words_t, img_begin_t, tables,
                self.n_lanes, self.n_steps, self.z_steps_row,
                self.z_rows_base, esc_t, esc_begin_t, scale, z_qs, step)
        t = self._stage(timings, "entropy_decode", t, rec)
        x_hat = self.model.synthesize(y_hat)
        self._stage(timings, "synthesize", t, rec)
        if wait:
            if rec is not None:
                rec.step("wait")
            self._sync()
        if rec is not None:
            rec.end()
        if self._first:
            self._first_call("decompress", t0)
        return {"x_hat": x_hat, "y_hat": y_hat,
                "cost_time": time.perf_counter() - t0}

    @staticmethod
    def _is_v3(y_strings) -> bool:
        """Whether y streams that come with z strings are format v3 (each
        ``stream_is_global`` and not v4) or the reference's (none is);
        raises for a v3 or v4 stream that was cut or padded, or a batch of
        both kinds."""
        kinds = set()
        for y in y_strings:
            if stream_is_damaged_global(y):
                raise ValueError("a format-v3/v4 stream whose length is not "
                                 "its header's: truncated or padded")
            kinds.add(stream_is_global(y) and not stream_is_unified(y))
        if len(kinds) > 1:
            raise ValueError("a batch of format-v3 and host-coded streams")
        return kinds == {True}

    def _parse(self, y_strings, v3: bool) -> tuple:
        """Format-v3 or v4 streams -> (words int16, img_begin int32, escape
        values int32, esc_begin int32) on the device; a decode-only codec
        takes its lane count from the first header."""
        words, img_begin, escs, esc_begin = [], [], [], []
        n_words = n_esc = 0
        for stream in y_strings:
            if not v3 and not stream_is_unified(stream):
                raise ValueError("not a format-v4 stream, and a stream of "
                                 "the steps backend carries a z string")
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

        def i32(a):
            return self._to_device(np.asarray(a, np.int32))

        return (self._to_device(np.concatenate(words).view(np.int16)),
                i32(img_begin), i32(np.concatenate(escs) if n_esc
                                    else np.zeros(1)), i32(esc_begin))

    def _decompress_host_coded(self, strings, shape, s: int,
                               inputscale: float) -> dict:
        """The reference's streams' decompress (codec.py:1069): z
        decoded on the host, uploaded, then the slice loop with every
        phase's symbols decoded on the host from each image's y stream."""
        y_strings, z_strings = strings
        scale = self._scale_for(s, inputscale)
        z_qs = self._z_qs_for(s, inputscale)
        z = self._decode_z_host(z_strings, z_qs, *shape)
        z_symbols = torch.from_numpy(z).to(self.device)
        decoders = []
        try:
            for stream in y_strings:
                decoders.append(RansDecoder())
                decoders[-1].set_stream(stream)
            self._x.mode, self._x.decoders = "decode", decoders
            y_hat = self.model.codec_pass(None, z_symbols, self._x.exchange,
                                          scale, z_qs)
        finally:
            self._x.mode, self._x.decoders = "idle", []
            for dec in decoders:
                dec.close()
        return {"x_hat": self.model.synthesize(y_hat), "y_hat": y_hat}

    # ------------------------------------------------------------------
    def roundtrip_stream(self, batches, s: int = 0, inputscale: float = 0.0,
                         wait: bool = True):
        """Serving pipeline (codec.py:1091): yields ``(enc, dec)`` per
        batch, two deep on the device backend -- batch i+1's
        ``compress_begin`` is queued before batch i's ``compress_end``, and
        batch i's decode is queued before batch i-1's pair is handed out
        -- and one batch at a time on the others.  With ``wait=False`` the
        yielded ``dec["x_hat"]`` may still be in flight."""
        if self.backend != "device":
            for x in batches:
                enc = self.compress(x, s, inputscale)
                yield enc, self.decompress(enc["strings"], enc["shape"], s,
                                           inputscale)
            return
        it = iter(batches)
        x = next(it, None)
        h = None if x is None else self.compress_begin(x, s, inputscale)
        pending = None          # (enc, dec, done event, call id)
        while h is not None:
            x = next(it, None)
            h_next = None if x is None else self.compress_begin(x, s,
                                                                inputscale)
            enc = self.compress_end(h)
            call = h.get("call")            # None: a ShardedCodec's handle
            if call is not None:
                self._calls[1] = call       # the batch's decode: its id
            dec = self.decompress(enc["strings"], enc["shape"], s,
                                  inputscale, wait=False)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                yield self._handed_out(pending, wait)
            pending = (enc, dec, done, call)
            h = h_next
        if pending is not None:
            yield self._handed_out(pending, wait)

    def _handed_out(self, pending, wait: bool):
        enc, dec, done, call = pending
        if wait and done is not None:
            rec = (None if call is None else
                   self._recorder("stream.wait", call, "stream."))
            done.synchronize()
            if rec is not None:
                rec.end()
        return enc, dec
