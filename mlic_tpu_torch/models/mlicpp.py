"""MLIC++ model, PyTorch (port of ``mlic_tpu/models/mlicpp.py``).

``MLICPlusPlus`` for the fixed-rate configurations, the full-width and the
small decoder, depthwise or dense, with either synthesis head: the
training forward (``forward``: noisy z likelihoods, STE rounding of y,
the per-slice checkerboard, channel and global contexts) and its auxiliary
loss, and the coding halves: ``analyze`` (g_a, h_a, z rounding), the
encode pass (``codec_encode_pass``: h_s, then per slice an anchor and a
non-anchor checkerboard phase through the channel, global and local
contexts) and the format-v4 device decode (``codec_device_pass_v4``: z
decoded from the stream by integer-row bisection, then the same slice loop
with each phase's symbols decoded on the device), and the host-coded
backends' halves: the step methods (``codec_begin``,
``codec_step_anchor``, ``codec_step_nonanchor``, ``codec_finish``), one
phase at a time, and ``codec_pass``, which runs them in order with a host
exchange called once a phase.

Training and every coding path run ONE slice loop, built of the phase
helpers ``_anchor_phase``, ``_nonanchor_phase`` and ``_finish_slice``, that
differs only in how a phase obtains its quantized values, so both coding
directions, and every backend, call the same torch functions on the same
shapes and layouts: that is what makes the entropy parameters, and hence
the round trip, bit-exact, and the backends' y_hat equal.

The coding halves take the variable-rate models' quantization scale
(``scale``: symbols are ``round((y - mu) * scale)``, rows are looked up at
``sigma * scale``) and hyper-latent step (``z_qs``); the fixed rate's 1.0
leaves the arithmetic as it is (``models/vbr.py`` supplies other values).

Methods take and return NHWC arrays, as the JAX package's do; the modules
inside are NCHW.  Module names follow the flax tree (``local_0``,
``chctx_1``, ...), so ``weights.from_flax`` maps parameters by path.
"""

from __future__ import annotations

import torch
from torch import nn

from mlic_tpu_torch.entropy.cdf import get_scale_table
from mlic_tpu_torch.entropy.device_rans import make_decoder, phase_order
from mlic_tpu_torch.entropy.models import (
    EntropyBottleneck,
    build_indexes,
    gaussian_likelihood,
)
from mlic_tpu_torch.models.config import ModelConfig
from mlic_tpu_torch.models.context import (
    ChannelContext,
    EntropyParameters,
    LatentResidualPrediction,
    LinearGlobalInterContext,
    LinearGlobalIntraContext,
    LocalContext,
)
from mlic_tpu_torch.models.transforms import (
    AnalysisTransform,
    HyperAnalysis,
    HyperSynthesis,
    SynthesisTransform,
)
from mlic_tpu_torch.ops.math import (
    ckbd_anchor,
    ckbd_anchor_squeeze,
    ckbd_anchor_unsqueeze,
    ckbd_nonanchor,
    ckbd_nonanchor_squeeze,
    ckbd_nonanchor_unsqueeze,
    quantize_ste,
)

# transform_dtype -> (compute dtype of g_a/h_a/g_s, GDN dtype), as
# mlicpp.py:81-94: plain "bfloat16" keeps GDN's norm in f32 with casts
# around it; "bfloat16_mixed" contracts x^2 @ gamma from bf16 inputs with
# f32 accumulation.
_TRANSFORM_DTYPES = {
    "float32": (None, None),
    "bfloat16": (torch.bfloat16, None),
    "bfloat16_mixed": (torch.bfloat16, torch.bfloat16),
}


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A copy with the canonical row-major strides.  ``contiguous()`` keeps
    a permuted tensor whose moved axes have size 1 (a z of 1x1) as it is,
    with channels-last strides, and a convolution picks its algorithm by
    that layout: the encoder's h_s would then round differently from the
    decoder's, and a stream would not decode."""
    return t.clone(memory_format=torch.contiguous_format)


def to_nchw(t: torch.Tensor) -> torch.Tensor:
    return _dense(t.permute(0, 3, 1, 2))


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    return _dense(t.permute(0, 2, 3, 1))


def nhwc_flat(t: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B, H*W*C] in NHWC ravel order (the stream's order)."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)


def _is_one(v) -> bool:
    """The fixed rate's python 1.0, whose multiplies and divides (exact)
    are skipped with their launches."""
    return isinstance(v, (int, float)) and v == 1


def times(t, scale):
    return t if _is_one(scale) else t * scale


class MLICPlusPlus(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        N, M, S, C = cfg.N, cfg.M, cfg.slice_num, cfg.slice_ch
        dw, sd = cfg.depthwise, cfg.small_decoder
        # The small decoder (mlicpp.py:73-131): a dense encoder, an
        # N//4-wide synthesis, h_s and its hyper params at M//4, a dense
        # (96, 96) channel context and the wide LRP.
        enc_dw = dw and not sd
        hyper_M = M // 4 if sd else M
        tdt, gdt = _TRANSFORM_DTYPES[cfg.transform_dtype]
        self.g_a = AnalysisTransform(N, M, enc_dw, tdt, gdt)
        self.h_a = HyperAnalysis(M, N, enc_dw, tdt)
        self.g_s = SynthesisTransform(N // 4 if sd else N, M, dw, tdt, gdt,
                                      cfg.old_synthesis)
        self.h_s = HyperSynthesis(hyper_M, N, dw)   # f32: the entropy path
        self.entropy_bottleneck = self._make_entropy_bottleneck(N)
        for i in range(S):
            self.add_module(f"local_{i}",
                            LocalContext(C, window_size=cfg.context_window))
        for i in range(1, S):
            self.add_module(f"chctx_{i}", ChannelContext(
                C * i, C, (96, 96) if sd else (192, 128), enc_dw))
            self.add_module(f"ginter_{i}", LinearGlobalInterContext(
                C * i, C * 2, max(C * i // 32, 1)))
            self.add_module(f"gintra_{i}", LinearGlobalIntraContext(C))
        for i in range(S):
            self.add_module(f"ep_anchor_{i}", EntropyParameters(
                2 * hyper_M if i == 0 else 6 * C + 2 * hyper_M, 2 * C))
            self.add_module(f"ep_nonanchor_{i}", EntropyParameters(
                2 * C + 2 * hyper_M if i == 0 else 10 * C + 2 * hyper_M,
                2 * C))
            for branch in ("lrp_anchor", "lrp_nonanchor"):
                self.add_module(f"{branch}_{i}", LatentResidualPrediction(
                    hyper_M + (i + 1) * C, C, dw, old_wide=sd))
        self.register_buffer(
            "scale_table", torch.tensor(get_scale_table(), dtype=torch.float32),
            persistent=False)

    def _make_entropy_bottleneck(self, channels: int) -> nn.Module:
        return EntropyBottleneck(channels)

    def _sub(self, prefix: str, i: int) -> nn.Module:
        return getattr(self, f"{prefix}_{i}")

    # ---------------- shared per-slice context helpers -----------------
    def _slice_ctx(self, idx, y_hat_slices):
        if idx == 0:
            return None, None
        prev = torch.cat(y_hat_slices, 1)
        return self._sub("ginter", idx)(prev), self._sub("chctx", idx)(prev)

    def _anchor_params(self, idx, hyper_params, inter_ctx, channel_ctx):
        if idx == 0:
            return self.ep_anchor_0(hyper_params)
        return self._sub("ep_anchor", idx)(
            torch.cat([inter_ctx, channel_ctx, hyper_params], 1))

    def _nonanchor_params(self, idx, hyper_params, local_ctx, intra_ctx,
                          inter_ctx, channel_ctx):
        parts = ([local_ctx, hyper_params] if idx == 0 else
                 [local_ctx, intra_ctx, inter_ctx, channel_ctx, hyper_params])
        return self._sub("ep_nonanchor", idx)(torch.cat(parts, 1))

    def _lrp(self, branch, idx, hyper_means, y_hat_slices, current):
        return self._sub(branch, idx)(
            torch.cat([hyper_means] + list(y_hat_slices) + [current], 1))

    def _slice_state(self, hyper_params) -> dict:
        """The slice loop's state: the hyper parameters and the slices
        reconstructed so far; the phase helpers below add the current
        slice's contexts and anchor half."""
        _, hyper_means = hyper_params.chunk(2, 1)
        return {"hyper_params": hyper_params, "hyper_means": hyper_means,
                "y_hat_slices": []}

    def _anchor_phase(self, st: dict, idx: int):
        """Slice ``idx``'s global-inter and channel contexts, kept in
        ``st``, and its anchor phase's (scales, means)."""
        st["inter_ctx"], st["channel_ctx"] = self._slice_ctx(
            idx, st["y_hat_slices"])
        return self._anchor_params(idx, st["hyper_params"], st["inter_ctx"],
                                   st["channel_ctx"]).chunk(2, 1)

    def _nonanchor_phase(self, st: dict, idx: int, slice_anchor):
        """From the anchor half of slice ``idx`` (unsqueezed): its LRP
        correction, kept in ``st``, then the local and global-intra
        contexts and the non-anchor phase's (scales, means)."""
        slices = st["y_hat_slices"]
        slice_anchor = slice_anchor + ckbd_anchor(self._lrp(
            "lrp_anchor", idx, st["hyper_means"], slices, slice_anchor))
        st["slice_anchor"] = slice_anchor
        local_ctx = self._sub("local", idx)(slice_anchor)
        intra_ctx = (self._sub("gintra", idx)(slices[-1], slice_anchor)
                     if idx else None)
        return self._nonanchor_params(
            idx, st["hyper_params"], local_ctx, intra_ctx, st["inter_ctx"],
            st["channel_ctx"]).chunk(2, 1)

    def _finish_slice(self, st: dict, idx: int, slice_nonanchor) -> None:
        """Slice ``idx`` from its non-anchor half and the anchor half, with
        the second LRP correction, appended to ``st``'s slices."""
        slices = st["y_hat_slices"]
        y_hat_slice = slice_nonanchor + st["slice_anchor"]
        slices.append(y_hat_slice + ckbd_nonanchor(self._lrp(
            "lrp_nonanchor", idx, st["hyper_means"], slices, y_hat_slice)))

    def _slices(self, hyper_params, phase):
        """The slice loop that training and every coding path share
        (mlicpp.py:186-215, 647-672).  ``phase(idx, squeeze, unsqueeze,
        scales, means)`` returns the reconstructed (unsqueezed) half of
        slice ``idx``.  The step methods of the host-coded backends run the
        same phase helpers one phase at a time."""
        st = self._slice_state(hyper_params)
        for idx in range(self.cfg.slice_num):
            scales, means = self._anchor_phase(st, idx)
            slice_anchor = phase(idx, ckbd_anchor_squeeze,
                                 ckbd_anchor_unsqueeze, scales, means)
            scales, means = self._nonanchor_phase(st, idx, slice_anchor)
            slice_nonanchor = phase(idx, ckbd_nonanchor_squeeze,
                                    ckbd_nonanchor_unsqueeze, scales, means)
            self._finish_slice(st, idx, slice_nonanchor)
        return torch.cat(st["y_hat_slices"], 1)

    # --------------------------- training ------------------------------
    def forward(self, x, training: bool = True, noise=None, generator=None):
        """Training forward (mlicpp.py:173-222).  x: [B,H,W,3] in [0, 1],
        NHWC.  Returns ``{"x_hat": [B,H,W,3], "likelihoods": {"y": [B,M,h,w],
        "z": [B,N,h/4,w/4]}}``: the likelihoods are NCHW, the flax ones
        transposed.  ``training`` selects noise (``noise`` in the
        bottleneck's ``[N, B*h/4*w/4]`` layout, else drawn from
        ``generator``) or rounding for z; y is STE-rounded around its
        means either way."""
        return self._forward(x, training, noise, generator)

    def _forward(self, x, training, noise, generator, scale=1.0, z_qs=None,
                 make_round=None):
        """The training forward at quantization ``scale``: y's likelihoods
        on the scaled triple (y, sigma, mu) * scale; z through the
        bottleneck's qs grid where ``z_qs`` is given, else STE-rounded;
        ``make_round(scales)`` gives a phase's rounding ``(v, means) ->
        v_hat``, STE around the means where it is None."""
        C = self.cfg.slice_ch
        y = self.g_a(to_nchw(x.float()))
        z = self.h_a(y)
        if z_qs is None:
            _, z_likelihoods = self.entropy_bottleneck(z, training, noise,
                                                       generator)
            z_hat = self.entropy_bottleneck.ste_quantize(z)
        else:
            z_hat, z_likelihoods = self.entropy_bottleneck(
                z, training, noise, generator, qs=z_qs)
        hyper_params = self.h_s(z_hat)
        y_lks, anchor = [], {}

        def phase(idx, squeeze, unsqueeze, scales, means):
            mask = (ckbd_anchor if squeeze is ckbd_anchor_squeeze
                    else ckbd_nonanchor)
            y_slice = y[:, idx * C:(idx + 1) * C]
            scales, means = mask(scales), mask(means)
            if mask is ckbd_anchor:
                anchor["scales"], anchor["means"] = scales, means
            else:
                y_lks.append(gaussian_likelihood(
                    times(y_slice, scale),
                    times(anchor["scales"] + scales, scale),
                    times(anchor["means"] + means, scale)))
            if make_round is None:
                return quantize_ste(mask(y_slice) - means) + means
            return make_round(scales)(mask(y_slice), means)

        y_hat = self._slices(hyper_params, phase)
        return {"x_hat": to_nhwc(self.g_s(y_hat)),
                "likelihoods": {"y": torch.cat(y_lks, 1),
                                "z": z_likelihoods}}

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    # ------------------------- analysis only ---------------------------
    def analyze(self, x, z_qs=1.0):
        """x: [B,H,W,3] uint8 or float in [0,1] -> (y [B,h,w,M] f32,
        z_symbols [B,h/4,w/4,N] int32), NHWC (mlicpp.py:228); z is rounded
        on the grid of step ``z_qs`` around the medians."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        y = self.g_a(to_nchw(x.float()))
        z = self.h_a(y)
        medians = self.entropy_bottleneck.medians()[None, :, None, None]
        v = z - medians
        z_symbols = torch.round(v if _is_one(z_qs) else v / z_qs).to(
            torch.int32)
        return to_nhwc(y), to_nhwc(z_symbols)

    def _z_hat(self, z_symbols_nchw, z_qs=1.0):
        medians = self.entropy_bottleneck.medians()[None, :, None, None]
        return times(z_symbols_nchw.float(), z_qs) + medians

    def _phase_recon(self, symbols, mu_sq, sc_sq, scale):
        """A squeezed phase's values from its integer symbols (mlicpp.py:
        262): ``sym / scale + mu``.  The VBR model adds QuantABCD's offset
        here; encode and decode call it on identical inputs."""
        del sc_sq
        return times(symbols.float(), 1.0 / scale) + mu_sq

    def gain_scale(self, s=0, inputscale=0.0):
        """Coding-time quantization scale: 1.0 at the fixed rate."""
        return 1.0

    def z_step(self, s=0, inputscale=0.0):
        """Hyper-latent quantization step: 1.0 unless a VBR model has a
        variable-rate bottleneck."""
        return 1.0

    def synthesize(self, y_hat):
        """g_s on an NHWC latent -> NHWC image."""
        return to_nhwc(self.g_s(to_nchw(y_hat)))

    # --------------------- decode-complexity proxy ---------------------
    def net_decoder_forward(self, x):
        """The decoder alone, for counting its operations (mlicpp.py:682;
        reference ``mlicpp.py:380-459``): h_s of a zero z_hat of [b, N,
        h/64, w/64] for an image x [b, h, w, 3], then the slice loop with
        each phase's means taken as its values (no rounding, no coding),
        then g_s.  Returns the NHWC image."""
        b, h, w, _ = x.shape
        z_hat = torch.zeros((b, self.cfg.N, h // 64, w // 64),
                            device=x.device)

        def phase(idx, squeeze, unsqueeze, scales, means):
            mask = (ckbd_anchor if squeeze is ckbd_anchor_squeeze
                    else ckbd_nonanchor)
            return mask(means)

        return to_nhwc(self.g_s(self._slices(self.h_s(z_hat), phase)))

    # ------------------------- real coding -----------------------------
    def _phase_quantities(self, squeeze, y_slice, scales, means, scale):
        """One coding phase's squeezed (means, scales), scale indexes
        (int32, at ``sigma * scale``) and candidate symbols
        ``round((y - mu) * scale)`` (int32; None without ``y_slice``, as
        when decoding), NCHW (mlicpp.py:262)."""
        sc_sq, mu_sq = squeeze(scales), squeeze(means)
        indexes = build_indexes(times(sc_sq, scale), self.scale_table)
        cand = None if y_slice is None else torch.round(times(
            squeeze(y_slice) - mu_sq, scale)).to(torch.int32)
        return mu_sq, sc_sq, indexes, cand

    def _recon_flat(self, symbols, mu_sq, sc_sq, scale, unsqueeze):
        """A phase's unsqueezed half from its symbols as the host exchange
        gives them, int32 [B, n] raveled NHWC."""
        b, c, h, w2 = mu_sq.shape
        sym = to_nchw(symbols.reshape(b, h, w2, c))
        return unsqueeze(self._phase_recon(sym, mu_sq, sc_sq, scale))

    def codec_encode_pass(self, y, z_symbols, scale=1.0, z_qs=1.0):
        """Encode pass (mlicpp.py:607): y [B,h,w,M] and z_symbols NHWC ->
        (y_hat NHWC, symbols int32 [B, total], indexes int32 [B, total]),
        the per-phase arrays raveled NHWC and concatenated in coding
        order; symbols ``round((y - mu) * scale)``, indexes at ``sigma *
        scale``, z reconstructed at step ``z_qs``."""
        C = self.cfg.slice_ch
        y = to_nchw(y)
        hyper_params = self.h_s(self._z_hat(to_nchw(z_symbols), z_qs))
        syms, idxs = [], []

        def phase(idx, squeeze, unsqueeze, scales, means):
            mu_sq, sc_sq, indexes, cand = self._phase_quantities(
                squeeze, y[:, idx * C:(idx + 1) * C], scales, means, scale)
            syms.append(nhwc_flat(cand))
            idxs.append(nhwc_flat(indexes))
            return unsqueeze(self._phase_recon(cand, mu_sq, sc_sq, scale))

        y_hat = self._slices(hyper_params, phase)
        return to_nhwc(y_hat), torch.cat(syms, 1), torch.cat(idxs, 1)

    # ---- the host-coded backends: one phase at a time (mlicpp.py:279-455)
    def _emit(self, st: dict, idx: int, squeeze, scales, means):
        """A phase's (indexes uint8, candidates int32 or None), [B, n]
        raveled NHWC as the host coder reads them; its squeezed means and
        scales stay in ``st`` for the reconstruction."""
        C = self.cfg.slice_ch
        y = st["y"]
        mu_sq, sc_sq, indexes, cand = self._phase_quantities(
            squeeze, None if y is None else y[:, idx * C:(idx + 1) * C],
            scales, means, st["scale"])
        st["means_sq"], st["scales_sq"] = mu_sq, sc_sq
        return (nhwc_flat(indexes).to(torch.uint8),
                None if cand is None else nhwc_flat(cand))

    def _recon_state(self, st: dict, symbols, unsqueeze):
        return self._recon_flat(symbols, st["means_sq"], st["scales_sq"],
                                st["scale"], unsqueeze)

    def codec_begin(self, y, z_symbols, scale=1.0, z_qs=1.0):
        """Start a host-coded run (mlicpp.py:306): h_s of the z symbols
        (NHWC int32, at step ``z_qs``) and slice 0's anchor phase.  ``y``
        is the latent [B,h,w,M] when encoding and None when decoding (it
        enters only the candidate symbols).  Returns (state, indexes,
        candidates) of the phase: indexes uint8 [B, n] and candidates
        int32 [B, n] (None when decoding), raveled NHWC."""
        st = self._slice_state(self.h_s(self._z_hat(to_nchw(z_symbols),
                                                    z_qs)))
        st["y"] = None if y is None else to_nchw(y)
        st["scale"] = scale
        return (st, *self._emit(st, 0, ckbd_anchor_squeeze,
                                *self._anchor_phase(st, 0)))

    def codec_step_anchor(self, state: dict, symbols, idx: int):
        """Take slice ``idx``'s anchor symbols (int32 [B, n], raveled
        NHWC) and emit its non-anchor phase (mlicpp.py:329)."""
        anchor = self._recon_state(state, symbols, ckbd_anchor_unsqueeze)
        return (state, *self._emit(
            state, idx, ckbd_nonanchor_squeeze,
            *self._nonanchor_phase(state, idx, anchor)))

    def codec_step_nonanchor(self, state: dict, symbols, idx: int):
        """Complete slice ``idx`` from its non-anchor symbols and emit the
        next slice's anchor phase, or (state, None, None) after the last
        slice (mlicpp.py:359)."""
        self._finish_slice(state, idx, self._recon_state(
            state, symbols, ckbd_nonanchor_unsqueeze))
        nxt = idx + 1
        if nxt == self.cfg.slice_num:
            return state, None, None
        return (state, *self._emit(state, nxt, ckbd_anchor_squeeze,
                                   *self._anchor_phase(state, nxt)))

    def codec_finish(self, state: dict):
        """y_hat [B,h,w,M], NHWC, of a completed run (mlicpp.py:395);
        ``synthesize`` turns it into the image."""
        return to_nhwc(torch.cat(state["y_hat_slices"], 1))

    def codec_pass(self, y, z_symbols, exchange, scale=1.0, z_qs=1.0):
        """The whole host-coded run in one call (mlicpp.py:399): the step
        methods in coding order, with ``exchange(tag, indexes, candidates)
        -> symbols`` called once a phase (tags ``a0``, ``n0``, ``a1``, ...;
        arrays as ``codec_begin`` gives them).  ``y`` as in
        ``codec_begin``.  Returns y_hat NHWC."""
        state, indexes, cand = self.codec_begin(y, z_symbols, scale, z_qs)
        for idx in range(self.cfg.slice_num):
            symbols = exchange(f"a{idx}", indexes, cand)
            state, indexes, cand = self.codec_step_anchor(state, symbols, idx)
            symbols = exchange(f"n{idx}", indexes, cand)
            state, indexes, cand = self.codec_step_nonanchor(state, symbols,
                                                             idx)
        return self.codec_finish(state)

    def codec_device_pass(self, z_symbols, words, img_begin, tables,
                          n_lanes: int, n_steps: int, pad_row: int,
                          esc_values, esc_begin, scale=1.0, z_qs=1.0):
        """Format-v3 decode (mlicpp.py:457): ``z_symbols`` int32 NHWC,
        decoded on the host from each image's z string, then every phase of
        the stream is a y phase, decoded as in ``_device_pass_from_z``.
        ``words``, ``img_begin``, ``esc_values`` and ``esc_begin`` as in
        ``codec_device_pass_v4``; ``pad_row`` the row the encoder padded
        each phase with, the last Gaussian row (the JAX package counts the
        rows of its Gaussian-only tables there).  Returns y_hat [B,h,w,M],
        NHWC."""
        init, decode = make_decoder(words, n_steps, esc_values, esc_begin,
                                    n_lanes)
        return to_nhwc(self._device_pass_from_z(
            to_nchw(z_symbols.to(torch.int32)), init(img_begin), decode,
            tables, n_lanes, scale, z_qs, pad_row, n_steps))

    def codec_device_pass_v4(self, zh: int, zw: int, words, img_begin, tables,
                             n_lanes: int, n_steps: int, z_steps_row: int,
                             z_rows_base: int, esc_values, esc_begin,
                             scale=1.0, z_qs=1.0):
        """Format-v4 decode (mlicpp.py:496): z from the stream's leading
        phases by integer-row bisection over ``tables['cdf_rows']`` rows
        >= ``z_rows_base`` (the rows of step ``z_qs``), then the y phases
        at quantization ``scale``, parametrically or by rows as the tables
        say (``_device_pass_from_z``).

        words: int16 (uint16 bits), all images' blocks; img_begin int32 [B];
        esc_values/esc_begin: the escape side channel.  Returns y_hat
        [B,h,w,M], NHWC; ``synthesize`` turns it into the image."""
        N = self.cfg.N
        b = img_begin.shape[0]
        dev = words.device
        init, decode = make_decoder(words, n_steps, esc_values, esc_begin,
                                    n_lanes)
        carry = init(img_begin)
        z_n = zh * zw * N
        z_rows = z_rows_base + torch.arange(z_n, dtype=torch.int32,
                                            device=dev) % N
        ordered = phase_order(z_rows[None].expand(b, z_n), n_lanes,
                              z_rows_base - 1).contiguous()
        carry, z_sym = decode(carry, ordered, tables, n_steps_row=z_steps_row)
        steps = ordered.shape[0]
        z_sym = (z_sym.reshape(steps, b, n_lanes).permute(1, 0, 2)
                 .reshape(b, -1)[:, :z_n].reshape(b, zh, zw, N))
        return to_nhwc(self._device_pass_from_z(
            to_nchw(z_sym), carry, decode, tables, n_lanes, scale, z_qs,
            z_rows_base - 1, n_steps))

    def _device_pass_from_z(self, z_symbols, carry, decode, tables,
                            n_lanes: int, scale, z_qs, pad_row: int,
                            n_steps: int):
        """The y half of the device decode (mlicpp.py:537), NCHW; returns
        y_hat.  With ``tables["row_params"]`` the y phases decode
        parametrically; without (``Codec.update``'s fallback B) by an
        ``n_steps``-level bisection over their integer rows.  Each phase is
        padded with row ``pad_row``."""
        steps_row = None if "row_params" in tables else n_steps
        hyper_params = self.h_s(self._z_hat(z_symbols, z_qs))
        state = {"carry": carry}

        def phase(idx, squeeze, unsqueeze, scales, means):
            mu_sq, sc_sq, indexes, _ = self._phase_quantities(
                squeeze, None, scales, means, scale)
            b = mu_sq.shape[0]
            ordered = phase_order(nhwc_flat(indexes), n_lanes,
                                  pad_row).contiguous()
            state["carry"], sym = decode(state["carry"], ordered, tables,
                                         n_steps_row=steps_row)
            sym = (sym.reshape(-1, b, n_lanes).permute(1, 0, 2)
                   .reshape(b, -1)[:, :mu_sq[0].numel()])
            return self._recon_flat(sym, mu_sq, sc_sq, scale, unsqueeze)

        return self._slices(hyper_params, phase)
