"""Convert a reference (PyTorch MLIC++) checkpoint into the port's weights
(port of ``tools/convert_reference_checkpoint.py``, which writes flax
params; this one maps straight onto the port's state_dict).

    python -m mlic_tpu_torch.tools.convert_reference_checkpoint \\
        --torch-ckpt f.pth.tar --model MLICPP_L --dense --out f.pt
    python -m mlic_tpu_torch.tools.convert_reference_checkpoint --self-test

The published MLIC++ weights use dense convolutions (``--dense``).  The
key mapping follows the reference's module definitions
(``MLIC++/models/mlicpp.py``, ``modules/transform/*``,
``modules/layers/*``) and compressai's parameter names; both are NCHW, so
most tensors keep their layout:

  Conv2d OIHW, Linear [O, I], LayerNorm, biases      as they are
  GDN gamma [O, I]                                   transposed
  LocalContext fusion Conv2d(C, 2C, k=w)             the port's Dense over
    [2C, C, w, w]                                    the flattened window:
                                                     weight[o, (i*w+j)*C+c]
                                                     = torch[o, c, i, j]

(the JAX tool maps a reference tensor to flax, ``weights.from_flax`` flax
to the port: a Conv2d goes OIHW -> HWIO -> OIHW, a GDN gamma is
transposed on the first step only).  The entropy models' CDF buffers and
the Swin index buffer are not converted: ``Codec.update`` rebuilds the
tables from the learned quantiles and densities.

The output is a state_dict file that ``weights.load_checkpoint`` reads and
the model loads with ``strict=True``; the CLI checks that load.  A host
tool: it moves arrays between files and launches nothing on any device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mlic_tpu_torch.models.registry import get_model


# ---------------------------------------------------------------------------
# Layouts: (reference tensor -> port tensor, port tensor -> reference).


def _ident(t):
    return t


def _transpose(t):
    return t.T


def _fusion_to_port(t):
    """[O, C, kh, kw] -> [O, (i * kw + j) * C + c]."""
    o, c, kh, kw = t.shape
    return t.permute(0, 2, 3, 1).reshape(o, kh * kw * c)


def _fusion_to_reference(c: int, k: int):
    def inv(t):
        return t.reshape(t.shape[0], k, k, c).permute(0, 3, 1, 2)
    return inv


IDENT = (_ident, _ident)
GAMMA = (_transpose, _transpose)


def _conv_entry(ref, port, dw):
    """The rows of the port's ``Conv3x3``: depthwise-separable or dense."""
    if dw:
        return [(f"{ref}.{t}_conv.{leaf}", f"{port}.dw.{t}.{leaf}", IDENT)
                for t in ("depth", "point") for leaf in ("weight", "bias")]
    return [(f"{ref}.{leaf}", f"{port}.conv.{leaf}", IDENT)
            for leaf in ("weight", "bias")]


def _plain(ref, port):
    """A Conv2d, Linear or LayerNorm: weight and bias, as they are."""
    return [(f"{ref}.{leaf}", f"{port}.{leaf}", IDENT)
            for leaf in ("weight", "bias")]


def _gdn(ref, port):
    return [(f"{ref}.beta", f"{port}.beta", IDENT),
            (f"{ref}.gamma", f"{port}.gamma", GAMMA)]


def _subpel(ref, port):
    # compressai subpel_conv3x3 = Sequential(Conv2d, PixelShuffle): index 0
    return _plain(f"{ref}.0", f"{port}.conv")


def _res_block(ref, port, dw, with_stride=False, upsample=False):
    if upsample:
        return (_subpel(f"{ref}.subpel_conv", f"{port}.subpel")
                + _conv_entry(f"{ref}.conv", f"{port}.conv", dw)
                + _gdn(f"{ref}.igdn", f"{port}.igdn")
                + _subpel(f"{ref}.upsample", f"{port}.upsample"))
    rows = (_conv_entry(f"{ref}.conv1", f"{port}.conv1", dw)
            + _conv_entry(f"{ref}.conv2", f"{port}.conv2", dw))
    if with_stride:
        rows += _gdn(f"{ref}.gdn", f"{port}.gdn")
        rows += _plain(f"{ref}.skip", f"{port}.skip")
    return rows


# compressai's factorized prior under both naming generations: the older
# (``_matrix0``) is what ``to_reference`` writes
_EB_NEW = ("entropy_bottleneck.matrices", "entropy_bottleneck.biases",
           "entropy_bottleneck.factors")

# Reference keys rebuilt (CDF tables) or constant (lower-bound and
# reparametrization buffers, the Swin index) rather than converted: a key
# holding one of these is no leftover.
_SKIP = ("gaussian_conditional", "_cdf", "_offset", "scale_table", "target",
         "_quantized", "pedestal", ".bound", "QuantOffset",
         "relative_position_index")


def build_mapping(cfg) -> list:
    """[(reference key, port state_dict name, (to port, to reference))]
    for a ``ModelConfig``, the rows of the JAX tool's ``build_mapping``."""
    dw = cfg.depthwise
    enc_dw = dw and not cfg.small_decoder
    c = cfg.slice_ch
    rows = []

    ga = "g_a.analysis_transform"       # analysis.py:6-22
    for k, name, stride in ((0, "rbs0", True), (1, "rb0", False),
                            (2, "rbs1", True), (3, "rb1", False),
                            (4, "rbs2", True), (5, "rb2", False)):
        rows += _res_block(f"{ga}.{k}", f"g_a.{name}", enc_dw, stride)
    rows += _conv_entry(f"{ga}.6", "g_a.out", enc_dw)

    for k, name in zip((0, 2, 4, 6, 8), ("c0", "c1", "c2", "c3", "c4")):
        rows += _conv_entry(f"h_a.reduction.{k}", f"h_a.{name}", enc_dw)

    rows += _conv_entry("h_s.increase.0", "h_s.c0", dw)
    rows += _subpel("h_s.increase.2", "h_s.up0")
    rows += _conv_entry("h_s.increase.4", "h_s.c1", dw)
    rows += _subpel("h_s.increase.6", "h_s.up1")
    rows += _conv_entry("h_s.increase.8", "h_s.c2", dw)

    gs = "g_s.synthesis_transform"      # synthesis.py:56-73
    for k, name in enumerate(("rb0", "up0", "rb1", "up1", "rb2", "up2",
                              "rb3")):
        rows += _res_block(f"{gs}.{k}", f"g_s.{name}", dw,
                           upsample=name.startswith("up"))
    rows += _subpel(f"{gs}.7", "g_s.out")
    # the skips of blocks whose widths differ; absent on both sides where
    # they are equal
    rows += _plain(f"{gs}.0.skip", "g_s.rb0.skip")
    rows += _plain(f"{ga}.0.skip", "g_a.rbs0.skip")

    for k in range(4 + 1):
        pairs = [(f"_matrix{k}", f"matrix_{k}"),
                 (f"matrices.{k}", f"matrix_{k}"),
                 (f"_bias{k}", f"bias_{k}"), (f"biases.{k}", f"bias_{k}")]
        if k < 4:                       # factors between layers only
            pairs += [(f"_factor{k}", f"factor_{k}"),
                      (f"factors.{k}", f"factor_{k}")]
        rows += [(f"entropy_bottleneck.{r}", f"entropy_bottleneck.{p}",
                  IDENT) for r, p in pairs]
    rows.append(("entropy_bottleneck.quantiles",
                 "entropy_bottleneck.quantiles", IDENT))

    w = cfg.context_window
    for i in range(cfg.slice_num):
        lc, pl = f"local_context.{i}", f"local_{i}"
        rows += _plain(f"{lc}.qkv_proj", f"{pl}.qkv")
        rows.append((f"{lc}.relative_position_table",
                     f"{pl}.rel_pos_table", IDENT))
        for sub in ("norm1", "norm2", "proj", "mlp.fc1", "mlp.fc2"):
            rows += _plain(f"{lc}.{sub}", f"{pl}.{sub}")
        rows.append((f"{lc}.fusion.weight", f"{pl}.fusion.weight",
                     (_fusion_to_port, _fusion_to_reference(c, w))))
        rows.append((f"{lc}.fusion.bias", f"{pl}.fusion.bias", IDENT))

        n_lrp = 4 if cfg.small_decoder else 3
        for branch, port in (("lrp_anchor", f"lrp_anchor_{i}"),
                             ("lrp_nonanchor", f"lrp_nonanchor_{i}")):
            for k in range(n_lrp):
                rows += _conv_entry(f"{branch}.{i}.lrp_transform.{2 * k}",
                                    f"{port}.c{k}", dw)
        for branch, port in (("entropy_parameters_anchor", f"ep_anchor_{i}"),
                             ("entropy_parameters_nonanchor",
                              f"ep_nonanchor_{i}")):
            for k in range(4):
                rows += _plain(f"{branch}.{i}.fusion.{2 * k}", f"{port}.c{k}")
        if i == 0:
            continue
        for k in range(3):              # the reference's "fushion" spelling
            rows += _conv_entry(f"channel_context.{i}.fushion.{2 * k}",
                                f"chctx_{i}.c{k}", enc_dw)
        for mod, port, skip in (("global_inter_context", f"ginter_{i}", True),
                                ("global_intra_context", f"gintra_{i}",
                                 False)):
            for qkv in ("queries", "keys", "values"):
                rows += _plain(f"{mod}.{i}.{qkv}.0", f"{port}.{qkv}.pw")
                rows += _plain(f"{mod}.{i}.{qkv}.1", f"{port}.{qkv}.dw")
            rows += _plain(f"{mod}.{i}.reprojection", f"{port}.reprojection")
            for k in range(3):
                rows += _plain(f"{mod}.{i}.mlp.{2 * k}", f"{port}.mlp{k}")
            if skip:
                rows += _plain(f"{mod}.{i}.skip", f"{port}.skip")

    if cfg.vbr:
        rows.append(("Gain", "Gain", IDENT))
        for k in range(3):
            rows += _plain(f"QuantABCD.{2 * k}", f"qabcd_{k}")
        if cfg.vr_entbttlnck:
            # gayn2zqstep Linear(1,10)-ReLU-Linear(10,10)-ReLU-Linear(10,1)
            # -Softplus (reference mlicpp_vbr.py:104-117)
            for k in range(3):
                rows += _plain(f"gayn2zqstep.{2 * k}", f"zqstep_{k}")
    return rows


def _tensor(v) -> torch.Tensor:
    return (v.detach().cpu() if torch.is_tensor(v)
            else torch.from_numpy(np.array(v)))


def convert(state_dict: dict, cfg, strict: bool = False):
    """Reference state_dict (tensors or numpy arrays; ``module.`` prefixes
    stripped) -> (the port's state_dict of f32 CPU tensors, the reference
    keys matched, the leftovers: keys neither matched nor skipped).
    ``strict`` raises on a leftover."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    out, matched = {}, []
    for ref, port, (fwd, _) in build_mapping(cfg):
        if ref in sd:
            t = fwd(_tensor(sd[ref]).float())
            out[port] = t.contiguous().clone()
            matched.append(ref)
    seen = set(matched)
    leftovers = [k for k in sd if k not in seen
                 and not any(s in k for s in _SKIP)]
    if strict and leftovers:
        raise KeyError(f"unconverted reference keys: {leftovers[:10]}")
    return out, matched, leftovers


def to_reference(state_dict: dict, cfg) -> dict:
    """The inverse of ``convert``: the port's state_dict -> a
    reference-style state_dict (compressai's older names for the
    factorized prior), f32 CPU tensors."""
    out = {}
    for ref, port, (_, inv) in build_mapping(cfg):
        if port in state_dict and not ref.startswith(_EB_NEW):
            out[ref] = inv(_tensor(state_dict[port]).float()).contiguous()
    return out


def model_for(name: str, dense: bool):
    """The port's model of configuration ``name`` (dense convolutions
    where ``dense``), zero weights, on the CPU."""
    return get_model(name, **({"depthwise": False} if dense else {}))


def self_test() -> int:
    """Seeded MLICPP_TINY weights -> ``to_reference`` -> ``convert``
    (strict): every tensor back bit for bit.  Returns the tensors
    checked."""
    from mlic_tpu_torch.weights import init_params
    model = get_model("MLICPP_TINY")
    want = init_params(model, torch.Generator().manual_seed(0))
    got, matched, _ = convert(to_reference(want, model.cfg), model.cfg,
                              strict=True)
    if set(got) != set(want):
        raise AssertionError(f"self-test: names differ: missing "
                             f"{sorted(set(want) - set(got))[:6]}, extra "
                             f"{sorted(set(got) - set(want))[:6]}")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"self-test: {len(bad)} tensors differ: "
                             f"{bad[:6]}")
    print(f"self-test OK: {len(want)}/{len(want)} tensors round-trip "
          f"exactly ({len(matched)} reference keys)")
    return len(want)


def main(argv=None) -> dict | None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch-ckpt", help="reference .pth/.pth.tar checkpoint")
    p.add_argument("--model", default="MLICPP_L")
    p.add_argument("--dense", action="store_true",
                   help="published MLIC++ weights use dense convs")
    p.add_argument("--out", help="output torch state_dict file")
    p.add_argument("--strict", action="store_true",
                   help="refuse a reference key that maps nowhere")
    p.add_argument("--self-test", action="store_true")
    args = p.parse_args(argv)
    if args.self_test:
        self_test()
        return None
    if not (args.torch_ckpt and args.out):
        p.error("--torch-ckpt and --out are required")
    ckpt = torch.load(args.torch_ckpt, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    model = model_for(args.model, args.dense)
    state, matched, leftovers = convert(sd, model.cfg, strict=args.strict)
    print(f"converted {len(matched)} tensors; unmapped reference keys: "
          f"{len(leftovers)}")
    if leftovers:
        print("  e.g.", leftovers[:8])
    model.load_state_dict(state, strict=True)
    torch.save(state, args.out)
    print(f"wrote {args.out}: {len(state)} tensors, "
          f"{sum(t.numel() for t in state.values()) / 1e6:.2f} M parameters, "
          f"loaded strictly into {model.cfg.name}"
          + (" (dense)" if args.dense else ""))
    return state


if __name__ == "__main__":
    main()
