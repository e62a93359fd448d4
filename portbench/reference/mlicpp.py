"""The plain reference of MLIC++ (arXiv:2307.15421), in float32 PyTorch.

The published architecture as the LuZWCHA/MLIC fork configures it
(``MLIC++/config/config.py``; depthwise-separable 3x3 convolutions,
``modules/layers/conv.py``): the analysis g_a and hyper-analysis h_a, the
hyper-synthesis h_s, per slice of the latent the checkerboard pair of
phases with the channel context, the linear global inter- and
intra-slice contexts, the local window attention (MEM++), the entropy
parameters and the latent residual prediction (LRP), and the synthesis
g_s.  It works on a flat dict of parameters named by their paths in the
checkpoint (``g_a/rbs0/conv1/dw/depth/kernel``), laid out as PyTorch takes
them, and imports nothing of the program under test.

Every product (convolution, linear layer, attention contraction, GDN's
norm) passes its operands through the ``Precision`` the reference was
made with: the identity for the reference itself (float32, TF32 off), or
a lower precision for the control that a comparison must fail.

The local context is written in its plain windowed form (each position's
5x5 window of queries, keys and values, ``unfold``), the same arithmetic
the program computes by shifted correlations.

The rate is estimated as the fork's codec codes it: z's bits under the
factorized prior (``entropy_bottleneck``, every likelihood at least
1e-9), each y symbol's under its row of the fork's Gaussian tables
(``gaussian_rows``): the scale rounded up to the table of 64 scales
(``SCALE_TABLE``), the integers within the row's width of the mean with
their Gaussian masses over +-1/2 and the tails' mass in an escape slot,
quantized to 16-bit frequencies of at least 1.  An escaped symbol costs
its slot; the value it escapes with is not counted.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.orbax import read_orbax

FP8_MAX = 448.0                 # largest finite float8 e4m3
SCALE_BOUND = 0.11              # the fork's GaussianConditional
LIKELIHOOD_BOUND = 1e-9
# the fork's scale table (MLIC++/utils/func.py:16-19): 64 log-spaced
# scales from 0.11 to 256
SCALE_TABLE = np.exp(np.linspace(np.log(0.11), np.log(256.0), 64))
TAIL_MASS = 1e-9                # a row's mass beyond its width
PRECISION = 16                  # bits of a row's frequencies


def gaussian_rows(device) -> tuple:
    """The coder's rows, one a scale of ``SCALE_TABLE``: (bits [64, W + 1]
    float64, each symbol's cost, the escape slot's at index ``width``,
    width [64] int64, center [64] int64): row r codes the integers
    -center..center as indexes 0..width-1 (width = 2 center + 1, center =
    ceil(scale * z) with P(|X| > z scale) = 1e-9).  Each symbol's
    frequency is 1 plus its share of the remaining 2^16 - width - 1
    counts, rounded down; what rounding leaves goes to the row's largest
    symbol."""
    f64 = torch.float64
    sc = torch.tensor(SCALE_TABLE, dtype=f64, device=device)
    z = -torch.special.ndtri(torch.tensor(TAIL_MASS / 2, dtype=f64))
    center = torch.ceil(sc * z.to(device)).long()
    width = 2 * center + 1
    n = int(width.max()) + 1
    k = torch.arange(n, device=device)
    a = torch.abs(k[None, :] - center[:, None]).to(f64)

    def cdf(t):
        return 0.5 * torch.erfc(-t / 2.0 ** 0.5)
    pmf = cdf((0.5 - a) / sc[:, None]) - cdf((-0.5 - a) / sc[:, None])
    tail = 2.0 * cdf((-0.5 - center.to(f64)) / sc)
    inside = k[None, :] < width[:, None]
    pmf = torch.where(inside, pmf, torch.zeros_like(pmf))
    pmf.scatter_(1, width[:, None], tail[:, None])        # the escape slot
    used = inside | (k[None, :] == width[:, None])
    pmf = pmf / pmf.sum(1, keepdim=True)
    spare = (1 << PRECISION) - (width + 1)
    freq = torch.where(used, 1 + torch.floor(pmf * spare[:, None].to(f64)),
                       torch.zeros_like(pmf))
    left = (1 << PRECISION) - freq.sum(1)
    freq[torch.arange(64, device=device), center] += left
    bits = -torch.log2(torch.clamp(freq, min=1.0) / float(1 << PRECISION))
    return bits, width, center


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude onto the format's largest), back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 explicit mantissa bits, to nearest even,
    as the tensor cores read a float32 operand with TF32 on."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """The rounding of the operands of every product: ``transforms`` for
    g_a, h_a and g_s, ``entropy`` for h_s, the contexts, the entropy
    parameters and LRP."""

    def __init__(self, transforms=identity, entropy=identity):
        self.transforms, self.entropy = transforms, entropy


FLOAT32 = Precision()
# the configuration states bfloat16 transforms and a float32 entropy path
# with TF32 off; the control is the next precision below each
CONTROL = Precision(transforms=fp8, entropy=tf32)


def load_params(ckpt_dir: str, device) -> dict:
    """A checkpoint directory -> {path: float32 tensor on ``device``}:
    convolution kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    LayerNorm ``scale`` as it is."""
    tree = read_orbax(ckpt_dir)
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[prefix + k] = torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
    walk(tree, "")
    return out


def gelu(x):
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------- checkerboard
def ckbd_mask(h: int, w: int, device) -> torch.Tensor:
    """1 at the anchor positions, (row + column) odd."""
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return ((r + c) % 2 == 1).float()


def anchor(y):
    return y * ckbd_mask(y.shape[-2], y.shape[-1], y.device)


def nonanchor(y):
    return y * (1.0 - ckbd_mask(y.shape[-2], y.shape[-1], y.device))


def _rows(even, odd):
    *lead, h2, w2 = even.shape
    return torch.stack([even, odd], -2).reshape(*lead, 2 * h2, w2)


def anchor_squeeze(y):
    return _rows(y[..., 0::2, 1::2], y[..., 1::2, 0::2])


def nonanchor_squeeze(y):
    return _rows(y[..., 0::2, 0::2], y[..., 1::2, 1::2])


def _spread(d, zeros_first: bool):
    z = torch.zeros_like(d)
    *lead, h2, w2 = d.shape
    return torch.stack([z, d] if zeros_first else [d, z], -1).reshape(
        *lead, h2, 2 * w2)


def anchor_unsqueeze(a):
    return _rows(_spread(a[..., 0::2, :], True), _spread(a[..., 1::2, :],
                                                         False))


def nonanchor_unsqueeze(a):
    return _rows(_spread(a[..., 0::2, :], False), _spread(a[..., 1::2, :],
                                                          True))


PHASES = {"anchor": (anchor, anchor_squeeze, anchor_unsqueeze),
          "nonanchor": (nonanchor, nonanchor_squeeze, nonanchor_unsqueeze)}


# ------------------------------------------------------------- the model
class MLICPP:
    """MLIC++ on a parameter dict.  ``cfg`` holds N, M, slice_num and
    context_window (the configuration file's ``model``)."""

    def __init__(self, params: dict, cfg: dict,
                 precision: Precision = FLOAT32):
        self.p = params
        self.N, self.M = int(cfg["N"]), int(cfg["M"])
        self.S = int(cfg["slice_num"])
        self.C = self.M // self.S
        self.win = int(cfg.get("context_window", 5))
        self.prec = precision

    # ------------------------------------------------------- products
    def conv(self, x, name, q, stride=1, groups=1):
        w, b = self.p[name + "/kernel"], self.p[name + "/bias"]
        return F.conv2d(q(x), q(w), b, stride, w.shape[-1] // 2,
                        groups=groups)

    def pointwise(self, x, name, q, stride=1):
        if stride != 1:
            x = x[..., ::stride, ::stride]
        return self.conv(x, name, q)

    def depthwise(self, x, name, q, stride=1):
        return self.conv(x, name, q, stride, groups=x.shape[1])

    def conv3x3(self, x, name, q, stride=1):
        """The fork's conv3x3: a 3x3 depthwise then a 1x1 pointwise."""
        x = self.depthwise(x, name + "/dw/depth", q, stride)
        return self.pointwise(x, name + "/dw/point", q)

    def subpel(self, x, name, q, r=2):
        return F.pixel_shuffle(self.conv(x, name + "/conv", q), r)

    def linear(self, x, name, q):
        return F.linear(q(x), q(self.p[name + "/kernel"]),
                        self.p[name + "/bias"])

    def gdn(self, x, name, q, inverse=False):
        """GDN: x / sqrt(beta + sum_d gamma[d, c] x_d^2), its parameters
        reparametrised as compressai's lower bounds do."""
        ped = (2.0 ** -18) ** 2
        beta = torch.clamp(self.p[name + "/beta"],
                           min=(1e-6 + ped) ** 0.5) ** 2 - ped
        gamma = torch.clamp(self.p[name + "/gamma"], min=ped ** 0.5) ** 2 \
            - ped
        norm = F.conv2d(q(x * x), q(gamma.t()[:, :, None, None])) \
            + beta[:, None, None]
        return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))

    # ------------------------------------------------------ transforms
    def _res_stride(self, x, name, q):
        mid = self.conv3x3(x, name + "/conv1", q, 2)
        skip = self.pointwise(x, name + "/skip", q, 2)
        return self.gdn(self.conv3x3(gelu(mid), name + "/conv2", q),
                        name + "/gdn", q) + skip

    def _res(self, x, name, q):
        mid = self.conv3x3(x, name + "/conv1", q)
        if name + "/skip/kernel" in self.p:
            x = self.pointwise(x, name + "/skip", q)
        return gelu(self.conv3x3(gelu(mid), name + "/conv2", q)) + x

    def _res_up(self, x, name, q):
        mid = self.subpel(x, name + "/subpel", q)
        skip = self.subpel(x, name + "/upsample", q)
        return self.gdn(self.conv3x3(gelu(mid), name + "/conv", q),
                        name + "/igdn", q, inverse=True) + skip

    def g_a(self, x):
        """Images [B, 3, H, W] in [0, 1] -> y [B, M, H/16, W/16]."""
        q = self.prec.transforms
        for i in range(3):
            x = self._res(self._res_stride(x, f"g_a/rbs{i}", q),
                          f"g_a/rb{i}", q)
        return self.conv3x3(x, "g_a/out", q, 2)

    def h_a(self, y):
        q = self.prec.transforms
        for i, s in enumerate((1, 1, 2, 1)):
            y = gelu(self.conv3x3(y, f"h_a/c{i}", q, s))
        return self.conv3x3(y, "h_a/c4", q, 2)

    def h_s(self, z_hat):
        q = self.prec.entropy
        x = gelu(self.conv3x3(z_hat, "h_s/c0", q))
        x = gelu(self.subpel(x, "h_s/up0", q))
        x = gelu(self.conv3x3(x, "h_s/c1", q))
        x = gelu(self.subpel(x, "h_s/up1", q))
        return self.conv3x3(x, "h_s/c2", q)

    def g_s(self, y_hat):
        q = self.prec.transforms
        x = y_hat
        for i in range(4):
            x = self._res(x, f"g_s/rb{i}", q)
            if i < 3:
                x = self._res_up(x, f"g_s/up{i}", q)
        return self.subpel(x, "g_s/out", q)

    def medians(self):
        return self.p["entropy_bottleneck/quantiles"][:, 0, 1]

    # -------------------------------------------------------- contexts
    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + "/scale"],
                            self.p[name + "/bias"], 1e-6)

    def local_context(self, x, idx):
        """Window attention over the anchor half x [B, C, H, W] ->
        [B, 2C, H, W]: each position's win x win window of queries
        attends to the same window's keys, only between anchor positions
        inside the image (others get -100), with a relative-position
        bias; the attended window is fused by a dense layer."""
        q_ = self.prec.entropy
        name = f"local_{idx}"
        b, c, h, w = x.shape
        win, heads = self.win, 2
        hd, ws2, L = c // heads, self.win ** 2, h * w
        t = x.permute(0, 2, 3, 1)
        qkv = self.linear(self.layer_norm(t, name + "/norm1"),
                          name + "/qkv", q_)
        q, k, v = qkv.split(c, -1)

        def windows(f):          # [B, H, W, c] -> [B, L, ws2, c]
            u = F.unfold(f.permute(0, 3, 1, 2), win, padding=win // 2)
            return u.reshape(b, f.shape[-1], ws2, L).permute(0, 3, 2, 1)

        def heads_of(f):         # [B, L, ws2, c] -> [B, L, heads, ws2, hd]
            return f.reshape(b, L, ws2, heads, hd).transpose(2, 3)

        qw = heads_of(windows(q * hd ** -0.5))
        kw, vw = heads_of(windows(k)), heads_of(windows(v))
        attn = torch.matmul(q_(qw), q_(kw).transpose(-1, -2))
        coords = np.stack(np.meshgrid(np.arange(win), np.arange(win),
                                      indexing="ij")).reshape(2, -1)
        rel = coords[:, :, None] - coords[:, None, :] + (win - 1)
        rel_idx = torch.from_numpy(rel[0] * (2 * win - 1) + rel[1]).to(
            x.device)
        bias = self.p[name + "/rel_pos_table"][rel_idx.reshape(-1)]
        attn = attn + bias.reshape(ws2, ws2, heads).permute(2, 0, 1)
        a = F.unfold(ckbd_mask(h, w, x.device)[None, None], win,
                     padding=win // 2)[0].t()                # [L, ws2]
        attn = attn + (-100.0 * (1.0 - a[:, :, None] * a[:, None, :]))[
            None, :, None]
        out = torch.matmul(q_(torch.softmax(attn, -1)), q_(vw))
        out = out.transpose(2, 3).reshape(b, L, ws2 * c)
        out = self.linear(self.linear(out, name + "/fusion", q_),
                          name + "/proj", q_)
        mlp = self.linear(gelu(self.linear(
            self.layer_norm(out, name + "/norm2"), name + "/mlp/fc1", q_)),
            name + "/mlp/fc2", q_)
        return (out + mlp).reshape(b, h, w, 2 * c).permute(0, 3, 1, 2)

    def channel_context(self, prev, idx):
        q = self.prec.entropy
        x = gelu(self.conv3x3(prev, f"chctx_{idx}/c0", q))
        x = gelu(self.conv3x3(x, f"chctx_{idx}/c1", q))
        return self.conv3x3(x, f"chctx_{idx}/c2", q)

    def _qkv(self, x, name, q):
        return self.depthwise(self.pointwise(x, name + "/pw", q),
                              name + "/dw", q)

    def _linear_attention(self, qs, ks, vs, heads):
        """softmax over space of the keys, their product with the values,
        times the queries' softmax over each head's channels; tokens
        [B, n, c]."""
        q_ = self.prec.entropy
        b, n, c = qs.shape
        hd = c // heads
        qs = torch.softmax(qs.reshape(b, n, heads, hd), 3)
        ks = torch.softmax(ks.reshape(b, n, heads, hd), 1)
        vs = vs.reshape(b, n, heads, hd)
        ctx = torch.einsum("bnhd,bnhe->bhde", q_(ks), q_(vs))
        return torch.einsum("bhde,bnhd->bnhe", q_(ctx), q_(qs)).reshape(
            b, n, c)

    @staticmethod
    def _tokens(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])

    def _mlp_tail(self, att, name, q):
        return self.pointwise(gelu(self.depthwise(gelu(self.pointwise(
            att, name + "/mlp0", q)), name + "/mlp1", q)), name + "/mlp2", q)

    def inter_context(self, prev, idx):
        q = self.prec.entropy
        name = f"ginter_{idx}"
        b, c, h, w = prev.shape
        heads = max(c // 32, 1)
        att = self._linear_attention(
            self._tokens(self._qkv(prev, name + "/queries", q)),
            self._tokens(self._qkv(prev, name + "/keys", q)),
            self._tokens(self._qkv(prev, name + "/values", q)), heads)
        att = self.conv(att.reshape(b, h, w, c).permute(0, 3, 1, 2),
                        name + "/reprojection", q)
        return self.pointwise(att, name + "/skip", q) + self._mlp_tail(
            att, name, q)

    def intra_context(self, prev, slice_anchor, idx):
        q = self.prec.entropy
        name = f"gintra_{idx}"
        b, c, h, w = prev.shape
        qs = self._tokens(nonanchor_squeeze(self._qkv(
            nonanchor(prev), name + "/queries", q)))
        ks = self._tokens(anchor_squeeze(self._qkv(
            anchor(prev), name + "/keys", q)))
        vs = self._tokens(anchor_squeeze(self._qkv(
            slice_anchor, name + "/values", q)))
        att = self._linear_attention(qs, ks, vs, 2)
        att = nonanchor_unsqueeze(att.reshape(b, h, w // 2, c).permute(
            0, 3, 1, 2))
        att = self.conv(att, name + "/reprojection", q)
        return att + self._mlp_tail(att, name, q)

    def entropy_parameters(self, x, name):
        q = self.prec.entropy
        for i in range(3):
            x = gelu(self.pointwise(x, f"{name}/c{i}", q))
        return self.pointwise(x, f"{name}/c3", q)

    def lrp(self, x, name):
        q = self.prec.entropy
        for i in range(3):
            if i:
                x = gelu(x)
            x = self.conv3x3(x, f"{name}/c{i}", q)
        return 0.5 * torch.tanh(x)

    # ------------------------------------------------------ slice loop
    def slices(self, hyper, take):
        """The slice loop.  ``take(idx, phase, mu_sq, sc_sq, lrp_of)``
        gives a phase's values: ``mu_sq`` and ``sc_sq`` its squeezed means
        and scales, ``lrp_of(pre)`` the LRP correction (masked to the
        phase) of the unsqueezed values ``pre``; it returns (pre,
        correction).  Returns y_hat."""
        M = self.M
        hyper_means = hyper[:, M:]
        done = []
        for idx in range(self.S):
            prev = torch.cat(done, 1) if done else None
            parts = [hyper]
            if idx:
                inter = self.inter_context(prev, idx)
                chctx = self.channel_context(prev, idx)
                parts = [inter, chctx, hyper]
            scales, means = self.entropy_parameters(
                torch.cat(parts, 1), f"ep_anchor_{idx}").split(self.C, 1)

            def lrp_anchor(pre):
                return anchor(self.lrp(torch.cat([hyper_means] + done
                                                 + [pre], 1),
                                       f"lrp_anchor_{idx}"))
            pre, corr = take(idx, "anchor", anchor_squeeze(means),
                             anchor_squeeze(scales), lrp_anchor)
            slice_anchor = pre + corr
            local = self.local_context(slice_anchor, idx)
            if idx:
                intra = self.intra_context(done[-1], slice_anchor, idx)
                parts = [local, intra, inter, chctx, hyper]
            else:
                parts = [local, hyper]
            scales, means = self.entropy_parameters(
                torch.cat(parts, 1), f"ep_nonanchor_{idx}").split(self.C, 1)

            def lrp_nonanchor(pre):
                return nonanchor(self.lrp(torch.cat(
                    [hyper_means] + done + [pre + slice_anchor], 1),
                    f"lrp_nonanchor_{idx}"))
            pre, corr = take(idx, "nonanchor", nonanchor_squeeze(means),
                             nonanchor_squeeze(scales), lrp_nonanchor)
            done.append(pre + slice_anchor + corr)
        return torch.cat(done, 1)

    def count_flops(self, batch: int, height: int, width: int) -> dict:
        """Operations of ``batch`` frames of height x width by
        ``FlopCounterMode`` over this reference on the meta device: {"g_a_h_a":
        the encoder's transforms, "g_s": the decoder's, "entropy": h_s and
        the slice loop, which each direction runs once}."""
        from torch.utils.flop_counter import FlopCounterMode
        meta = {k: torch.empty(v.shape, device="meta")
                for k, v in self.p.items()}
        m = MLICPP(meta, {"N": self.N, "M": self.M, "slice_num": self.S,
                          "context_window": self.win})
        x = torch.zeros((batch, 3, height, width), device="meta")
        out = {}
        with torch.no_grad():
            with FlopCounterMode(display=False) as fc:
                y = m.g_a(x)
                z = m.h_a(y)
            out["g_a_h_a"] = fc.get_total_flops()
            with FlopCounterMode(display=False) as fc:
                m.g_s(y)
            out["g_s"] = fc.get_total_flops()

            def take(idx, phase, mu_sq, sc_sq, lrp_of):
                pre = PHASES[phase][2](mu_sq)
                return pre, lrp_of(pre)
            with FlopCounterMode(display=False) as fc:
                m.slices(m.h_s(torch.zeros_like(z)), take)
            out["entropy"] = fc.get_total_flops()
        return out

    # ---------------------------------------------------------- coding
    def analyze(self, x_uint8_nhwc):
        """uint8 frames [B, H, W, 3] -> (y, z) float32, NCHW."""
        x = x_uint8_nhwc.permute(0, 3, 1, 2).float() / 255.0
        y = self.g_a(x)
        return y, self.h_a(y)

    def z_hat(self, z):
        med = self.medians()[None, :, None, None]
        return torch.round(z - med) + med

    def encode(self, y, z_hat):
        """The encoder's y_hat: each phase's symbols round(y - mu)."""
        def take(idx, phase, mu_sq, sc_sq, lrp_of):
            _, squeeze, unsqueeze = PHASES[phase]
            ys = squeeze(y[:, idx * self.C:(idx + 1) * self.C])
            pre = unsqueeze(torch.round(ys - mu_sq) + mu_sq)
            return pre, lrp_of(pre)
        return self.slices(self.h_s(z_hat), take)

    def z_bits(self, z_hat):
        """Bits of z_hat [B, N, h, w] (on the medians' grid) under the
        factorized prior: per channel a monotone cumulative of logits
        (softplus matrices, biases, tanh factors), the likelihood of each
        value the difference of the cumulative at +-1/2."""
        pre = "entropy_bottleneck/"
        n = z_hat.shape[1]
        v = z_hat.permute(1, 0, 2, 3).reshape(n, 1, -1)

        def logits(x):
            k = 0
            while pre + f"matrix_{k}" in self.p:
                x = torch.matmul(F.softplus(self.p[pre + f"matrix_{k}"]), x) \
                    + self.p[pre + f"bias_{k}"]
                if pre + f"factor_{k}" in self.p:
                    x = x + torch.tanh(self.p[pre + f"factor_{k}"]) \
                        * torch.tanh(x)
                k += 1
            return x
        lower, upper = logits(v - 0.5), logits(v + 0.5)
        sign = -torch.sign(lower + upper)
        lk = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(
            sign * lower))
        return float(-torch.log2(torch.clamp(lk, min=LIKELIHOOD_BOUND)).sum())

    @staticmethod
    def table_row(scales):
        """Each scale's row: the smallest entry of ``SCALE_TABLE`` that
        holds it (at least 0.11), the table's last above its range."""
        t = torch.tensor(SCALE_TABLE, dtype=scales.dtype,
                         device=scales.device)
        return torch.searchsorted(t[:-1].contiguous(), torch.clamp(
            scales, min=SCALE_BOUND).contiguous())

    def coded_y_bits(self, sym, scales):
        """Bits of the symbols ``sym`` (values less their means) in the
        rows of their ``scales``; an escape costs its slot."""
        if getattr(self, "_rows", None) is None:
            self._rows = gaussian_rows(sym.device)
        bits, width, center = self._rows
        row = self.table_row(scales)
        v = sym.long() + center[row]
        v = torch.where((v < 0) | (v >= width[row]), width[row], v)
        return float(bits[row, v].sum())

    @staticmethod
    def y_bits(sym, scales):
        """Bits of the symbols ``sym`` (values less their means) under
        zero-mean Gaussians of ``scales``."""
        s = torch.clamp(scales, min=SCALE_BOUND)
        a = torch.abs(sym)

        def cdf(t):
            return 0.5 * torch.erfc(-t / 2.0 ** 0.5)
        lk = cdf((0.5 - a) / s) - cdf((-0.5 - a) / s)
        return float(-torch.log2(torch.clamp(lk, min=LIKELIHOOD_BOUND)).sum())

    def follow(self, y_hat_prog, z_hat, y=None):
        """Decode after a coded y_hat: each phase's symbols are recovered
        from ``y_hat_prog`` (its values less this reference's means and
        LRP correction, rounded), and y_hat is rebuilt from them with this
        reference's arithmetic.  Returns (y_hat, symbols that differ from
        round(y - mu) of the latent ``y`` or None without it, symbols,
        estimated bits of z_hat and the symbols)."""
        flips = torch.zeros((), dtype=torch.int64, device=y_hat_prog.device)
        count = 0
        bits = self.z_bits(z_hat)

        def take(idx, phase, mu_sq, sc_sq, lrp_of):
            nonlocal flips, count, bits
            _, squeeze, unsqueeze = PHASES[phase]
            sl = slice(idx * self.C, (idx + 1) * self.C)
            target = squeeze(y_hat_prog[:, sl])
            sym = torch.round(target - mu_sq)
            pre = unsqueeze(sym + mu_sq)
            corr = lrp_of(pre)
            again = torch.round(target - mu_sq - squeeze(corr))
            if not torch.equal(again, sym):
                sym = again
                pre = unsqueeze(sym + mu_sq)
                corr = lrp_of(pre)
            if y is not None:
                ana = torch.round(squeeze(y[:, sl]) - mu_sq)
                flips = flips + (ana != sym).sum()
            count += sym.numel()
            bits += self.coded_y_bits(sym, sc_sq)
            return pre, corr
        y_hat = self.slices(self.h_s(z_hat), take)
        return y_hat, (None if y is None else flips), count, bits
