"""Perceptual losses: VGG16 features, style (Gram), hinge GAN and the
POELIC rate-distortion loss (port of ``mlic_tpu/perceptual.py``;
reference ``MLIC++/loss/rd_loss.py:101-260`` and ``models/vgg.py:5-37``).

The reference loads torchvision's pretrained VGG16.  No weights are in the
repository and none is fetched: ``Vgg16Features`` starts from the caller's
weights (seeded ones, or those of the JAX package's flax module through
``weights.vgg_from_flax``) unless ``load_torch_vgg16`` is given a local
torchvision checkpoint.  The loss's plumbing and the training step are the
same either way.  The feature extractor is frozen: its parameters take no
gradient and sit in no optimizer.

Images are NHWC in [0, 1] as everywhere in the port's losses; the
features are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlic_tpu_torch.loss import bpp_loss, charbonnier
from mlic_tpu_torch.utils.misc import image_to_patches

# VGG16's convolutions by stage, through relu1_2, relu2_2, relu3_3, relu4_3
VGG_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))
# those convolutions' indexes in torchvision's ``vgg16().features``
TORCHVISION_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


def vgg_conv_names() -> list:
    """``conv{stage}_{index}``, the flax module's names, in order."""
    return [f"conv{s + 1}_{c + 1}" for s, ws in enumerate(VGG_STAGES)
            for c in range(len(ws))]


class Vgg16Features(nn.Module):
    """The first four VGG16 stages (3x3 convolutions with bias, ReLU, 2x2
    max pooling between stages); returns [relu1_2, relu2_2, relu3_3,
    relu4_3].  Frozen: every parameter has ``requires_grad`` False."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, width in zip(vgg_conv_names(),
                               (w for ws in VGG_STAGES for w in ws)):
            setattr(self, name, nn.Conv2d(cin, width, 3, padding=1))
            cin = width
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list:
        """x: [B,H,W,3] -> four NCHW feature maps."""
        x = x.float().permute(0, 3, 1, 2)
        names = iter(vgg_conv_names())
        feats = []
        for si, widths in enumerate(VGG_STAGES):
            for _ in widths:
                x = F.relu(getattr(self, next(names))(x))
            feats.append(x)
            if si < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2)
        return feats


def load_torch_vgg16(vgg: Vgg16Features, state_dict_path: str
                     ) -> Vgg16Features:
    """Load a torchvision VGG16 state_dict file (``features.{i}.weight``
    and ``.bias``) from the local disk into ``vgg``; returns it."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    mapped = {}
    for name, idx in zip(vgg_conv_names(), TORCHVISION_CONV_INDEX):
        mapped[f"{name}.weight"] = sd[f"features.{idx}.weight"]
        mapped[f"{name}.bias"] = sd[f"features.{idx}.bias"]
    vgg.load_state_dict(mapped)
    return vgg


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> normalized Gram [B,C,C] (StyleLoss,
    ``rd_loss.py:180-196``)."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (h * w * c)


def style_loss(feats_a, feats_b) -> torch.Tensor:
    return sum(torch.mean(torch.square(gram_matrix(a) - gram_matrix(b)))
               for a, b in zip(feats_a, feats_b))


def perceptual_l2(feats_a, feats_b) -> torch.Tensor:
    """Unit-normalized feature distance over channels (LPIPS-style,
    unweighted)."""
    total = 0.0
    for a, b in zip(feats_a, feats_b):
        an = a * torch.rsqrt(torch.sum(torch.square(a), 1, keepdim=True)
                             + 1e-10)
        bn = b * torch.rsqrt(torch.sum(torch.square(b), 1, keepdim=True)
                             + 1e-10)
        total = total + torch.mean(torch.square(an - bn))
    return total


def gan_loss_hinge(logits: torch.Tensor, target_is_real: bool,
                   for_discriminator: bool = True) -> torch.Tensor:
    """Hinge GAN loss (``rd_loss.py:101-177``, 'hinge' mode)."""
    if for_discriminator:
        if target_is_real:
            return torch.mean(F.relu(1.0 - logits))
        return torch.mean(F.relu(1.0 + logits))
    return -torch.mean(logits)


def rate_distortion_poelic_loss(output: dict, target: torch.Tensor, lmbda,
                                vgg: Vgg16Features,
                                style_weight: float = 100.0) -> dict:
    """Perceptual RD loss (``rd_loss.py:199-260``): lambda * 255^2 *
    Charbonnier + the feature distance + ``style_weight`` * style over
    16x16 patches + bpp."""
    b, h, w, _ = target.shape
    out = {"bpp_loss": bpp_loss(output["likelihoods"], b * h * w)}
    x_hat = output["x_hat"]
    out["charbonnier_loss"] = charbonnier(x_hat, target)
    out["perceptual_loss"] = perceptual_l2(vgg(x_hat), vgg(target))
    out["style_loss"] = style_loss(vgg(image_to_patches(x_hat, 16)),
                                   vgg(image_to_patches(target, 16)))
    out["loss"] = (lmbda * 255.0 ** 2 * out["charbonnier_loss"]
                   + out["perceptual_loss"] + style_weight * out["style_loss"]
                   + out["bpp_loss"])
    return out
