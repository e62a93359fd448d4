"""Dead-leaves frames made on the device from the run's seed.

The law of ``data/folder.dead_leaves_pool`` in the program (the classic
natural-image surrogate: scale-invariant occlusions, sharp edges): a
uniform background colour, then ``disks`` opaque disks painted in order,
their radii drawn from an inverse-cube law between min(H, W)/64 (at least
2) and min(H, W)/2, their centres uniform, their colours uniform, each
with a faint sinusoidal texture (amplitude up to 0.1, two frequencies up
to 0.3), and Gaussian noise of standard deviation 0.01 over the whole
frame; clipped and truncated to uint8.  Every draw comes from one
``torch.Generator`` on the device seeded with the run's seed, so the same
seed gives the same frames and nothing is rendered on the host or
cached.  A mix names the sizes; every seed gets the same sizes.
"""

from __future__ import annotations

import torch


def _batch(gen, b: int, h: int, w: int, disks: int, device):
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    r_min = max(min(h, w) / 64.0, 2.0)
    r_max = min(h, w) / 2.0
    u = rand(b, disks)
    radii = r_min / torch.sqrt(1.0 - u * (1.0 - (r_min / r_max) ** 2))
    cx, cy = rand(b, disks) * w, rand(b, disks) * h
    # slot ``disks`` is the background: its colour, no texture
    colors = rand(b, disks + 1, 3)
    amp = torch.cat([rand(b, disks) * 0.1, torch.zeros(b, 1, device=device)],
                    1)
    fx = torch.cat([rand(b, disks) * 0.3, torch.zeros(b, 1, device=device)],
                   1)
    fy = torch.cat([rand(b, disks) * 0.3, torch.zeros(b, 1, device=device)],
                   1)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    top = torch.full((b, h, w), disks, dtype=torch.int64, device=device)
    for d in range(disks):
        dx2 = (xs[None, :] - cx[:, d, None]) ** 2            # [b, w]
        dy2 = (ys[None, :] - cy[:, d, None]) ** 2            # [b, h]
        inside = dy2[:, :, None] + dx2[:, None, :] <= (radii[:, d] ** 2)[
            :, None, None]
        top.masked_fill_(inside, d)
    flat = top.reshape(b, -1)

    def pick(t):                                             # [b, h*w]
        return torch.gather(t, 1, flat).reshape(b, h, w)
    tex = pick(amp) * torch.sin(0.5 * (xs[None, None, :] * pick(fx)
                                       + ys[None, :, None] * pick(fy)))
    rgb = torch.stack([pick(colors[..., c]) for c in range(3)], -1)
    img = torch.clamp(rgb + tex[..., None], 0.0, 1.0)
    img = img + 0.01 * torch.randn(img.shape, generator=gen, device=device)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def pool(traffic: dict, seed: int, device) -> torch.Tensor:
    """The mix's pool of distinct batches, uint8 [batches, batch, height,
    width, 3] on ``device``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    b, h, w = (int(traffic[k]) for k in ("batch", "height", "width"))
    disks = int(traffic["disks"])
    return torch.stack([_batch(gen, b, h, w, disks, device)
                        for _ in range(int(traffic["pool_batches"]))])
