"""The benchmark's seeded image generator: photo-like RGBA8 images and clips.

One general generator reads a configuration's `image` and `recipe`
(`configs/<name>.json`):

- a linear gradient between two random end colours at a random angle
  (the gradient frame of the original system's benchmark image);
- `regions` smooth colour regions: Gaussian blobs of a random colour
  offset up to `region_strength`, radius a random share in
  `region_radius` of the long side;
- uniform integer noise in `[-noise, noise]` per channel, then clipped to
  u8; alpha 255.

A clip of `frames` frames is one scene `frame_shift` pixels larger per
frame, each frame a crop shifted by `frame_shift` from the last, so
consecutive frames share most colours, as video frames do. Everything is
drawn on `device` from one `torch.Generator` seeded with the run's seed,
in a few large calls, then copied to the host once.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def scene(height: int, width: int, recipe: dict, gen: torch.Generator, device) -> torch.Tensor:
    """One `[height, width, 3]` uint8 scene on `device` (module docstring)."""
    ends = _uniform(gen, 6, 0.0, 255.0, device).reshape(2, 3)
    angle = float(_uniform(gen, 1, 0.0, 2.0 * math.pi, device))
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None] - height / 2
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :] - width / 2
    half_diag = math.hypot(height, width) / 2
    t = torch.clamp((xs * math.cos(angle) + ys * math.sin(angle)) / half_diag * 0.5 + 0.5, 0, 1)
    img = ends[0] + (ends[1] - ends[0]) * t[..., None]
    lo, hi = recipe["regions"]
    count = int(torch.randint(lo, hi + 1, (1,), generator=gen, device=device))
    if count:
        long_side = max(height, width)
        centre = torch.rand((count, 2), generator=gen, device=device)
        radius = _uniform(gen, count, *recipe["region_radius"], device) * long_side
        offset = _uniform(gen, 3 * count, -1.0, 1.0, device).reshape(count, 3)
        offset = offset * recipe["region_strength"]
        for c in range(count):
            d2 = (ys + height / 2 - centre[c, 0] * height) ** 2 + (
                xs + width / 2 - centre[c, 1] * width) ** 2
            img = img + offset[c] * torch.exp(-d2 / (2 * radius[c] ** 2))[..., None]
    noise = recipe["noise"]
    img = img.round() + torch.randint(-noise, noise + 1, img.shape, generator=gen,
                                      device=device, dtype=torch.int16)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def _rgba(rgb: torch.Tensor) -> np.ndarray:
    out = np.empty(tuple(rgb.shape[:2]) + (4,), np.uint8)
    out[..., :3] = rgb.cpu().numpy()
    out[..., 3] = 255
    return out


def make_item(config: dict, gen: torch.Generator, device):
    """One input of a call: an RGBA `[H, W, 4]` array, or a list of them for
    a clip of more than one frame."""
    shape, recipe = config["image"], config["recipe"]
    h, w, frames = shape["height"], shape["width"], shape.get("frames", 1)
    dx, dy = shape.get("frame_shift", [0, 0])
    full = scene(h + dy * (frames - 1), w + dx * (frames - 1), recipe, gen, device)
    if frames == 1:
        return _rgba(full)
    return [_rgba(full[f * dy:f * dy + h, f * dx:f * dx + w]) for f in range(frames)]


def make_pool(config: dict, size: int, seed: int, device) -> list:
    """`size` inputs drawn from `seed` (module docstring)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [make_item(config, gen, device) for _ in range(size)]


def pixels_of(item) -> int:
    """Output pixels of one call on `item`."""
    frames = item if isinstance(item, list) else [item]
    return sum(f.shape[0] * f.shape[1] for f in frames)
