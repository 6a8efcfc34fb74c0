"""The benchmark's plain reference: what `reduce` and `reduce_images` of a
k-means quantizer under CIE94 give, recomputed from the input pixels alone.

`reduce(rgba, k, mode, train_max_size)`: shrink the image to the training
size (the long side capped at `train_max_size`; None trains on every
pixel), convert to Lab, seed, run Lloyd, then recolour every pixel of the
full image with the trained palette. `reduce_images(frames, ...)` does the
same for frames of one size, each with its own palette. Both return uint8
RGBA on `device`.

Plain PyTorch and numpy only: it imports nothing of the program under test
and takes nothing it made. On a CUDA device run it with TF32 off
(`run.py` does); its float32 matrix products are none anyway, the sums
being float64. `lowp=True` computes it one precision below the stated
float32: the control that a correct comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import kmeans, output
from gpubench.reference.colour import shrink_u8, shrunk_size, srgb8_to_lab, srgb8_to_lab_folded

LOWP_DTYPE = torch.bfloat16


def _train_rgb(rgb: torch.Tensor, train_max_size):
    """`[..., H, W, 3]` uint8 -> `([..., N, 3]` training u8, shrunk width,
    shrunk height)."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    sw, sh = shrunk_size(w, h, train_max_size)
    if (sh, sw) != (h, w):
        rgb = shrink_u8(rgb, sh, sw)
    return rgb.reshape(*rgb.shape[:-3], -1, 3), sw, sh


def train(rgb: torch.Tensor, k: int, train_max_size, lowp: bool = False):
    """Palette `[k, 3]` Lab of one `[H, W, 3]` uint8 image and its steps."""
    flat, sw, sh = _train_rgb(rgb, train_max_size)
    pixels = srgb8_to_lab(flat)
    space, inline = srgb8_to_lab_folded(flat, inline=True)
    if lowp:
        pixels, space, inline = pixels.to(LOWP_DTYPE), space.to(LOWP_DTYPE), None
    cents = kmeans.seed(pixels, k, kmeans.first_seed_index(sw, sh), space, inline)
    return kmeans.lloyd(pixels, cents)


def train_batched(frames: torch.Tensor, k: int, train_max_size, lowp: bool = False):
    """Palettes `[B, k, 3]` of `[B, H, W, 3]` uint8 frames, one each, and
    the steps of each."""
    flat, sw, sh = _train_rgb(frames, train_max_size)
    pixels = srgb8_to_lab(flat)
    space = srgb8_to_lab_folded(flat)
    if lowp:
        pixels, space = pixels.to(LOWP_DTYPE), space.to(LOWP_DTYPE)
    cents = kmeans.seed_batched(pixels, k, kmeans.first_seed_index(sw, sh), space)
    return kmeans.lloyd_batched(pixels, cents)


def _rgb_on(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(array)[..., :3])).to(device)


def reduce(rgba: np.ndarray, k: int, mode: str, train_max_size, device,
           lowp: bool = False, details: dict | None = None) -> torch.Tensor:
    """`[H, W, 4]` uint8 output of one image (module docstring); `details`,
    when given, receives the Lloyd steps under `"steps"`."""
    rgb = _rgb_on(rgba, device)
    palette, steps = train(rgb, k, train_max_size, lowp)
    if details is not None:
        details["steps"] = steps
    threshold = output.dither_threshold(palette[None])[0] if mode == "dither" else None
    return output.rgba(rgb, palette, mode, threshold, lowp)


def reduce_images(frames, k: int, mode: str, train_max_size, device,
                  lowp: bool = False, details: dict | None = None) -> torch.Tensor:
    """`[B, H, W, 4]` uint8 outputs of same-sized frames; `details` as in
    `reduce`, the longest member's steps."""
    rgb = _rgb_on(np.stack(frames), device)
    palettes, steps = train_batched(rgb, k, train_max_size, lowp)
    if details is not None:
        details["steps"] = int(steps.max())
    thresholds = output.dither_threshold(palettes) if mode == "dither" else None
    return torch.stack([
        output.rgba(rgb[b], palettes[b], mode, None if thresholds is None else thresholds[b],
                    lowp)
        for b in range(rgb.shape[0])])


CALLS = {"reduce": reduce, "reduce_images": reduce_images}
