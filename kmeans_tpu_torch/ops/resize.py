"""Bilinear shrink with the reference's sampler convention, in PyTorch.

Port of `kmeans_tpu/ops/resize.py`: the training image is sampled at the
normalised coordinate `(x / W_out, y / H_out)`, the corner of each output
texel, with a linear filter and clamp-to-edge, and the shrink policy caps
the long side and scales the short side with truncation (minimum 1).
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops._math import const, div


def shrunk_dimensions(
    width: int, height: int, max_size: int | None
) -> tuple[int, int]:
    """New `(width, height)` after capping the long side at `max_size`
    (kmeans_tpu/ops/resize.py:22). `None` keeps the full size."""
    if max_size is None or (width <= max_size and height <= max_size):
        return width, height
    if width > height:
        return max_size, max(int(height * max_size / width), 1)
    return max(int(width * max_size / height), 1), max_size


def _axis_weights(n_out: int, n_in: int, device):
    # Continuous source coordinate of each output sample, in texels.
    pos = torch.arange(n_out, dtype=torch.float32, device=device)
    coord = torch.div(pos, const(n_out, pos)) * n_in - 0.5
    i0 = torch.floor(coord)
    frac = coord - i0
    lo = torch.clamp(i0.to(torch.int64), 0, n_in - 1)
    hi = torch.clamp(i0.to(torch.int64) + 1, 0, n_in - 1)
    return lo, hi, frac


def _blend(top, bot, x0, x1, fx, fy):
    fy = fy[:, None, None]
    rows = top * (1.0 - fy) + bot * fy
    fx = fx[None, :, None]
    return rows[..., x0, :] * (1.0 - fx) + rows[..., x1, :] * fx


def resize_bilinear(
    image: torch.Tensor, new_height: int, new_width: int
) -> torch.Tensor:
    """Resize float `image[H, W, C]` to `[new_height, new_width, C]`
    (corner-aligned, clamp-to-edge; kmeans_tpu/ops/resize.py:85)."""
    h, w = image.shape[0], image.shape[1]
    y0, y1, fy = _axis_weights(new_height, h, image.device)
    x0, x1, fx = _axis_weights(new_width, w, image.device)
    return _blend(image[y0], image[y1], x0, x1, fx, fy)


def resize_uint8(
    image_u8: torch.Tensor, new_height: int, new_width: int
) -> torch.Tensor:
    """uint8 `[..., H, W, C]` resize through the unorm float path, rounded
    back to uint8 (kmeans_tpu/ops/resize.py:114); leading axes are frames,
    each resized as alone. The sampled rows are gathered in uint8 before
    the elementwise unorm conversion, which gives the same bits as
    converting the whole image first and touches only those rows."""
    h, w = image_u8.shape[-3], image_u8.shape[-2]
    y0, y1, fy = _axis_weights(new_height, h, image_u8.device)
    x0, x1, fx = _axis_weights(new_width, w, image_u8.device)
    top = div(image_u8[..., y0, :, :].to(torch.float32), 255.0)
    bot = div(image_u8[..., y1, :, :].to(torch.float32), 255.0)
    out = _blend(top, bot, x0, x1, fx, fy)
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
