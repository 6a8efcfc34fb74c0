"""The output pass, in plain PyTorch: each pixel's palette index under
replace or 4x4 Bayer dither, and the RGBA8 image those indices give.

- replace: the nearest centroid by CIE94, the pixel first, the first
  minimum winning.
- dither: the threshold is a greedy estimate of the palette's largest
  pairwise distance over sqrt(k): start from entries 0 and 1, and for each
  later entry `c` (in order) with `da = d(c, a)`, `db = d(c, b)`: if `da >
  db` and `da > d(a, b)` it replaces b; else if `db > d(a, b)` it replaces
  a. The pixel's Lab moves by `threshold * (M[y % 4][x % 4] / 16 - 0.5)`
  on L, a and b alike, and takes the centroid nearest to that.
- The image: the palette's u8 sRGB (`colour.lab_to_srgb8`) at each index,
  alpha 255 (the input's alpha is ignored).
"""

from __future__ import annotations

import torch

from gpubench.reference.colour import div, lab_to_srgb8, srgb8_to_lab
from gpubench.reference.kmeans import d2_cie94, dist_cie94

BAYER_4X4 = ((0, 8, 2, 10), (12, 4, 14, 6), (3, 11, 1, 9), (15, 7, 13, 5))
BLOCK_ROWS_PIXELS = 1 << 20


def dither_threshold(palettes: torch.Tensor) -> torch.Tensor:
    """Threshold of each palette of `[B, k, 3]` -> `[B]` (module docstring)."""
    k = palettes.shape[1]
    a = palettes[:, 0]
    c = palettes[:, min(1, k - 1)]
    dac = dist_cie94(a, c)
    for i in range(2, k):
        ci = palettes[:, i]
        da = dist_cie94(ci, a)
        dc = dist_cie94(ci, c)
        first = (da > dc) & (da > dac)
        second = ~first & (dc > dac)
        c = torch.where(first[:, None], ci, c)
        a = torch.where(second[:, None], ci, a)
        dac = torch.where(first, da, torch.where(second, dc, dac))
    ka = torch.full((palettes.shape[0],), k, dtype=torch.int32, device=palettes.device)
    return dac / torch.sqrt(ka.to(torch.float32))


def bayer(height: int, width: int, device) -> torch.Tensor:
    """`M[y % 4][x % 4] / 16 - 0.5` for every pixel, `[H, W]`."""
    m = div(torch.tensor(BAYER_4X4, dtype=torch.float32, device=device), 16.0) - 0.5
    ys = torch.arange(height, device=device) % 4
    xs = torch.arange(width, device=device) % 4
    return m[ys[:, None], xs[None, :]]


def indices(rgb8: torch.Tensor, palette: torch.Tensor, mode: str,
            threshold: torch.Tensor | None, lowp: bool = False) -> torch.Tensor:
    """Palette index `[H, W]` of each pixel of `rgb8 [H, W, 3]`, in blocks of rows."""
    h, w = rgb8.shape[0], rgb8.shape[1]
    rows = max(1, BLOCK_ROWS_PIXELS // w)
    pattern = bayer(h, w, rgb8.device) if mode == "dither" else None
    out = []
    for r in range(0, h, rows):
        lab = srgb8_to_lab(rgb8[r:r + rows])
        if lowp:
            lab = lab.to(palette.dtype)
        if mode == "dither":
            lab = lab + (threshold * pattern[r:r + rows])[..., None]
        out.append(torch.argmin(d2_cie94(lab[..., None, :], palette), dim=-1))
    return torch.cat(out)


def rgba(rgb8: torch.Tensor, palette: torch.Tensor, mode: str, threshold=None,
         lowp: bool = False) -> torch.Tensor:
    """The `[H, W, 4]` uint8 output image of one frame against one palette."""
    rgb = lab_to_srgb8(palette)[indices(rgb8, palette, mode, threshold, lowp)]
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
