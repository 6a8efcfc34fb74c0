"""Bilinear shrink with the reference's sampler convention, in PyTorch.

Port of `kmeans_tpu/ops/resize.py`: the training image is sampled at the
normalised coordinate `(x / W_out, y / H_out)`, the corner of each output
texel, with a linear filter and clamp-to-edge, and the shrink policy caps
the long side and scales the short side with truncation (minimum 1).
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.ops._math import const, div
from kmeans_tpu_torch.ops.colorspace import fma


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


def resize_uint8_np(image_u8, new_height: int, new_width: int) -> np.ndarray:
    """uint8 `[H, W, C]` resize on the host in numpy, the pipeline mode's
    training shrink (kmeans_tpu/ops/resize.py:39, copied expression for
    expression): the corner-aligned clamp-to-edge sampler in float32,
    true divides, each product and sum rounded on its own (numpy has no
    FMA), then `np.round` (half to even) of the clamped unorm times 255.
    So it gives the reference's bytes, and can round a sample at an exact
    0.5 tie one u8 step apart from `resize_uint8`, which follows XLA's
    contractions. Each blend is elementwise, so the four samples of each
    output pixel are gathered in uint8 first and only they are converted
    (the same bits as the reference's whole-row blend, which converts
    every column of the sampled rows): a 4K image shrinks to its 256-px
    strip through 4 x 36,864 of its pixels, and `image_u8` may be a strided
    view such as `rgba[..., :3]`, or the RGBA itself (channels are
    independent)."""
    image_u8 = np.asarray(image_u8)
    h, w = image_u8.shape[0], image_u8.shape[1]

    def axis_weights(n_out: int, n_in: int):
        coord = (
            np.arange(n_out, dtype=np.float32) / np.float32(n_out) * n_in
            - np.float32(0.5)
        )
        i0 = np.floor(coord)
        frac = coord - i0
        lo = np.clip(i0.astype(np.int32), 0, n_in - 1)
        hi = np.clip(i0.astype(np.int32) + 1, 0, n_in - 1)
        return lo, hi, frac

    y0, y1, fy = axis_weights(new_height, h)
    x0, x1, fx = axis_weights(new_width, w)
    fy = fy[:, None, None]
    # A C-contiguous RGBA8 image gathers one 32-bit word a sample.
    words = (image_u8.view(np.uint32)[..., 0]
             if image_u8.ndim == 3 and image_u8.shape[2] == 4 and image_u8.flags.c_contiguous
             else None)

    def unorm(y, x):
        if words is None:
            samples = image_u8[y[:, None], x[None, :]]
        else:
            samples = words[y[:, None], x[None, :]].view(np.uint8).reshape(len(y), len(x), 4)
        return samples.astype(np.float32) / np.float32(255.0)

    def rows(x):
        return unorm(y0, x) * (np.float32(1.0) - fy) + unorm(y1, x) * fy

    fx = fx[None, :, None]
    out = rows(x0) * (np.float32(1.0) - fx) + rows(x1) * fx
    return np.round(np.clip(out, 0.0, 1.0) * np.float32(255.0)).astype(np.uint8)


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


def resize_uint8_eager(
    image_u8: torch.Tensor, new_height: int, new_width: int
) -> torch.Tensor:
    """uint8 `[H, W, C]` resize as the reference runs `resize_uint8` op by
    op, outside any jit (kmeans_tpu/api.py:1119, the shrink of the host
    palette algorithms): a true divide by 255, `resize_bilinear`, then
    `round(clamp(., 0, 1) * 255)`, every operation rounded on its own. It
    rounds the 0.5 ties of a shrink apart from the jitted form
    (`resize_uint8`), so each call site takes the form the reference runs
    there. The sampled rows are gathered in uint8 before the elementwise
    conversion (the same bits as converting the whole image first)."""
    h, w = image_u8.shape[0], image_u8.shape[1]
    y0, y1, fy = _axis_weights(new_height, h, image_u8.device)
    x0, x1, fx = _axis_weights(new_width, w, image_u8.device)
    top = div(image_u8[y0].to(torch.float32), 255.0)
    bot = div(image_u8[y1].to(torch.float32), 255.0)
    out = _blend(top, bot, x0, x1, fx, fy)
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)


# The reference's shrinks, as XLA compiles them on the CPU (the JAX
# package's oracle): the canvas shrink divides the coordinates truly (its
# sizes are traced) but contracts `pos / n_out * n_in - 0.5` into one
# fused multiply-add; both multiply the unorm conversion by the float32
# reciprocal of 255 and contract each blend `a * (1 - f) + b * f` into
# fma(a, 1 - f, b * f). With float32
# operands an FMA is the float64 product plus the addend, rounded once to
# float32 (the product is exact in float64), so the canvas computes the
# same on both devices. IEEE divides and separate roundings instead round
# the exact ties of a 2:1 or 15:1 shrink (samples at fraction 0.5) the
# other way on some 2% of the canvas's bytes, and miss 17 bytes of 48
# canvases without the coordinate's FMA alone (measured on the CPU).
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _fma_blend(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """`fma(a, 1 - f, b * f)` in float32: `a * (1 - f) + b * f` with the
    first product and the sum rounded once."""
    return fma(a, 1.0 - f, b * f)


def _compiled_axis(n_out: int, n_in: int, device):
    """The sampler of one axis as XLA compiles the reference's jitted
    `resize_uint8` at static sizes: `pos / n_out * n_in` folds into `pos *
    K` with K = f32(f32(1 / n_out) * n_in), and `pos * K - 0.5` contracts
    into one fused multiply-add. The product of an integer below 2^24 and
    K is exact in float64, and so is the sum, so one rounding to float32
    gives the FMA's bits."""
    k = float(np.float32(np.float32(1.0) / np.float32(n_out)) * np.float32(n_in))
    pos = torch.arange(n_out, dtype=torch.float64, device=device)
    coord = (pos * k - 0.5).float()
    i0 = torch.floor(coord)
    frac = coord - i0
    lo = torch.clamp(i0.to(torch.int64), 0, n_in - 1)
    hi = torch.clamp(i0.to(torch.int64) + 1, 0, n_in - 1)
    return lo, hi, frac


def resize_uint8(
    image_u8: torch.Tensor, new_height: int, new_width: int
) -> torch.Tensor:
    """uint8 `[..., H, W, C]` resize through the unorm float path, rounded
    back to uint8 (kmeans_tpu/ops/resize.py:114); leading axes are frames,
    each resized as alone. The arithmetic is the reference's as its
    entry points run it, jitted (`_compiled_axis`, the unorm conversion
    as a multiply by `_INV_255`, each blend as `_fma_blend`), the same on
    both devices; the reference run op by op rounds the 0.5 ties of a
    shrink apart from it. The sampled rows are gathered in uint8 before
    the elementwise unorm conversion, which gives the same bits as
    converting the whole image first and touches only those rows."""
    h, w = image_u8.shape[-3], image_u8.shape[-2]
    y0, y1, fy = _compiled_axis(new_height, h, image_u8.device)
    x0, x1, fx = _compiled_axis(new_width, w, image_u8.device)
    top = image_u8[..., y0, :, :].to(torch.float32) * _INV_255
    bot = image_u8[..., y1, :, :].to(torch.float32) * _INV_255
    rows = _fma_blend(top, bot, fy[:, None, None])
    out = _fma_blend(rows[..., x0, :], rows[..., x1, :], fx[None, :, None])
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)


def _canvas_axis(n_canvas: int, n_out: torch.Tensor, n_in: torch.Tensor):
    """Sampler of one canvas axis for B frames: `n_out`, `n_in` are `[B]`
    int64 on the device. Returns `(lo, hi, frac, inside)`, each `[B,
    n_canvas]` (kmeans_tpu/ops/resize.py:156-171)."""
    pos = torch.arange(n_canvas, device=n_out.device)
    # fma(pos / n_out, n_in, -0.5), as XLA contracts it: the float32
    # quotient times an integer below 2^24 is exact in float64.
    quot = torch.div(pos.to(torch.float32)[None, :], n_out.to(torch.float32)[:, None])
    coord = (quot.double() * n_in.double()[:, None] - 0.5).float()
    i0 = torch.floor(coord)
    frac = coord - i0
    last = (n_in - 1)[:, None]
    lo = torch.minimum(torch.clamp(i0.to(torch.int64), min=0), last)
    hi = torch.minimum(torch.clamp(i0.to(torch.int64) + 1, min=0), last)
    ident = (n_out == n_in)[:, None]
    direct = torch.minimum(pos[None, :], last)
    lo = torch.where(ident, direct, lo)
    hi = torch.where(ident, direct, hi)
    frac = torch.where(ident, torch.zeros_like(frac), frac)
    return lo, hi, frac, pos[None, :] < n_out[:, None]


def resize_to_canvas(
    image_u8: torch.Tensor,
    canvas_height: int,
    canvas_width: int,
    src_h,
    src_w,
    out_h,
    out_w,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shrink into a fixed canvas, the bucketed training path
    (kmeans_tpu/ops/resize.py:121).

    `image_u8` `[Hp, Wp, C]` holds real data in its top-left `[src_h,
    src_w]` corner; it is resized to `[out_h, out_w]` with the sampler of
    `resize_bilinear` and written to the top-left of a
    `[canvas_height, canvas_width, C]` canvas. Along an axis where `out ==
    src` the sampler is the exact identity gather (the corner-aligned one
    would blend neighbours at equal sizes). Returns `(canvas_u8, weight)`,
    `weight` float32 1.0 on real output pixels and 0.0 on the canvas's
    padding.

    The batched form takes `[B, Hp, Wp, C]` frames and B values (a
    sequence or a `[B]` tensor) for each of `src_h/src_w/out_h/out_w`, and
    returns `[B, canvas_height, canvas_width, C]` canvases and `[B,
    canvas_height, canvas_width]` weights, each frame as if alone. The
    coordinate divides are true divides of tensors, on the CPU and on
    CUDA; the fused multiply-adds and the unorm conversion follow the
    reference as XLA compiles it (`_INV_255`), which gives its bytes."""
    single = image_u8.dim() == 3
    frames = image_u8[None] if single else image_u8
    device = frames.device

    def vec(v):
        v = torch.as_tensor([v] if single else v, dtype=torch.int64)
        return v.to(device)

    y0, y1, fy, vy = _canvas_axis(canvas_height, vec(out_h), vec(src_h))
    x0, x1, fx, vx = _canvas_axis(canvas_width, vec(out_w), vec(src_w))
    b, c = frames.shape[0], frames.shape[-1]
    rows_of = torch.arange(b, device=device)[:, None]
    # The sampled rows are gathered in uint8 before the elementwise unorm
    # conversion (the same bits as converting the whole image first).
    top = frames[rows_of, y0].to(torch.float32) * _INV_255
    bot = frames[rows_of, y1].to(torch.float32) * _INV_255
    rows = _fma_blend(top, bot, fy[:, :, None, None])

    def cols(x):
        return torch.gather(rows, 2, x[:, None, :, None].expand(b, canvas_height, -1, c))

    out = _fma_blend(cols(x0), cols(x1), fx[:, None, :, None])
    canvas = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
    weight = (vy[:, :, None] & vx[:, None, :]).to(torch.float32)
    return (canvas[0], weight[0]) if single else (canvas, weight)


# Source pixels of one row chunk of `shrink_columns`. `resize_to_canvas`
# holds about 110 bytes of float32 and float64 temporaries per source
# pixel of its row pass, so a chunk holds about 230 MB at any band width.
_COLUMN_CHUNK_PIXELS = 1 << 21


def shrink_columns(band_u8: torch.Tensor, rows: int, width: int, out_width: int) -> torch.Tensor:
    """`[rows, out_width, C]` uint8: the real `[rows, width]` corner of a
    (padded) band shrunk along its columns only, the first stage of the
    streamed training (kmeans_tpu/api.py:2545-2552, `_canvas_shrink_jit`
    with `src_h = out_h = rows`, cropped to `[rows, out_width]`).

    It is `resize_to_canvas` of one chunk of rows at a time. Along rows
    the canvas sampler is then the identity with weight 0, so each output
    row reads its own source row alone, and the chunks give the whole
    canvas's bytes; the canvas's columns past `out_width` are never
    computed (each column's sampler depends only on its position). Device
    memory holds one chunk's temporaries, not the band's."""
    step = max(1, _COLUMN_CHUNK_PIXELS // max(width, 1))
    out = torch.empty((rows, out_width, band_u8.shape[-1]), dtype=torch.uint8,
                      device=band_u8.device)
    for r0 in range(0, rows, step):
        n = min(step, rows - r0)
        out[r0:r0 + n] = resize_to_canvas(band_u8[r0:r0 + n, :width], n, out_width,
                                          n, width, n, out_width)[0]
    return out
