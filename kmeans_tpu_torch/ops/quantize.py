"""Replace, ordered-dither and meld output modes, in plain PyTorch.

Port of `kmeans_tpu/ops/quantize.py`. Distances are CIE94 or CIEDE2000
(`metric=`), with the pixel first.

- replace: each pixel takes its nearest centroid.
- dither: 4x4 Bayer ordered dithering in Lab. The threshold is the
  reference's greedy approximation of the largest pairwise centroid
  distance, divided by sqrt(k); the adjusted colour is
  `lab + threshold * (bayer(x, y) - 0.5)` on L, a and b alike, and the
  output is the centroid nearest to it.
- meld: a blend of the two closest centroids weighted by relative
  distance, `factor = d(pixel, second) / d(closest, second)`,
  `out = factor * closest + (1 - factor) * second`. Two centroids of one
  colour give `0 / 0` or `x / 0`, a NaN blend, which the reference writes
  as black; so does the port.
- k == 1 short-circuits dither and meld to the single palette colour.

These are the port's plain versions: `ops/kernels.py` holds the CUDA
kernels that do the same per pixel in one pass. The dither threshold is
the exception that lives here: `dither_threshold` / `dither_thresholds`
run their plain twins (`*_reference`) on a CPU tensor and launch
`csrc/dither_threshold.cu` on a CUDA tensor (one block per palette, a
first-trigger scan with the serial walk's bits), or raise.
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops._math import div
from kmeans_tpu_torch.ops.colorspace import lab_to_srgb, lab_to_srgb8, srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import metric_fns

# 4x4 Bayer index matrix, row-major (kmeans_tpu/ops/quantize.py:41).
BAYER_4X4 = (
    (0, 8, 2, 10),
    (12, 4, 14, 6),
    (3, 11, 1, 9),
    (15, 7, 13, 5),
)

_BIG = 3.4e38  # above any CIE94^2
# Pixel x palette elements of one row chunk of `_meld_chunked`
# (kmeans_tpu/ops/quantize.py:211).
_MELD_CHUNK_ELEMS = 1 << 26


def _valid_mask(k: int, k_active, device) -> torch.Tensor:
    return torch.arange(k, device=device) < (k if k_active is None else k_active)


def _d2_matrix(lab, palette, valid, metric="cie94"):
    _, dist_sq = metric_fns(metric)
    d2 = dist_sq(lab[..., None, :], palette)
    return torch.where(valid, d2, torch.full_like(d2, _BIG))


def nearest_index(
    lab: torch.Tensor, palette: torch.Tensor, k_active=None, metric: str = "cie94"
) -> torch.Tensor:
    """Index of each Lab pixel's nearest palette entry (first minimum wins),
    as int64."""
    valid = _valid_mask(palette.shape[0], k_active, lab.device)
    return torch.argmin(_d2_matrix(lab, palette, valid, metric), dim=-1)


def nearest_color(
    lab: torch.Tensor, palette: torch.Tensor, k_active=None, metric: str = "cie94"
) -> torch.Tensor:
    """Each Lab pixel replaced by its nearest palette entry."""
    return palette[nearest_index(lab, palette, k_active, metric)]


def dither_threshold_reference(
    palette: torch.Tensor, k_active=None, metric: str = "cie94"
) -> torch.Tensor:
    """Greedy approximate largest pairwise centroid distance / sqrt(k), as a
    0-dim float32 tensor on the palette's device
    (kmeans_tpu/ops/quantize.py:112): the plain twin of the kernel. Keeps
    the reference's asymmetric orientation (the candidate centroid first)
    and its update order."""
    dist, _ = metric_fns(metric)
    k = palette.shape[0]
    k_active = k if k_active is None else k_active
    a = palette[0]
    b = palette[min(1, k - 1)]
    dab = dist(a, b)
    for i in range(2, min(k, k_active)):
        ci = palette[i]
        da = dist(ci, a)
        db = dist(ci, b)
        first = (da > db) & (da > dab)
        second = ~first & (db > dab)
        b = torch.where(first, ci, b)
        a = torch.where(second, ci, a)
        dab = torch.where(first, da, torch.where(second, db, dab))
    return dab / torch.sqrt(torch.full((), float(k_active), device=palette.device))


def dither_thresholds_reference(
    palettes: torch.Tensor, k_actives=None, metric: str = "cie94"
) -> torch.Tensor:
    """`dither_threshold_reference` of each of B palettes `[B, K, 3]` at once, with
    `k_actives` None or B ints: `[B]` float32 on the palettes' device. The
    same elementwise float32 operations in the same order per palette, one
    loop over the palette axis for all of them (the reference vmaps its
    `dither_threshold`, kmeans_tpu/api.py:3255)."""
    dist, _ = metric_fns(metric)
    b, k = palettes.shape[0], palettes.shape[1]
    k_actives = [k] * b if k_actives is None else [int(x) for x in k_actives]
    ka = torch.tensor(k_actives, dtype=torch.int32).to(palettes.device)
    a = palettes[:, 0]
    c = palettes[:, min(1, k - 1)]
    dac = dist(a, c)
    for i in range(2, min(k, max(k_actives))):
        ci = palettes[:, i]
        da = dist(ci, a)
        dc = dist(ci, c)
        active = i < ka
        first = active & (da > dc) & (da > dac)
        second = active & ~first & (dc > dac)
        c = torch.where(first[:, None], ci, c)
        a = torch.where(second[:, None], ci, a)
        dac = torch.where(first, da, torch.where(second, dc, dac))
    return dac / torch.sqrt(ka.to(torch.float32))


def dither_threshold(
    palette: torch.Tensor, k_active=None, metric: str = "cie94"
) -> torch.Tensor:
    """The dither threshold of one `[K, 3]` palette as a 0-dim float32
    tensor on its device; see `dither_threshold_reference` for the
    contract. A CPU tensor runs the twin; a CUDA tensor launches
    `csrc/dither_threshold.cu` (the same bits) or raises."""
    if palette.device.type == "cpu":
        return dither_threshold_reference(palette, k_active, metric)
    k = palette.shape[0]
    return _launch_threshold(palette[None], [k if k_active is None else int(k_active)],
                             metric).reshape(())


def dither_thresholds(
    palettes: torch.Tensor, k_actives=None, metric: str = "cie94"
) -> torch.Tensor:
    """The dither thresholds of B palettes `[B, K, 3]` as `[B]` float32;
    see `dither_thresholds_reference` for the contract. A CPU tensor runs
    the twin; a CUDA tensor launches the kernel once for all B (the same
    bits) or raises."""
    if palettes.device.type == "cpu":
        return dither_thresholds_reference(palettes, k_actives, metric)
    b, k = palettes.shape[0], palettes.shape[1]
    return _launch_threshold(palettes, [k] * b if k_actives is None else
                             [int(x) for x in k_actives], metric)


def _launch_threshold(palettes: torch.Tensor, k_actives: list, metric: str) -> torch.Tensor:
    """One launch of the threshold kernel over `[B, K, 3]` CUDA palettes."""
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops._build import load_library

    metric_fns(metric)  # raises on an unknown metric
    if palettes.device.type != "cuda":
        raise ValueError(f"dither_threshold runs on cpu or cuda, not {palettes.device}")
    if palettes.dim() != 3 or palettes.shape[2] != 3 or len(k_actives) != palettes.shape[0]:
        raise ValueError(f"expected [B, K, 3] palettes and B k_actives, got "
                         f"{tuple(palettes.shape)} and {len(k_actives)}")
    lib = load_library()
    device = palettes.device
    pal = palettes.to(torch.float32).contiguous()
    b, k = pal.shape[0], pal.shape[1]
    out = torch.empty(b, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        k_active, k_dev = kernels._k_actives_operands(k_actives, device)
        err = lib.kmeans_dither_threshold(
            pal.data_ptr(), b, k, k_active, kernels._ptr(k_dev),
            kernels.KERNEL_METRICS[metric], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels._raise_on_error(lib, err, "dither_threshold")
    kernels.LAUNCHES_BY_MODE["dither_threshold", metric, "exact"] += 1
    return out


def bayer_values(height: int, width: int, row_offset: int = 0, device=None):
    """`M4[y % 4][x % 4] / 16 - 0.5` for every pixel `[H, W]`, with `y`
    shifted by `row_offset` (kmeans_tpu/ops/quantize.py:150)."""
    m = div(torch.tensor(BAYER_4X4, dtype=torch.float32, device=device), 16.0) - 0.5
    ys = (torch.arange(height, device=device) + row_offset) % 4
    xs = torch.arange(width, device=device) % 4
    return m[ys[:, None], xs[None, :]]


def dither(
    lab: torch.Tensor, palette: torch.Tensor, k_active=None, row_offset: int = 0,
    metric: str = "cie94",
) -> torch.Tensor:
    """Ordered dithering of Lab pixels `[H, W, 3]` to palette colours."""
    return palette[assign_index(lab, palette, "dither", k_active, row_offset, metric)]


def assign_index(
    lab: torch.Tensor,
    palette: torch.Tensor,
    mode: str = "replace",
    k_active=None,
    row_offset: int = 0,
    metric: str = "cie94",
) -> torch.Tensor:
    """Per-pixel palette index `[H, W]` for replace or dither (meld blends
    colours, so it has no index). Dither's k == 1 case needs no branch:
    index 0 is the only active entry."""
    if mode == "replace":
        return nearest_index(lab, palette, k_active, metric)
    if mode == "dither":
        h, w = lab.shape[0], lab.shape[1]
        threshold = dither_threshold_reference(palette, k_active, metric)
        bayer = bayer_values(h, w, row_offset, lab.device)
        adjusted = lab + (threshold * bayer)[..., None]
        return nearest_index(adjusted, palette, k_active, metric)
    raise ValueError("assign_index supports replace/dither only")


def meld(
    lab: torch.Tensor, palette: torch.Tensor, k_active=None, metric: str = "cie94"
) -> torch.Tensor:
    """Blend of the two closest centroids (kmeans_tpu/ops/quantize.py:176).
    Palettes above 64 entries take row chunks of `[H, W, 3]` images, so the
    `[pixels, K]` distance matrix stays bounded."""
    if palette.shape[0] == 1:
        return palette[0].expand(lab.shape)
    if palette.shape[0] > 64 and lab.dim() == 3:
        return _meld_chunked(lab, palette, k_active, metric)
    return _meld_block(lab, palette, k_active, metric)


def _meld_block(lab, palette, k_active=None, metric="cie94"):
    """The two smallest distances with the first index winning ties, as
    `lax.top_k` orders them: the first argmin, then the argmin of the rest."""
    dist, _ = metric_fns(metric)
    k = palette.shape[0]
    d2 = _d2_matrix(lab, palette, _valid_mask(k, k_active, lab.device), metric)
    idx1 = torch.argmin(d2, dim=-1)
    first = torch.arange(k, device=lab.device) == idx1[..., None]
    idx2 = torch.argmin(torch.where(first, torch.full_like(d2, float("inf")), d2), dim=-1)
    closest = palette[idx1]
    second = palette[idx2]
    factor = (dist(lab, second) / dist(closest, second))[..., None]
    out = factor * closest + (1.0 - factor) * second
    if (k if k_active is None else k_active) == 1:
        return palette[0].expand(out.shape)
    return out


def _meld_chunked(lab, palette, k_active=None, metric="cie94"):
    """Row-chunked meld: each chunk's `[rows, W, K]` intermediates stay
    near 256 MB (kmeans_tpu/ops/quantize.py:207). Unlike the reference,
    the last chunk is not padded to a whole chunk."""
    h, w = lab.shape[0], lab.shape[1]
    rows = max(1, _MELD_CHUNK_ELEMS // max(w * palette.shape[0], 1))
    return torch.cat([
        _meld_block(lab[r:r + rows], palette, k_active, metric) for r in range(0, h, rows)
    ])


def quantize_image(
    rgba_u8: torch.Tensor,
    palette_lab: torch.Tensor,
    mode: str = "replace",
    k_active=None,
    row_offset: int = 0,
    metric: str = "cie94",
) -> torch.Tensor:
    """Full-resolution output pass, uint8 `[H, W, 3|4]` -> uint8 RGBA with
    alpha 255 (kmeans_tpu/ops/quantize.py:224). A NaN meld blend becomes
    black, as the reference's float-to-integer conversion writes it."""
    lab = srgb8_to_lab(rgba_u8[..., :3])
    if mode == "meld":
        blend = torch.nan_to_num(lab_to_srgb(meld(lab, palette_lab, k_active, metric)), nan=0.0)
        rgb8 = torch.round(blend * 255.0).to(torch.uint8)
    else:
        idx = assign_index(lab, palette_lab, mode, k_active, row_offset, metric)
        rgb8 = lab_to_srgb8(palette_lab)[idx]
    alpha = torch.full(rgb8.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb8.device)
    return torch.cat([rgb8, alpha], dim=-1)
