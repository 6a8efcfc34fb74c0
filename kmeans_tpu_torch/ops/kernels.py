"""The port's three CUDA kernels, each with its plain PyTorch twin.

1. The fused assign pass: u8 RGB -> packed palette indices. Port of
   `kmeans_tpu/ops/kernels.py::fused_assign_packed` (the Pallas
   `_quantize_kernel` in packed-index mode) for replace and dither under
   the exact CIE94 and CIEDE2000 metrics.
2. The meld pass: u8 RGB -> the blend of each pixel's two closest
   centroids, as RGB bytes packed into int32 words. Port of
   `fused_meld_packed` (the same Pallas kernel in meld mode with its
   in-kernel RGB24 pack), both metrics.
3. The Lloyd tile accumulator: Lab planes -> per-cluster sums and counts
   of one Lloyd step. Port of `kmeans_tpu/ops/kernels.py::lloyd_accumulate`
   (the Pallas `_lloyd_acc_kernel`), both exact metrics.

For each:

- the wrapper (`assign_packed`, `meld_packed`, `lloyd_accumulate`) runs
  the plain twin on a CPU tensor and launches the hand-written kernel
  (`csrc/quantize_assign.cu`, `csrc/quantize_meld.cu`,
  `csrc/lloyd_accumulate.cu`) on a CUDA tensor, or raises. There is no
  fallback between them.
- the twin (`*_reference`) repeats the kernel's float32 operations in the
  same order with the same output layout. It is the spec the tests hold
  to the JAX package, and the version the kernel is compared with on the
  card. The distances are those of `ops/delta_e.py`, with the pixel-side
  terms hoisted out of the centroid loop (`_pixel_distances`); the CUDA
  kernels share them through `csrc/delta_e.cuh`.
- `ASSIGN_PACKED_LAUNCHES`, `MELD_PACKED_LAUNCHES` and
  `LLOYD_ACCUMULATE_LAUNCHES` count kernel launches (never the twins'
  runs).

Assign word layout: the image is flattened and zero-padded to
`n_pad = round_up(h * w, quant_tile_rows(kp) * LANES)` pixels. With
`bits = pack_bits(kp)`, `ppw = 32 // bits` and `blk = tile_rows // ppw`, the
output is `[n_pad // LANES // ppw, LANES]` int32, and word `(t * blk + r, l)`
holds pixel `((t * tile_rows) + j * blk + r) * LANES + l` at bit `bits * j`.

Meld word layout (`utils/packing.py::unpack_rgb24_tile_words` inverts it):
the same padding, `blk = tile_rows // 4`, output `[3 * n_pad // 4 // LANES,
LANES]` int32. Word row `t * 3 * blk + j * blk + r`, lane `l`, holds bytes of
the pixels `p_s = ((t * tile_rows) + s * blk + r) * LANES + l`, low byte
first: `j = 0`: R0 G0 B0 R1; `j = 1`: G1 B1 R2 G2; `j = 2`: B2 R3 G3 B3.

Accumulator plane layout (`pack_lab_planes`): `[3, M, 128]` float32 or
bfloat16, pixel `p` of channel `c` at `[c, p // 128, p % 128]`, `M` a
multiple of `ACCUM_TILE_ROWS`; pad pixels drop out by `n_valid`.
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops._math import const
from kmeans_tpu_torch.ops.colorspace import lab_to_srgb, srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import cie2000_sq_planes, metric_fns
from kmeans_tpu_torch.ops.gamma_lut import gamma_lut
from kmeans_tpu_torch.ops.quantize import BAYER_4X4
from kmeans_tpu_torch.utils.packing import pack_bits

LANES = 128
# Tile heights of the reference kernel; the word layout depends on them
# (kmeans_tpu/ops/kernels.py:64-65).
QUANT_TILE_ROWS = 256
QUANT_TILE_ROWS_ROLLED = 128
# Largest palette the packed-index output serves
# (kmeans_tpu/ops/kernels.py:235).
INDEXED_MAX_K = 1024

_K1 = 0.045
_K2 = 0.015
_BIG = 3.4e38

# The metrics the kernels take, by the integer code they pass to CUDA.
KERNEL_METRICS = {"cie94": 0, "cie2000": 1}

# Launches of each CUDA kernel by its wrapper in this process.
ASSIGN_PACKED_LAUNCHES = 0
MELD_PACKED_LAUNCHES = 0


def quant_tile_rows(kp: int) -> int:
    """Tile height for a palette of `kp` entries: the host unpack must use
    the same value (kmeans_tpu/ops/kernels.py:218)."""
    return QUANT_TILE_ROWS if kp <= 16 else QUANT_TILE_ROWS_ROLLED


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _layout(h: int, w: int, kp: int):
    """`(n, n_pad, tile_rows, bits, ppw)` of the packed output."""
    tile_rows = quant_tile_rows(kp)
    bits = pack_bits(kp)
    n = h * w
    return n, _round_up(n, tile_rows * LANES), tile_rows, bits, 32 // bits


def _check_metric(metric) -> None:
    if metric not in KERNEL_METRICS:
        raise ValueError(f"unknown metric {metric!r} (cie94 or cie2000)")


def _check_image_args(rgb_u8, centroids_lab, k_active, metric) -> int:
    """Validate what the assign and meld versions take; return `k_active`."""
    _check_metric(metric)
    if rgb_u8.dtype != torch.uint8 or rgb_u8.dim() != 3 or rgb_u8.shape[-1] != 3:
        raise ValueError(
            f"expected [H, W, 3] uint8 RGB, got {tuple(rgb_u8.shape)} {rgb_u8.dtype}"
        )
    if centroids_lab.dim() != 2 or centroids_lab.shape[1] != 3:
        raise ValueError(f"expected [K, 3] centroids, got {tuple(centroids_lab.shape)}")
    kp = centroids_lab.shape[0]
    k_active = kp if k_active is None else int(k_active)
    if not 1 <= k_active <= kp:
        raise ValueError(f"k_active must be in [1, {kp}], got {k_active}")
    return k_active


def _check_args(rgb_u8, centroids_lab, k_active, mode, metric) -> int:
    """Validate what both assign versions take; return `k_active`."""
    if mode == "meld":
        raise ValueError("assign_packed supports replace/dither; meld is meld_packed")
    if mode not in ("replace", "dither"):
        raise ValueError(f"assign_packed supports replace/dither, got {mode!r}")
    if centroids_lab.dim() == 2 and centroids_lab.shape[0] > INDEXED_MAX_K:
        raise NotImplementedError(
            f"k = {centroids_lab.shape[0]} > {INDEXED_MAX_K}: the packed-index "
            f"output serves k <= {INDEXED_MAX_K} (larger palettes: ROADMAP B2/B8)"
        )
    return _check_image_args(rgb_u8, centroids_lab, k_active, metric)


def _pixel_distances(l, a, b, centroids_lab, metric: str):
    """`d(k)`: the squared distance from each pixel `(l, a, b)` to centroid
    `k`, with the pixel's chroma (and CIE94's S_C and S_H weights) hoisted
    out of the centroid loop as in the TPU kernels
    (kmeans_tpu/ops/kernels.py:823-826, 861-873, 1386-1399). Hoisting
    changes no bit: each term is the same expression of the same inputs.
    The CUDA kernels repeat these float32 operations in this order."""
    cents = centroids_lab.to(device=l.device, dtype=torch.float32)
    c1 = torch.sqrt(a * a + b * b)
    if metric == "cie2000":
        def d(k):
            return cie2000_sq_planes(l, a, b, cents[k, 0], cents[k, 1], cents[k, 2], c1=c1)

        return d
    sc = 1.0 + _K1 * c1
    sh = 1.0 + _K2 * c1
    sh2 = sh * sh
    chroma = torch.sqrt(cents[:, 1] * cents[:, 1] + cents[:, 2] * cents[:, 2])

    def d(k):
        dl = l - cents[k, 0]
        da = a - cents[k, 1]
        db = b - cents[k, 2]
        dcab = c1 - chroma[k]
        dhab_sq = torch.clamp(da * da + db * db - dcab * dcab, min=0.0)
        t = dcab / sc
        return dl * dl + t * t + dhab_sq / sh2

    return d


def _argmin(l, a, b, centroids_lab, k_active: int, metric: str = "cie94"):
    """Nearest of the first `k_active` centroids to each pixel:
    `(best_k int64, best_d float32)`, strict `<` so the first minimum
    wins."""
    dist = _pixel_distances(l, a, b, centroids_lab, metric)
    best_d = torch.full_like(l, _BIG)
    best_k = torch.zeros(l.shape, dtype=torch.int64, device=l.device)
    for k in range(k_active):
        d = dist(k)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_k = torch.where(take, k, best_k)
    return best_k, best_d


def _padded_lab(rgb_u8: torch.Tensor, n_pad: int):
    """Lab planes of the image flattened and zero-padded to `n_pad` pixels
    (pad pixels are RGB (0, 0, 0), as in the reference's padding)."""
    n = rgb_u8.shape[0] * rgb_u8.shape[1]
    rgb = torch.zeros((n_pad, 3), dtype=torch.uint8, device=rgb_u8.device)
    rgb[:n] = rgb_u8.reshape(n, 3)
    lab = srgb8_to_lab(rgb)
    return lab[:, 0], lab[:, 1], lab[:, 2]


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 words below 2^32 -> the same bits as int32."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def assign_packed_reference(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
) -> torch.Tensor:
    """Plain PyTorch twin of the assign kernel, on any device: packed
    `[n_pad // LANES // ppw, LANES]` int32 palette indices of `rgb_u8`
    (`[H, W, 3]` uint8) against `centroids_lab` (`[kp, 3]` Lab), under
    `metric` (`"cie94"` or `"cie2000"`), strict `<` so the first minimum
    wins, centroids `>= k_active` masked. In dither mode each pixel's Lab
    is first moved by `threshold * (M4[y % 4][x % 4] / 16 - 0.5)`, with `y`
    shifted by `row_offset`."""
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric)
    device = rgb_u8.device
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    n, n_pad, tile_rows, bits, ppw = _layout(h, w, kp)

    l, a, b = _padded_lab(rgb_u8, n_pad)
    if mode == "dither":
        flat = torch.arange(n_pad, dtype=torch.int64, device=device)
        px = flat % w
        py = flat // w + row_offset
        m = torch.tensor(BAYER_4X4, dtype=torch.float32, device=device)
        bayer = torch.div(m, const(16.0, m)) - 0.5
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=device)
        adjust = thr * bayer[py % 4, px % 4]
        l, a, b = l + adjust, a + adjust, b + adjust

    best_k, _ = _argmin(l, a, b, centroids_lab, k_active, metric)

    # Fold ppw sublane blocks of each tile into one word.
    blk = tile_rows // ppw
    idx = best_k.reshape(n_pad // (tile_rows * LANES), ppw, blk, LANES)
    shifts = (torch.arange(ppw, device=device) * bits).reshape(1, ppw, 1, 1)
    words = (idx << shifts).sum(dim=1)  # disjoint bit fields: sum == or
    return _as_int32(words).reshape(-1, LANES)


def assign_packed(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
) -> torch.Tensor:
    """Packed palette indices of `rgb_u8`; see `assign_packed_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/quantize_assign.cu` on the current stream (built on
    first use) or raises. `threshold` is a float or a one-element float32
    tensor on the image's device (it stays there: no host round trip)."""
    global ASSIGN_PACKED_LAUNCHES
    if rgb_u8.device.type == "cpu":
        return assign_packed_reference(
            rgb_u8, centroids_lab, threshold, k_active, mode, row_offset, metric
        )
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric)
    _check_cuda_image(rgb_u8, centroids_lab, "assign_packed")
    device = rgb_u8.device
    if isinstance(threshold, torch.Tensor):
        if threshold.device != device or threshold.dtype != torch.float32:
            raise ValueError("threshold must be float32 on the image's device")
        if threshold.numel() != 1:
            raise ValueError("threshold must hold one value")
        thr = threshold.reshape(1).contiguous()
    else:
        thr = torch.full((1,), float(threshold), dtype=torch.float32, device=device)
    if not 0 <= row_offset < 1 << 62:
        raise ValueError(f"row_offset must be a non-negative int, got {row_offset}")

    from kmeans_tpu_torch.ops._build import load_library

    lib = load_library()
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    n, n_pad, tile_rows, bits, ppw = _layout(h, w, kp)
    n_words = n_pad // ppw
    out = torch.empty((n_words // LANES, LANES), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        lut = gamma_lut(device)
        err = lib.kmeans_assign_packed(
            rgb_u8.data_ptr(), n, w,
            centroids_lab.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            lut.data_ptr(), thr.data_ptr(),
            int(mode == "dither"), int(row_offset),
            bits, tile_rows,
            out.data_ptr(), n_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "assign")
    ASSIGN_PACKED_LAUNCHES += 1
    return out


def _check_cuda_image(rgb_u8, centroids_lab, name: str) -> None:
    if rgb_u8.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {rgb_u8.device}")
    if centroids_lab.device != rgb_u8.device or centroids_lab.dtype != torch.float32:
        raise ValueError("centroids must be float32 on the image's device")
    if not (rgb_u8.is_contiguous() and centroids_lab.is_contiguous()):
        raise ValueError(f"{name} needs contiguous image and centroids")


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kmeans_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


# --- The meld pass -----------------------------------------------------------


def meld_packed_reference(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    k_active: int | None = None,
    metric: str = "cie94",
) -> torch.Tensor:
    """Plain PyTorch twin of the meld kernel, on any device: the meld
    output of `rgb_u8` (`[H, W, 3]` uint8) against `centroids_lab`
    (`[kp, 3]` Lab) as `[3 * n_pad // 4 // LANES, LANES]` int32 words of
    RGB bytes (layout in the module docstring).

    Per pixel (kmeans_tpu/ops/kernels.py:994-1054): the two closest of the
    first `k_active` centroids, carried with strict `<` (a new minimum
    displaces the closest into second place), which orders ties as
    `lax.top_k` does; `factor = sqrt(d2) / sqrt(d(closest, second))` with
    `d2` the carried squared distance to the second; the blend
    `factor * closest + (1 - factor) * second`; the first centroid when
    `k_active == 1`; Lab -> sRGB, `round(x * 255)` half to even. Two
    centroids of one colour make the blend NaN, which is written as 0, as
    the reference's float-to-integer conversion does."""
    k_active = _check_image_args(rgb_u8, centroids_lab, k_active, metric)
    device = rgb_u8.device
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    _, n_pad, tile_rows, _, _ = _layout(h, w, kp)
    cents = centroids_lab.to(device=device, dtype=torch.float32)

    l, a, b = _padded_lab(rgb_u8, n_pad)
    if k_active == 1:
        out = cents[0].expand(n_pad, 3)
    else:
        dist = _pixel_distances(l, a, b, cents, metric)
        d1 = torch.full_like(l, _BIG)
        d2 = torch.full_like(l, _BIG)
        k1 = torch.zeros(l.shape, dtype=torch.int64, device=device)
        k2 = torch.zeros_like(k1)
        for k in range(k_active):
            d = dist(k)
            first = d < d1
            second = ~first & (d < d2)
            d2 = torch.where(first, d1, torch.where(second, d, d2))
            k2 = torch.where(first, k1, torch.where(second, k, k2))
            d1 = torch.where(first, d, d1)
            k1 = torch.where(first, k, k1)
        _, dist_sq = metric_fns(metric)
        closest, second = cents[k1], cents[k2]
        factor = (torch.sqrt(d2) / torch.sqrt(dist_sq(closest, second)))[:, None]
        out = factor * closest + (1.0 - factor) * second
    rgb = torch.round(torch.nan_to_num(lab_to_srgb(out), nan=0.0) * 255.0).to(torch.int64)

    # Fold 4 sublane blocks of RGB into 3 words per tile row.
    blk = tile_rows // 4
    px = rgb.reshape(n_pad // (tile_rows * LANES), 4, blk, LANES, 3)
    r, g, bb = (px[..., c] for c in range(3))
    words = torch.stack([
        r[:, 0] | g[:, 0] << 8 | bb[:, 0] << 16 | r[:, 1] << 24,
        g[:, 1] | bb[:, 1] << 8 | r[:, 2] << 16 | g[:, 2] << 24,
        bb[:, 2] | r[:, 3] << 8 | g[:, 3] << 16 | bb[:, 3] << 24,
    ], dim=1)
    return _as_int32(words).reshape(-1, LANES)


def meld_packed(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    k_active: int | None = None,
    metric: str = "cie94",
) -> torch.Tensor:
    """RGB24-packed meld output of `rgb_u8`; see `meld_packed_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/quantize_meld.cu` on the current stream (built on first
    use) or raises. Any palette size whose centroids fit in a block's
    shared memory (about 14,000) takes one launch."""
    global MELD_PACKED_LAUNCHES
    if rgb_u8.device.type == "cpu":
        return meld_packed_reference(rgb_u8, centroids_lab, k_active, metric)
    k_active = _check_image_args(rgb_u8, centroids_lab, k_active, metric)
    _check_cuda_image(rgb_u8, centroids_lab, "meld_packed")

    from kmeans_tpu_torch.ops._build import load_library

    lib = load_library()
    device = rgb_u8.device
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    n, n_pad, tile_rows, _, _ = _layout(h, w, kp)
    n_groups = n_pad // 4
    out = torch.empty((3 * n_groups // LANES, LANES), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        lut = gamma_lut(device)
        err = lib.kmeans_meld_packed(
            rgb_u8.data_ptr(), n,
            centroids_lab.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            lut.data_ptr(), tile_rows,
            out.data_ptr(), n_groups,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "meld")
    MELD_PACKED_LAUNCHES += 1
    return out


# --- The Lloyd tile accumulator -------------------------------------------

# Plane layout row granule and largest palette of the tile accumulator
# (kmeans_tpu/ops/kernels.py:213,129). The CUDA kernel has no compile-time
# cap on k; the limit is kept so both packages refuse the same calls.
ACCUM_TILE_ROWS = 128
ACCUM_MAX_K = 512

# Launches of the CUDA kernel by `lloyd_accumulate` in this process.
LLOYD_ACCUMULATE_LAUNCHES = 0


def pack_lab_planes(lab: torch.Tensor, dtype: torch.dtype | None = None):
    """`[N, 3]` Lab -> `([3, M, 128]` planes, `N)`, zero-padded to a
    multiple of `ACCUM_TILE_ROWS * 128` pixels
    (kmeans_tpu/ops/kernels.py:1609). `dtype=torch.bfloat16` rounds the
    planes to nearest-even bfloat16, as the reference's `astype` does."""
    n = lab.shape[0]
    n_pad = _round_up(n, ACCUM_TILE_ROWS * LANES)
    padded = torch.zeros((n_pad, 3), dtype=lab.dtype, device=lab.device)
    padded[:n] = lab
    planes = padded.T.reshape(3, n_pad // LANES, LANES).contiguous()
    if dtype is not None and planes.dtype != dtype:
        planes = planes.to(dtype)
    return planes, n


def pack_plane(vec: torch.Tensor) -> torch.Tensor:
    """`[N]` -> zero-padded `[M, 128]` plane matching `pack_lab_planes`
    (kmeans_tpu/ops/kernels.py:1625)."""
    n = vec.shape[0]
    n_pad = _round_up(n, ACCUM_TILE_ROWS * LANES)
    out = torch.zeros(n_pad, dtype=vec.dtype, device=vec.device)
    out[:n] = vec
    return out.reshape(n_pad // LANES, LANES)


def _check_accum_args(lab_planes, centroids, n_valid, k_active, weight_planes,
                      metric, fast) -> int:
    """The reference's argument rules (kmeans_tpu/ops/kernels.py:1534-1544)
    for both versions; returns `k_active`."""
    _check_metric(metric)
    if fast:
        raise NotImplementedError(
            "the fast tile accumulator is not ported to the PyTorch package "
            "yet (ROADMAP B5)"
        )
    if centroids.dim() != 2 or centroids.shape[1] != 3:
        raise ValueError(f"expected [K, 3] centroids, got {tuple(centroids.shape)}")
    kp = centroids.shape[0]
    if kp > ACCUM_MAX_K:
        raise ValueError(f"training kernel supports k <= {ACCUM_MAX_K}")
    if lab_planes.dim() != 3 or lab_planes.shape[0] != 3 or lab_planes.shape[2] != LANES:
        raise ValueError(f"expected [3, M, {LANES}] planes, got {tuple(lab_planes.shape)}")
    if lab_planes.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {lab_planes.dtype}")
    m = lab_planes.shape[1]
    if m % ACCUM_TILE_ROWS != 0:
        raise ValueError(
            f"lab_planes rows ({m}) must be a multiple of {ACCUM_TILE_ROWS}; "
            "use pack_lab_planes"
        )
    if weight_planes is not None and tuple(weight_planes.shape) != (m, LANES):
        raise ValueError(
            f"weight_planes must be [{m}, {LANES}], got {tuple(weight_planes.shape)}"
        )
    if not 0 <= int(n_valid) <= m * LANES:
        raise ValueError(f"n_valid must be in [0, {m * LANES}], got {n_valid}")
    k_active = kp if k_active is None else int(k_active)
    if not 1 <= k_active <= kp:
        raise ValueError(f"k_active must be in [1, {kp}], got {k_active}")
    return k_active


def lloyd_accumulate_reference(
    lab_planes: torch.Tensor,
    centroids: torch.Tensor,
    n_valid: int,
    k_active: int | None = None,
    weight_planes: torch.Tensor | None = None,
    metric: str = "cie94",
    emit_inertia: bool = False,
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the tile accumulator, on any device: per-cluster
    `[kp, 4]` float32 totals (sum L, sum a, sum b, count) over the pixels
    with flat index `< n_valid`, each pixel added to its nearest of the
    first `k_active` centroids under exact `metric` (`"cie94"` or
    `"cie2000"`) (kmeans_tpu/ops/kernels.py:1270 `_lloyd_acc_kernel`). A weight plane
    scales each pixel's contribution; `emit_inertia=True` appends a fifth
    column, the weighted sum of each member's squared distance. bfloat16
    planes are widened to float32 before any arithmetic. The per-cluster
    sums are masked sums in a loop over clusters, as the reference does
    (`:1496-1506`): no scatter and no matrix product, so neither atomics
    nor TF32 can change them."""
    k_active = _check_accum_args(lab_planes, centroids, n_valid, k_active,
                                 weight_planes, metric, fast)
    kp = centroids.shape[0]
    planes = lab_planes.float().reshape(3, -1)
    l, a, b = planes[0], planes[1], planes[2]
    best_k, best_d = _argmin(l, a, b, centroids, k_active, metric)
    flat = torch.arange(l.shape[0], device=l.device)
    valid = flat < int(n_valid)
    w = None if weight_planes is None else weight_planes.float().reshape(-1)
    cols = [l, a, b, None] + ([best_d] if emit_inertia else [])
    out = torch.zeros((kp, len(cols)), dtype=torch.float32, device=l.device)
    for k in range(kp):
        maskf = ((best_k == k) & valid).to(torch.float32)
        if w is not None:
            maskf = maskf * w
        for s, col in enumerate(cols):
            out[k, s] = torch.sum(maskf if col is None else col * maskf)
    return out


def lloyd_accumulate(
    lab_planes: torch.Tensor,
    centroids: torch.Tensor,
    n_valid: int,
    k_active: int | None = None,
    weight_planes: torch.Tensor | None = None,
    metric: str = "cie94",
    emit_inertia: bool = False,
    fast: bool = False,
) -> torch.Tensor:
    """Per-cluster totals of one Lloyd step; see `lloyd_accumulate_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/lloyd_accumulate.cu` on the current stream (built on
    first use) or raises. The kernel's counts equal the twin's; its sums
    are taken in another, fixed order, so they agree to float32 rounding
    and are equal from run to run."""
    global LLOYD_ACCUMULATE_LAUNCHES
    if lab_planes.device.type == "cpu":
        return lloyd_accumulate_reference(
            lab_planes, centroids, n_valid, k_active, weight_planes, metric,
            emit_inertia, fast,
        )
    if lab_planes.device.type != "cuda":
        raise ValueError(f"lloyd_accumulate runs on cpu or cuda, not {lab_planes.device}")
    k_active = _check_accum_args(lab_planes, centroids, n_valid, k_active,
                                 weight_planes, metric, fast)
    device = lab_planes.device
    if centroids.device != device or centroids.dtype != torch.float32:
        raise ValueError("centroids must be float32 on the planes' device")
    if weight_planes is not None and (
        weight_planes.device != device or weight_planes.dtype != torch.float32
    ):
        raise ValueError("weight_planes must be float32 on the planes' device")
    tensors = [lab_planes, centroids] + ([] if weight_planes is None else [weight_planes])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lloyd_accumulate needs contiguous planes, centroids and weights")

    from kmeans_tpu_torch.ops._build import load_library

    lib = load_library()
    kp = centroids.shape[0]
    stats = 5 if emit_inertia else 4
    n_pix = lab_planes.shape[1] * LANES
    n_blocks = lib.kmeans_lloyd_grid_blocks(n_pix)
    partials = torch.empty((n_blocks, kp, stats), dtype=torch.float32, device=device)
    out = torch.empty((kp, stats), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.kmeans_lloyd_accumulate(
            lab_planes.data_ptr(), int(lab_planes.dtype == torch.bfloat16),
            n_pix, int(n_valid),
            centroids.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            None if weight_planes is None else weight_planes.data_ptr(),
            stats, partials.data_ptr(), n_blocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "accumulator")
    LLOYD_ACCUMULATE_LAUNCHES += 1
    return out
