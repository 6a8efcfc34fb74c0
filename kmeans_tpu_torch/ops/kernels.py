"""The fused assign pass: u8 RGB -> packed palette indices.

Port of `kmeans_tpu/ops/kernels.py::fused_assign_packed` (the Pallas
`_quantize_kernel` in packed-index mode) for replace and dither under the
exact CIE94 metric.

- `assign_packed` is the wrapper. A tensor on the CPU goes to
  `assign_packed_reference`; a CUDA tensor launches the hand-written kernel
  `csrc/quantize_assign.cu`, or raises. There is no fallback between them.
- `assign_packed_reference` is the kernel's plain PyTorch twin: the same
  float32 operations in the same order and the same word layout. It is the
  spec the tests hold to the JAX package, and the version the kernel is
  compared with on the card.
- `ASSIGN_PACKED_LAUNCHES` counts kernel launches (never the twin's runs).

Word layout: the image is flattened and zero-padded to
`n_pad = round_up(h * w, quant_tile_rows(kp) * LANES)` pixels. With
`bits = pack_bits(kp)`, `ppw = 32 // bits` and `blk = tile_rows // ppw`, the
output is `[n_pad // LANES // ppw, LANES]` int32, and word `(t * blk + r, l)`
holds pixel `((t * tile_rows) + j * blk + r) * LANES + l` at bit `bits * j`.
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops._math import const
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
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

# Launches of the CUDA kernel by `assign_packed` in this process.
ASSIGN_PACKED_LAUNCHES = 0


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


def _check_args(rgb_u8, centroids_lab, k_active, mode) -> int:
    """Validate what both versions take; return `k_active`."""
    if mode == "meld":
        raise NotImplementedError(
            "meld is not ported to the PyTorch package yet (ROADMAP B3)"
        )
    if mode not in ("replace", "dither"):
        raise ValueError(f"assign_packed supports replace/dither, got {mode!r}")
    if rgb_u8.dtype != torch.uint8 or rgb_u8.dim() != 3 or rgb_u8.shape[-1] != 3:
        raise ValueError(
            f"expected [H, W, 3] uint8 RGB, got {tuple(rgb_u8.shape)} {rgb_u8.dtype}"
        )
    if centroids_lab.dim() != 2 or centroids_lab.shape[1] != 3:
        raise ValueError(f"expected [K, 3] centroids, got {tuple(centroids_lab.shape)}")
    kp = centroids_lab.shape[0]
    if kp > INDEXED_MAX_K:
        raise NotImplementedError(
            f"k = {kp} > {INDEXED_MAX_K}: the packed-index output serves "
            f"k <= {INDEXED_MAX_K} (larger palettes: ROADMAP B2/B8)"
        )
    k_active = kp if k_active is None else int(k_active)
    if not 1 <= k_active <= kp:
        raise ValueError(f"k_active must be in [1, {kp}], got {k_active}")
    return k_active


def assign_packed_reference(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch twin of the assign kernel, on any device: packed
    `[n_pad // LANES // ppw, LANES]` int32 palette indices of `rgb_u8`
    (`[H, W, 3]` uint8) against `centroids_lab` (`[kp, 3]` Lab), CIE94,
    strict `<` so the first minimum wins, centroids `>= k_active` masked.
    In dither mode each pixel's Lab is first moved by
    `threshold * (M4[y % 4][x % 4] / 16 - 0.5)`, with `y` shifted by
    `row_offset`."""
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode)
    device = rgb_u8.device
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    n, n_pad, tile_rows, bits, ppw = _layout(h, w, kp)

    rgb = torch.zeros((n_pad, 3), dtype=torch.uint8, device=device)
    rgb[:n] = rgb_u8.reshape(n, 3)
    lab = srgb8_to_lab(rgb)
    l, a, b = lab[:, 0], lab[:, 1], lab[:, 2]
    if mode == "dither":
        flat = torch.arange(n_pad, dtype=torch.int64, device=device)
        px = flat % w
        py = flat // w + row_offset
        m = torch.tensor(BAYER_4X4, dtype=torch.float32, device=device)
        bayer = torch.div(m, const(16.0, m)) - 0.5
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=device)
        adjust = thr * bayer[py % 4, px % 4]
        l, a, b = l + adjust, a + adjust, b + adjust

    # Pixel-side CIE94 terms, hoisted out of the centroid loop like the
    # kernel (kmeans_tpu/ops/kernels.py:823-826,849-857).
    c1 = torch.sqrt(a * a + b * b)
    sc = 1.0 + _K1 * c1
    sh = 1.0 + _K2 * c1
    sh2 = sh * sh
    cents = centroids_lab.to(device=device, dtype=torch.float32)
    chroma = torch.sqrt(cents[:, 1] * cents[:, 1] + cents[:, 2] * cents[:, 2])
    best_d = torch.full_like(l, _BIG)
    best_k = torch.zeros(n_pad, dtype=torch.int64, device=device)
    for k in range(k_active):
        dl = l - cents[k, 0]
        da = a - cents[k, 1]
        db = b - cents[k, 2]
        dcab = c1 - chroma[k]
        dhab_sq = torch.clamp(da * da + db * db - dcab * dcab, min=0.0)
        t = dcab / sc
        d = dl * dl + t * t + dhab_sq / sh2
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_k = torch.where(take, k, best_k)

    # Fold ppw sublane blocks of each tile into one word.
    blk = tile_rows // ppw
    idx = best_k.reshape(n_pad // (tile_rows * LANES), ppw, blk, LANES)
    shifts = (torch.arange(ppw, device=device) * bits).reshape(1, ppw, 1, 1)
    words = (idx << shifts).sum(dim=1)  # disjoint bit fields: sum == or
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.reshape(-1, LANES).to(torch.int32)


def assign_packed(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
) -> torch.Tensor:
    """Packed palette indices of `rgb_u8`; see `assign_packed_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/quantize_assign.cu` on the current stream (built on
    first use) or raises. `threshold` is a float or a one-element float32
    tensor on the image's device (it stays there: no host round trip)."""
    global ASSIGN_PACKED_LAUNCHES
    if rgb_u8.device.type == "cpu":
        return assign_packed_reference(
            rgb_u8, centroids_lab, threshold, k_active, mode, row_offset
        )
    if rgb_u8.device.type != "cuda":
        raise ValueError(f"assign_packed runs on cpu or cuda, not {rgb_u8.device}")
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode)
    device = rgb_u8.device
    if centroids_lab.device != device or centroids_lab.dtype != torch.float32:
        raise ValueError("centroids must be float32 on the image's device")
    if not (rgb_u8.is_contiguous() and centroids_lab.is_contiguous()):
        raise ValueError("assign_packed needs contiguous image and centroids")
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
            centroids_lab.data_ptr(), kp, k_active,
            lut.data_ptr(), thr.data_ptr(),
            int(mode == "dither"), int(row_offset),
            bits, tile_rows,
            out.data_ptr(), n_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        msg = lib.kmeans_error_string(err).decode()
        raise RuntimeError(f"assign kernel launch failed: CUDA error {err} ({msg})")
    ASSIGN_PACKED_LAUNCHES += 1
    return out
