"""The port's three CUDA kernels, each with its plain PyTorch twin.

1. The fused assign pass: u8 RGB -> packed palette indices. Port of
   `kmeans_tpu/ops/kernels.py::fused_assign_packed` (the Pallas
   `_quantize_kernel` in packed-index mode) for replace and dither under
   the exact CIE94 and CIEDE2000 metrics and, with `fast=True` at
   16 < kp <= 512, their fast tiers (below).
2. The meld pass: u8 RGB -> the blend of each pixel's two closest
   centroids, as RGB bytes packed into int32 words. Port of
   `fused_meld_packed` (the same Pallas kernel in meld mode with its
   in-kernel RGB24 pack), both metrics, exact and fast tiers.
3. The Lloyd tile accumulator: Lab planes -> per-cluster sums and counts
   of one Lloyd step. Port of `kmeans_tpu/ops/kernels.py::lloyd_accumulate`
   (the Pallas `_lloyd_acc_kernel`), both exact metrics and the fast
   forms.

The fast tiers (`fast=True`; opt-in, not bit-equal to exact):

- factorized CIE94 (`factor_mode`): the squared distance splits into a
  pixel-only term and a dot product of six pixel factors
  (`screen_factors`) with seven per-centroid features (`factor_g_table`).
  The pixel-only term cannot change an argmin, so the centroid loop
  computes only `screen_score`: six multiplies and six adds, no divide,
  no square root, no clamp. The sums are reassociated, so near-ties can
  pick another centroid than the exact form.
- pruned CIEDE2000 (`prune_mode`): the same score only ranks the
  centroids; a top-m insertion keeps the `prune_m_for(kp)` best per pixel
  and exact CIEDE2000 runs on those survivors alone. A true nearest
  centroid that the screen ranks below m is lost.
- the accumulator's algebraic CIE94 (`fast=True` with `emit_inertia=True`):
  `dl^2 + (da^2 + db^2) * rsh2 + dcab^2 * q` on the per-pixel reciprocals,
  a true squared distance for the inertia column.

The reference gathers per-lane table entries on the TPU through
128-lane row tables (`prune_c_table`, `prune_pal_table`, `prune_rows`,
`_table_gather`); a CUDA thread reads `cent[3 * idx]` from shared memory
and the twin indexes `cents[idx]`, so those helpers have no counterpart
here.

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
- `LAUNCHES_BY_MODE` counts kernel launches (never the twins' runs) by
  `(wrapper, metric, tier)`; `launches(wrapper)` sums one wrapper's.

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

import collections

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
# Below any masked screening score: a candidate slot whose score is not
# below this was never filled (kmeans_tpu/ops/kernels.py:905).
_BIG_HALF = 1.7e38

# The fast tiers engage at FAST_MIN_K < kp <= FAST_MAX_K
# (kmeans_tpu/ops/kernels.py:471, 496); outside it `fast` runs exact.
FAST_MIN_K = 16
FAST_MAX_K = 512
# Candidates the pruned CIEDE2000 tier keeps per pixel: PRUNE_M up to
# PRUNE_M_GATE centroids, PRUNE_M_LARGE above (kmeans_tpu/ops/kernels.py:145).
PRUNE_M = 8
PRUNE_M_LARGE = 16
PRUNE_M_GATE = 128

# The metrics the kernels take, by the integer code they pass to CUDA.
KERNEL_METRICS = {"cie94": 0, "cie2000": 1}
# The tiers by the integer code they pass to CUDA (csrc/screen.cuh).
KERNEL_TIERS = {"exact": 0, "factor": 1, "algebraic": 2, "prune": 3}

# Launches of the CUDA kernels in this process by `(wrapper name, metric,
# tier)`: each wrapper adds one where it launches its kernel, so the key
# says which kernel instance a path went through.
LAUNCHES_BY_MODE: collections.Counter = collections.Counter()


def launches(wrapper: str) -> int:
    """Kernel launches by `wrapper` ("assign_packed", "meld_packed" or
    "lloyd_accumulate") since `LAUNCHES_BY_MODE` was last cleared."""
    return sum(n for key, n in LAUNCHES_BY_MODE.items() if key[0] == wrapper)


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


def factor_mode(fast: bool, metric: str, kp: int) -> bool:
    """Whether the assign and meld passes run the factorized CIE94 score
    (kmeans_tpu/ops/kernels.py:462). Keyed on the palette size; past
    `FAST_MAX_K`, `fast` runs the exact loop."""
    return bool(fast) and metric == "cie94" and FAST_MIN_K < kp <= FAST_MAX_K


def prune_mode(fast: bool, metric: str, kp: int) -> bool:
    """Whether a pass runs the pruned CIEDE2000 tier: the assign and meld
    passes and the accumulator alike (kmeans_tpu/ops/kernels.py:485)."""
    return bool(fast) and metric == "cie2000" and FAST_MIN_K < kp <= FAST_MAX_K


def prune_m_for(kp: int) -> int:
    """Candidates the pruned tier keeps for a palette of `kp` entries."""
    return PRUNE_M if kp <= PRUNE_M_GATE else PRUNE_M_LARGE


def assign_tier(fast: bool, metric: str, kp: int) -> str:
    """The distance tier of the assign and meld passes: `"factor"`,
    `"prune"` or `"exact"`. Wrapper, twin and kernel launcher all take it
    from here."""
    if factor_mode(fast, metric, kp):
        return "factor"
    return "prune" if prune_mode(fast, metric, kp) else "exact"


def accum_tier(fast: bool, metric: str, kp: int, emit_inertia: bool) -> str:
    """The distance tier of the accumulator
    (kmeans_tpu/ops/kernels.py:1325-1326): pruned CIEDE2000 by
    `prune_mode`; under CIE94 `fast` means the factorized score, or with
    the inertia column the algebraic distance, at any `kp` (the k > 16
    gate of training lives in `models/kmeans.py::lloyd_accumulated`)."""
    if prune_mode(fast, metric, kp):
        return "prune"
    if fast and metric == "cie94":
        return "algebraic" if emit_inertia else "factor"
    return "exact"


def factor_g_table(centroids_lab: torch.Tensor) -> torch.Tensor:
    """Per-centroid rows `[kp, 7]` of the factorized score:
    `[L2, L2^2, C2, C2 * C2, a2, b2, a2^2 + b2^2]` with
    `C2 = sqrt(a2^2 + b2^2)` (kmeans_tpu/ops/kernels.py:474). Column 3 is
    the square of the rounded root, column 6 the sum itself: different
    bits. Built once per call, outside the kernel, on the centroids'
    device, so the kernel and its twin read the same seven floats."""
    c = centroids_lab.to(torch.float32)
    l2, a2, b2 = c[:, 0], c[:, 1], c[:, 2]
    ab2 = a2 * a2 + b2 * b2
    c2 = torch.sqrt(ab2)
    return torch.stack([l2, l2 * l2, c2, c2 * c2, a2, b2, ab2], dim=1).contiguous()


def screen_factors(l, a, b, c1):
    """Pixel-side factors `(rsh2, q, f0, f2, f4, f5)` of the factorized
    CIE94 score (kmeans_tpu/ops/kernels.py:558): with `sc = 1 + K1 c1`,
    `sh = 1 + K2 c1`: `rsh2 = 1 / (sh sh)`, `q = 1 / (sc sc) - rsh2`,
    `f0 = -2 L`, `f2 = -2 c1 q`, `f4 = -2 a rsh2`, `f5 = -2 b rsh2`. The
    two reciprocals are true divisions."""
    sc = 1.0 + _K1 * c1
    sh = 1.0 + _K2 * c1
    one = const(1.0, c1)
    rsh2 = torch.div(one, sh * sh)
    q = torch.div(one, sc * sc) - rsh2
    return rsh2, q, -2.0 * l, -2.0 * c1 * q, -2.0 * a * rsh2, -2.0 * b * rsh2


def screen_score(factors, g):
    """The factorized score of each pixel against one centroid's row `g`
    of `factor_g_table` (kmeans_tpu/ops/kernels.py:580), summed left to
    right, each product rounded before its add:
    `f0 g0 + g1 + f2 g2 + q g3 + f4 g4 + f5 g5 + rsh2 g6`. It equals the
    squared CIE94 distance less a term of the pixel alone (and less the
    exact form's clamp), so it ranks centroids but is no distance."""
    rsh2, q, f0, f2, f4, f5 = factors
    s = f0 * g[0]
    s = s + g[1]
    s = s + f2 * g[2]
    s = s + q * g[3]
    s = s + f4 * g[4]
    s = s + f5 * g[5]
    return s + rsh2 * g[6]


def _screen_fn(l, a, b, c1, cents):
    """`score(k)`: the factorized score of each pixel to centroid `k`."""
    gtab = factor_g_table(cents)
    factors = screen_factors(l, a, b, c1)
    return lambda k: screen_score(factors, gtab[k])


def _algebraic_fn(l, a, b, c1, cents):
    """`d(k)`: the accumulator's divide-free CIE94 distance
    (kmeans_tpu/ops/kernels.py:1369-1385),
    `dl^2 + (da^2 + db^2) rsh2 + dcab^2 q`, without the exact form's
    clamp: a true squared distance, rounded otherwise."""
    rsh2, q = screen_factors(l, a, b, c1)[:2]
    chroma = torch.sqrt(cents[:, 1] * cents[:, 1] + cents[:, 2] * cents[:, 2])

    def d(k):
        dl = l - cents[k, 0]
        da = a - cents[k, 1]
        db = b - cents[k, 2]
        dcab = c1 - chroma[k]
        return dl * dl + (da * da + db * db) * rsh2 + dcab * dcab * q

    return d


def _prune_screen(score, k_active: int, m: int, like: torch.Tensor):
    """Pass 1 of the pruned tier (kmeans_tpu/ops/kernels.py:624): the `m`
    best of the first `k_active` centroids by `score`, as `(cand_d,
    cand_i)`, two lists of `m` planes in rank order. Each centroid walks
    the list once; at each slot a strictly smaller score takes the slot
    and pushes the holder on, so equal scores keep the lower index first.
    Slots never filled keep `_BIG` and index 0. (The reference walks all
    `kp` centroids with those `>= k_active` scored `_BIG`, which no slot
    ever takes: the same lists.)"""
    cand_d = [torch.full_like(like, _BIG) for _ in range(m)]
    cand_i = [torch.zeros(like.shape, dtype=torch.int64, device=like.device) for _ in range(m)]
    for k in range(k_active):
        sd = score(k)
        si = torch.full_like(cand_i[0], k)
        for j in range(m):
            take = sd < cand_d[j]
            nd = torch.where(take, sd, cand_d[j])
            ni = torch.where(take, si, cand_i[j])
            sd = torch.where(take, cand_d[j], sd)
            si = torch.where(take, cand_i[j], si)
            cand_d[j], cand_i[j] = nd, ni
    return cand_d, cand_i


def _pruned_candidates(l, a, b, c1, cents, k_active: int):
    """The pruned tier's survivors in screening-rank order: a list of
    `(d, idx)` with `d` the exact squared CIEDE2000 distance to centroid
    `idx`, `_BIG` where the slot was never filled
    (kmeans_tpu/ops/kernels.py:903-916)."""
    kp = cents.shape[0]
    m = min(prune_m_for(kp), kp)
    cand_d, cand_i = _prune_screen(_screen_fn(l, a, b, c1, cents), k_active, m, l)
    out = []
    for sd, idx in zip(cand_d, cand_i):
        c = cents[idx]
        d = cie2000_sq_planes(l, a, b, c[:, 0], c[:, 1], c[:, 2], c1=c1)
        out.append((torch.where(sd < _BIG_HALF, d, torch.full_like(d, _BIG)), idx))
    return out


def _argmin(l, a, b, centroids_lab, k_active: int, metric: str = "cie94",
            tier: str = "exact"):
    """Nearest of the first `k_active` centroids to each pixel:
    `(best_k int64, best_d float32)`, strict `<` so the first minimum
    wins. `tier`: `"exact"`; `"factor"` (`best_d` is the factorized score,
    a rank); `"algebraic"`; or `"prune"`, where the winner is the least
    exact distance among the survivors, visited in screening-rank order,
    so a tie goes to the better rank, not the lower index
    (kmeans_tpu/ops/kernels.py:918-936)."""
    cents = centroids_lab.to(device=l.device, dtype=torch.float32)
    best_d = torch.full_like(l, _BIG)
    best_k = torch.zeros(l.shape, dtype=torch.int64, device=l.device)
    if tier == "prune":
        c1 = torch.sqrt(a * a + b * b)
        for d, idx in _pruned_candidates(l, a, b, c1, cents, k_active):
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_k = torch.where(take, idx, best_k)
        return best_k, best_d
    if tier == "exact":
        dist = _pixel_distances(l, a, b, cents, metric)
    else:
        c1 = torch.sqrt(a * a + b * b)
        dist = (_screen_fn if tier == "factor" else _algebraic_fn)(l, a, b, c1, cents)
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
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the assign kernel, on any device: packed
    `[n_pad // LANES // ppw, LANES]` int32 palette indices of `rgb_u8`
    (`[H, W, 3]` uint8) against `centroids_lab` (`[kp, 3]` Lab), under
    `metric` (`"cie94"` or `"cie2000"`), strict `<` so the first minimum
    wins, centroids `>= k_active` masked. In dither mode each pixel's Lab
    is first moved by `threshold * (M4[y % 4][x % 4] / 16 - 0.5)`, with `y`
    shifted by `row_offset`. `fast=True` picks the tier of `assign_tier`:
    the argmin of the factorized score under CIE94, the pruned tier under
    CIEDE2000, the exact loop at `kp <= 16` and `kp > 512`."""
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

    best_k, _ = _argmin(l, a, b, centroids_lab, k_active, metric,
                        assign_tier(fast, metric, kp))

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
    fast: bool = False,
) -> torch.Tensor:
    """Packed palette indices of `rgb_u8`; see `assign_packed_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/quantize_assign.cu` on the current stream (built on
    first use) or raises. `threshold` is a float or a one-element float32
    tensor on the image's device (it stays there: no host round trip)."""
    if rgb_u8.device.type == "cpu":
        return assign_packed_reference(
            rgb_u8, centroids_lab, threshold, k_active, mode, row_offset, metric, fast
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
        tier = assign_tier(fast, metric, kp)
        code, gtab = _tier_operands(tier, centroids_lab)
        err = lib.kmeans_assign_packed(
            rgb_u8.data_ptr(), n, w,
            centroids_lab.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            code, None if gtab is None else gtab.data_ptr(), prune_m_for(kp),
            lut.data_ptr(), thr.data_ptr(),
            int(mode == "dither"), int(row_offset),
            bits, tile_rows,
            out.data_ptr(), n_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "assign")
    LAUNCHES_BY_MODE["assign_packed", metric, tier] += 1
    return out


def _tier_operands(tier: str, centroids: torch.Tensor):
    """`(tier code, G-table or None)` of a launch: the factorized and the
    pruned tiers read `factor_g_table(centroids)`, built here on the
    centroids' device."""
    gtab = factor_g_table(centroids) if tier in ("factor", "prune") else None
    return KERNEL_TIERS[tier], gtab


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
    fast: bool = False,
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
    the reference's float-to-integer conversion does.

    `fast=True` picks the tier of `assign_tier`. Factorized CIE94: the
    loop carries the factorized score, which only ranks, so `d2` is
    recomputed as the exact CIE94 distance from the pixel to the second
    (`:1033-1034`). Pruned CIEDE2000: the same carry over the survivors
    in screening-rank order, on their exact distances (`:1010-1018`)."""
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
        tier = assign_tier(fast, metric, kp)
        c1 = torch.sqrt(a * a + b * b)
        if tier == "prune":
            scored = _pruned_candidates(l, a, b, c1, cents, k_active)
        else:
            dist = (_screen_fn(l, a, b, c1, cents) if tier == "factor"
                    else _pixel_distances(l, a, b, cents, metric))
            scored = ((dist(k), k) for k in range(k_active))
        d1 = torch.full_like(l, _BIG)
        d2 = torch.full_like(l, _BIG)
        k1 = torch.zeros(l.shape, dtype=torch.int64, device=device)
        k2 = torch.zeros_like(k1)
        for d, k in scored:
            first = d < d1
            second = ~first & (d < d2)
            d2 = torch.where(first, d1, torch.where(second, d, d2))
            k2 = torch.where(first, k1, torch.where(second, k, k2))
            d1 = torch.where(first, d, d1)
            k1 = torch.where(first, k, k1)
        _, dist_sq = metric_fns(metric)
        closest, second = cents[k1], cents[k2]
        if tier == "factor":
            d2 = dist_sq(torch.stack([l, a, b], dim=1), second)
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
    fast: bool = False,
) -> torch.Tensor:
    """RGB24-packed meld output of `rgb_u8`; see `meld_packed_reference`
    for the contract. A CPU tensor runs the plain twin. A CUDA tensor
    launches `csrc/quantize_meld.cu` on the current stream (built on first
    use) or raises. Any palette size whose centroids fit in a block's
    shared memory (about 14,000) takes one launch."""
    if rgb_u8.device.type == "cpu":
        return meld_packed_reference(rgb_u8, centroids_lab, k_active, metric, fast)
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
        tier = assign_tier(fast, metric, kp)
        code, gtab = _tier_operands(tier, centroids_lab)
        err = lib.kmeans_meld_packed(
            rgb_u8.data_ptr(), n,
            centroids_lab.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            code, None if gtab is None else gtab.data_ptr(), prune_m_for(kp),
            lut.data_ptr(), tile_rows,
            out.data_ptr(), n_groups,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "meld")
    LAUNCHES_BY_MODE["meld_packed", metric, tier] += 1
    return out


# --- The Lloyd tile accumulator -------------------------------------------

# Plane layout row granule and largest palette of the tile accumulator
# (kmeans_tpu/ops/kernels.py:213,129). The CUDA kernel has no compile-time
# cap on k; the limit is kept so both packages refuse the same calls.
ACCUM_TILE_ROWS = 128
ACCUM_MAX_K = 512


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
                      metric) -> int:
    """The reference's argument rules (kmeans_tpu/ops/kernels.py:1534-1544)
    for both versions; returns `k_active`."""
    _check_metric(metric)
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
    first `k_active` centroids under `metric` (`"cie94"` or `"cie2000"`)
    (kmeans_tpu/ops/kernels.py:1270 `_lloyd_acc_kernel`), exact or, with
    `fast=True`, by the tier of `accum_tier`: the factorized CIE94 score,
    with `emit_inertia` the algebraic CIE94 distance, or at 16 < kp <= 512
    the pruned CIEDE2000 tier. A weight plane
    scales each pixel's contribution; `emit_inertia=True` appends a fifth
    column, the weighted sum of each member's squared distance. bfloat16
    planes are widened to float32 before any arithmetic. The per-cluster
    sums are masked sums in a loop over clusters, as the reference does
    (`:1496-1506`): no scatter and no matrix product, so neither atomics
    nor TF32 can change them."""
    k_active = _check_accum_args(lab_planes, centroids, n_valid, k_active,
                                 weight_planes, metric)
    kp = centroids.shape[0]
    planes = lab_planes.float().reshape(3, -1)
    l, a, b = planes[0], planes[1], planes[2]
    best_k, best_d = _argmin(l, a, b, centroids, k_active, metric,
                             accum_tier(fast, metric, kp, emit_inertia))
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
    if lab_planes.device.type == "cpu":
        return lloyd_accumulate_reference(
            lab_planes, centroids, n_valid, k_active, weight_planes, metric,
            emit_inertia, fast,
        )
    if lab_planes.device.type != "cuda":
        raise ValueError(f"lloyd_accumulate runs on cpu or cuda, not {lab_planes.device}")
    k_active = _check_accum_args(lab_planes, centroids, n_valid, k_active,
                                 weight_planes, metric)
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
        tier = accum_tier(fast, metric, kp, emit_inertia)
        code, gtab = _tier_operands(tier, centroids)
        err = lib.kmeans_lloyd_accumulate(
            lab_planes.data_ptr(), int(lab_planes.dtype == torch.bfloat16),
            n_pix, int(n_valid),
            centroids.data_ptr(), kp, k_active, KERNEL_METRICS[metric],
            code, None if gtab is None else gtab.data_ptr(), prune_m_for(kp),
            None if weight_planes is None else weight_planes.data_ptr(),
            stats, partials.data_ptr(), n_blocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, "accumulator")
    LAUNCHES_BY_MODE["lloyd_accumulate", metric, tier] += 1
    return out
