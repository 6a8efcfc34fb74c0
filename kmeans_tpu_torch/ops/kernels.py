"""The port's three CUDA kernels, each with its plain PyTorch twin.

1. The fused assign pass: u8 RGB -> the nearest palette entry of each
   pixel, for replace and dither under the exact CIE94 and CIEDE2000
   metrics and, with `fast=True` at 16 < kp <= 512, their fast tiers
   (below). Port of the Pallas `_quantize_kernel`
   (`kmeans_tpu/ops/kernels.py`) in three output forms: packed palette
   indices (`assign_packed`, port of `fused_assign_packed`, kp <= 1024),
   the palette colour as RGBA (`quantize_rgba`, port of `fused_quantize`,
   any kp in one launch, where the reference splits kp > 1024 into
   halves), and the u8 index (`assign_u8`, port of `fused_assign`,
   kp <= 256); and its frames batch (`assign_frames_packed`,
   `quantize_frames`, port of `_run_quantize_kernel_frames`): B frames,
   each with its own palette, `k_active` and dither threshold, in one
   launch.
2. The meld pass: u8 RGB -> the blend of each pixel's two closest
   centroids, as RGB bytes packed into int32 words. Port of
   `fused_meld_packed` (the same Pallas kernel in meld mode with its
   in-kernel RGB24 pack), both metrics, exact and fast tiers, any kp in
   one launch; and its frames batch (`meld_frames_packed`, port of
   `fused_meld_frames_packed`).
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

- the wrapper (`assign_packed`, `quantize_rgba`, `assign_u8`,
  `assign_frames_packed`, `quantize_frames`, `meld_packed`,
  `meld_frames_packed`, `lloyd_accumulate`) runs the plain twin on a CPU
  tensor and launches the hand-written kernel (`csrc/quantize_assign.cu`,
  `csrc/quantize_meld.cu`, `csrc/lloyd_accumulate.cu`) on a CUDA tensor,
  or raises. There is no fallback between them.
- the twin (`*_reference`) repeats the kernel's float32 operations in the
  same order with the same output layout; a frames twin is the
  single-image twin applied frame by frame and stacked. It is the spec
  the tests hold to the JAX package, and the version the kernel is
  compared with on the card. The distances are those of `ops/delta_e.py`, with the pixel-side
  terms hoisted out of the centroid loop (`_pixel_distances`); the CUDA
  kernels share them through `csrc/delta_e.cuh`.
- `LAUNCHES_BY_MODE` counts kernel launches (never the twins' runs) by
  `(wrapper, metric, tier)`, the tier `"exact-chunked"` where a palette
  past `STAGE_CHUNK` took the chunked instance; `launches(wrapper)` sums
  one wrapper's.

Assign word layout: the image is flattened and zero-padded to
`n_pad = round_up(h * w, quant_tile_rows(kp) * LANES)` pixels. With
`bits = pack_bits(kp)`, `ppw = 32 // bits` and `blk = tile_rows // ppw`, the
output is `[n_pad // LANES // ppw, LANES]` int32, and word `(t * blk + r, l)`
holds pixel `((t * tile_rows) + j * blk + r) * LANES + l` at bit `bits * j`.

RGBA and u8 layout: `[n_pad]` words or bytes in pixel order, of which the
first `h * w` are the image. Frames: `[B, ...]`, frame `f` the layout of
a single image of the frame's shape.

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
from kmeans_tpu_torch.ops.colorspace import lab_to_srgb, lab_to_srgb8, srgb8_to_lab
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

# Centroids a block of the assign (RGBA, u8) and meld kernels stages in
# shared memory at a time under the exact tier: a larger palette takes the
# kernels' chunked instances, in one launch (83 KB of shared memory at most).
STAGE_CHUNK = 4096
# The assign kernel's output forms by the code they pass to CUDA.
ASSIGN_OUTPUTS = {"packed": 0, "rgba": 1, "u8": 2}

# The metrics the kernels take, by the integer code they pass to CUDA.
KERNEL_METRICS = {"cie94": 0, "cie2000": 1}
# The tiers by the integer code they pass to CUDA (csrc/screen.cuh).
KERNEL_TIERS = {"exact": 0, "factor": 1, "algebraic": 2, "prune": 3}

# Launches of the CUDA kernels in this process by `(wrapper name, metric,
# tier)`: each wrapper adds one where it launches its kernel, so the key
# says which kernel instance a path went through.
LAUNCHES_BY_MODE: collections.Counter = collections.Counter()


def launches(wrapper: str) -> int:
    """Kernel launches by `wrapper` (a key's first field: "assign_packed",
    "meld_packed", "lloyd_accumulate", "dither_threshold", ...) since
    `LAUNCHES_BY_MODE` was last cleared."""
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


def _check_args(rgb_u8, centroids_lab, k_active, mode, metric, name="assign_packed",
                max_k: int | None = INDEXED_MAX_K) -> int:
    """Validate what the replace/dither versions take; return `k_active`.
    `max_k` is the largest palette the output form serves (None: any)."""
    if mode not in ("replace", "dither"):
        raise ValueError(f"{name} supports replace/dither, got {mode!r}"
                         + ("; meld is meld_packed" if mode == "meld" else ""))
    if max_k is not None and centroids_lab.dim() == 2 and centroids_lab.shape[0] > max_k:
        raise ValueError(
            f"k = {centroids_lab.shape[0]} > {max_k}: {name} serves k <= {max_k} "
            "(quantize_rgba serves any k)"
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
    """Per-centroid rows `[..., kp, 7]` of the factorized score:
    `[L2, L2^2, C2, C2 * C2, a2, b2, a2^2 + b2^2]` with
    `C2 = sqrt(a2^2 + b2^2)` (kmeans_tpu/ops/kernels.py:474). Column 3 is
    the square of the rounded root, column 6 the sum itself: different
    bits. Built once per call, outside the kernel, on the centroids'
    device, so the kernel and its twin read the same seven floats."""
    c = centroids_lab.to(torch.float32)
    l2, a2, b2 = c[..., 0], c[..., 1], c[..., 2]
    ab2 = a2 * a2 + b2 * b2
    c2 = torch.sqrt(ab2)
    return torch.stack([l2, l2 * l2, c2, c2 * c2, a2, b2, ab2], dim=-1).contiguous()


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


def packed_palette(centroids_lab: torch.Tensor) -> torch.Tensor:
    """Lab centroids `[..., kp, 3]` -> their colours as packed RGBA int32
    words `[..., kp]`, R in the low byte, alpha 255
    (kmeans_tpu/ops/kernels.py:1091 `_packed_palette`), converted by the
    `lab_to_srgb8` that `api._lab_palette_to_u8` uses. Built by torch ops
    outside the kernel, so the RGBA kernel and its twin select the same
    words."""
    rgb8 = lab_to_srgb8(centroids_lab).to(torch.int32)
    return rgb8[..., 0] | (rgb8[..., 1] << 8) | (rgb8[..., 2] << 16) | -16777216


def _nearest_reference(rgb_u8, centroids_lab, threshold, k_active, mode, row_offset,
                       metric, fast):
    """The assign twins' common pass: `(best_k [n_pad] int64, layout)`,
    the nearest of the first `k_active` centroids to each padded pixel
    (dither-adjusted in dither mode), by the tier of `assign_tier`."""
    device = rgb_u8.device
    h, w = rgb_u8.shape[0], rgb_u8.shape[1]
    kp = centroids_lab.shape[0]
    layout = _layout(h, w, kp)
    n_pad = layout[1]
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
    return best_k, layout


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
    (`[H, W, 3]` uint8) against `centroids_lab` (`[kp, 3]` Lab, kp <= 1024),
    under `metric` (`"cie94"` or `"cie2000"`), strict `<` so the first
    minimum wins, centroids `>= k_active` masked. In dither mode each
    pixel's Lab is first moved by `threshold * (M4[y % 4][x % 4] / 16 - 0.5)`,
    with `y` shifted by `row_offset`. `fast=True` picks the tier of
    `assign_tier`: the argmin of the factorized score under CIE94, the
    pruned tier under CIEDE2000, the exact loop at `kp <= 16` and
    `kp > 512`."""
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric)
    best_k, (_, n_pad, tile_rows, bits, ppw) = _nearest_reference(
        rgb_u8, centroids_lab, threshold, k_active, mode, row_offset, metric, fast)
    # Fold ppw sublane blocks of each tile into one word.
    blk = tile_rows // ppw
    idx = best_k.reshape(n_pad // (tile_rows * LANES), ppw, blk, LANES)
    shifts = (torch.arange(ppw, device=rgb_u8.device) * bits).reshape(1, ppw, 1, 1)
    words = (idx << shifts).sum(dim=1)  # disjoint bit fields: sum == or
    return _as_int32(words).reshape(-1, LANES)


def quantize_rgba_reference(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the assign kernel's colour-out mode: the
    `[H, W, 4]` uint8 RGBA image whose pixel is the `packed_palette` word of
    its `assign_packed_reference` index, at any palette size
    (kmeans_tpu/ops/kernels.py:1104 `fused_quantize`)."""
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric, "quantize_rgba",
                           max_k=None)
    best_k, (n, *_) = _nearest_reference(rgb_u8, centroids_lab, threshold, k_active, mode,
                                         row_offset, metric, fast)
    words = packed_palette(centroids_lab.to(rgb_u8.device))[best_k[:n]]
    return words.view(torch.uint8).reshape(rgb_u8.shape[0], rgb_u8.shape[1], 4)


def assign_u8_reference(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the assign kernel's u8-index mode: the
    `[H, W]` uint8 palette index of each pixel, kp <= 256
    (kmeans_tpu/ops/kernels.py:1635 `fused_assign`)."""
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric, "assign_u8",
                           max_k=256)
    best_k, (n, *_) = _nearest_reference(rgb_u8, centroids_lab, threshold, k_active, mode,
                                         row_offset, metric, fast)
    return best_k[:n].to(torch.uint8).reshape(rgb_u8.shape[0], rgb_u8.shape[1])


def _thresholds(threshold, frames: int, device) -> torch.Tensor:
    """`[frames]` float32 dither thresholds on `device` from a float, a
    sequence of floats, or a float32 tensor of `frames` values already on
    `device` (it stays there: no host round trip)."""
    if isinstance(threshold, torch.Tensor):
        if threshold.device != device or threshold.dtype != torch.float32:
            raise ValueError("threshold must be float32 on the image's device")
        if threshold.numel() != frames:
            raise ValueError(f"threshold must hold {frames} value(s)")
        return threshold.reshape(frames).contiguous()
    if isinstance(threshold, (int, float)):
        return torch.full((frames,), float(threshold), dtype=torch.float32, device=device)
    values = [float(t) for t in threshold]
    if len(values) != frames:
        raise ValueError(f"threshold must hold {frames} value(s)")
    return torch.tensor(values, dtype=torch.float32).to(device)


def _launch_assign(name, frames_u8, centroids_lab, threshold, k_actives, mode, row_offset,
                   metric, fast, out_mode):
    """Launch `csrc/quantize_assign.cu` over `frames_u8` (`[B, H, W, 3]`
    uint8 on a CUDA device, contiguous, or one image expanded along B) with
    the palettes `centroids_lab` (`[B, kp, 3]`) and `k_actives` (None: kp in
    every frame; else B ints, checked by the caller). Returns `(out, n)`:
    `[B, n_words]` int32 (uint8 for `"u8"`) and the frame's pixel count."""
    from kmeans_tpu_torch.ops._build import load_library

    _check_cuda_frames(frames_u8, centroids_lab, name)
    if not 0 <= row_offset < 1 << 62:
        raise ValueError(f"row_offset must be a non-negative int, got {row_offset}")
    lib = load_library()
    device = frames_u8.device
    b, h, w = frames_u8.shape[0], frames_u8.shape[1], frames_u8.shape[2]
    kp = centroids_lab.shape[1]
    thr = _thresholds(threshold, b, device)
    n, n_pad, tile_rows, bits, ppw = _layout(h, w, kp)
    if out_mode != "packed":
        bits, ppw = 32, 1
    n_words = n_pad // ppw
    dtype = torch.uint8 if out_mode == "u8" else torch.int32
    out = torch.empty((b, n_words), dtype=dtype, device=device)
    tier = assign_tier(fast, metric, kp)
    chunk = kp if tier != "exact" or out_mode == "packed" else STAGE_CHUNK
    with torch.cuda.device(device):
        lut = gamma_lut(device)
        code, gtab = _tier_operands(tier, centroids_lab)
        k_active, k_dev = _k_actives_operands(k_actives, device)
        pal = packed_palette(centroids_lab) if out_mode == "rgba" else None
        err = lib.kmeans_assign(
            frames_u8.data_ptr(), n, w, _frame_stride(frames_u8), b,
            centroids_lab.data_ptr(), kp, k_active, _ptr(k_dev), chunk,
            KERNEL_METRICS[metric], code, _ptr(gtab), prune_m_for(kp),
            _ptr(pal), lut.data_ptr(), thr.data_ptr(),
            int(mode == "dither"), int(row_offset), ASSIGN_OUTPUTS[out_mode], bits, tile_rows,
            out.data_ptr(), n_words,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, name)
    LAUNCHES_BY_MODE[name, metric, tier + ("-chunked" if kp > chunk else "")] += 1
    return out, n


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
    out, _ = _launch_assign("assign_packed", rgb_u8[None], centroids_lab[None], threshold,
                            [k_active], mode, row_offset, metric, fast, "packed")
    return out.reshape(-1, LANES)


def quantize_rgba(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
    fast: bool = False,
) -> torch.Tensor:
    """The `[H, W, 4]` uint8 RGBA output of replace/dither at any palette
    size; see `quantize_rgba_reference` for the contract. A CPU tensor runs
    the plain twin; a CUDA tensor launches the assign kernel's colour-out
    mode (one launch at any k: a palette past `STAGE_CHUNK` centroids is
    staged in chunks) or raises. The result is a view of the kernel's
    `[n_pad]` words."""
    if rgb_u8.device.type == "cpu":
        return quantize_rgba_reference(
            rgb_u8, centroids_lab, threshold, k_active, mode, row_offset, metric, fast
        )
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric, "quantize_rgba",
                           max_k=None)
    out, n = _launch_assign("quantize_rgba", rgb_u8[None], centroids_lab[None], threshold,
                            [k_active], mode, row_offset, metric, fast, "rgba")
    return out[0, :n].view(torch.uint8).reshape(rgb_u8.shape[0], rgb_u8.shape[1], 4)


def assign_u8(
    rgb_u8: torch.Tensor,
    centroids_lab: torch.Tensor,
    threshold,
    k_active: int | None = None,
    mode: str = "replace",
    row_offset: int = 0,
    metric: str = "cie94",
    fast: bool = False,
) -> torch.Tensor:
    """The `[H, W]` uint8 palette index of each pixel, kp <= 256; see
    `assign_u8_reference` for the contract. A CPU tensor runs the plain
    twin; a CUDA tensor launches the assign kernel's u8-index mode or
    raises. No entry point of either package calls it (the reference's
    `fused_assign` serves only its validation tools)."""
    if rgb_u8.device.type == "cpu":
        return assign_u8_reference(
            rgb_u8, centroids_lab, threshold, k_active, mode, row_offset, metric, fast
        )
    k_active = _check_args(rgb_u8, centroids_lab, k_active, mode, metric, "assign_u8",
                           max_k=256)
    out, n = _launch_assign("assign_u8", rgb_u8[None], centroids_lab[None], threshold,
                            [k_active], mode, row_offset, metric, fast, "u8")
    return out[0, :n].reshape(rgb_u8.shape[0], rgb_u8.shape[1])


def _tier_operands(tier: str, centroids: torch.Tensor):
    """`(tier code, G-table or None)` of a launch: the factorized and the
    pruned tiers read `factor_g_table(centroids)`, built here on the
    centroids' device."""
    gtab = factor_g_table(centroids) if tier in ("factor", "prune") else None
    return KERNEL_TIERS[tier], gtab


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _k_actives_operands(k_actives, device):
    """`(k_active, [B] int32 on device or None)` of a launch: one value for
    every frame travels as a kernel argument, B values as a tensor."""
    if len(set(k_actives)) == 1:
        return k_actives[0], None
    return 0, torch.tensor(k_actives, dtype=torch.int32).to(device)


def _frame_stride(frames_u8: torch.Tensor) -> int:
    """Pixels from one frame to the next: 0 for one image expanded along
    the frame axis."""
    return 0 if frames_u8.stride(0) == 0 else frames_u8.shape[1] * frames_u8.shape[2]


def _check_cuda_frames(frames_u8, centroids_lab, name: str) -> None:
    if frames_u8.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {frames_u8.device}")
    if centroids_lab.device != frames_u8.device or centroids_lab.dtype != torch.float32:
        raise ValueError("centroids must be float32 on the image's device")
    image = frames_u8[0] if frames_u8.stride(0) == 0 else frames_u8
    if not (image.is_contiguous() and centroids_lab.is_contiguous()):
        raise ValueError(f"{name} needs contiguous images and centroids")


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kmeans_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


# --- The frames batch ----------------------------------------------------------


def _check_frames(frames_u8, centroids_lab, k_actives, metric, name):
    """Validate a frames batch: `[B, H, W, 3]` uint8 frames (one image
    expanded along B is a batch of stride 0), `[B, kp, 3]` palettes, and
    `k_actives` None, one int for every frame, or B ints. Returns the B
    ints."""
    _check_metric(metric)
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(
            f"{name}: expected [B, H, W, 3] uint8 frames, got "
            f"{tuple(frames_u8.shape)} {frames_u8.dtype}"
        )
    b = frames_u8.shape[0]
    if centroids_lab.dim() != 3 or centroids_lab.shape[0] != b or centroids_lab.shape[2] != 3:
        raise ValueError(f"{name}: expected [{b}, K, 3] palettes, got "
                         f"{tuple(centroids_lab.shape)}")
    kp = centroids_lab.shape[1]
    if k_actives is None or isinstance(k_actives, int):
        k_actives = [kp if k_actives is None else k_actives] * b
    k_actives = [int(k) for k in k_actives]
    if len(k_actives) != b or not all(1 <= k <= kp for k in k_actives):
        raise ValueError(f"{name}: k_actives must be {b} values in [1, {kp}]")
    return k_actives


def assign_frames_packed_reference(frames_u8, centroids_lab, thresholds, k_actives=None,
                                   mode="replace", metric="cie94", fast=False):
    """Plain PyTorch twin of the assign kernel's frames mode: frame `f`
    against its own palette `centroids_lab[f]`, `k_actives[f]` and
    `thresholds[f]`, as `assign_packed_reference` writes it alone, stacked:
    `[B, W_f, LANES]` int32 (kmeans_tpu/ops/kernels.py:2092
    `fused_assign_frames_packed`; kp <= 1024)."""
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric,
                              "assign_frames_packed")
    thr = _thresholds(thresholds, len(k_actives), frames_u8.device)
    return torch.stack([
        assign_packed_reference(frames_u8[f], centroids_lab[f], thr[f], k, mode,
                                metric=metric, fast=fast)
        for f, k in enumerate(k_actives)
    ])


def quantize_frames_reference(frames_u8, centroids_lab, thresholds, k_actives=None,
                              mode="replace", metric="cie94", fast=False):
    """Plain PyTorch twin of the colour-out frames mode: each frame's
    `quantize_rgba_reference` against its own palette, stacked:
    `[B, H, W, 4]` uint8 (kmeans_tpu/ops/kernels.py:2057
    `fused_quantize_frames`), any kp."""
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric, "quantize_frames")
    thr = _thresholds(thresholds, len(k_actives), frames_u8.device)
    return torch.stack([
        quantize_rgba_reference(frames_u8[f], centroids_lab[f], thr[f], k, mode,
                                metric=metric, fast=fast)
        for f, k in enumerate(k_actives)
    ])


def meld_frames_packed_reference(frames_u8, centroids_lab, k_actives=None, metric="cie94",
                                 fast=False):
    """Plain PyTorch twin of the meld kernel's frames mode: each frame's
    `meld_packed_reference` against its own palette, stacked:
    `[B, W_f, LANES]` int32 (kmeans_tpu/ops/kernels.py:2129
    `fused_meld_frames_packed`), any kp."""
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric,
                              "meld_frames_packed")
    return torch.stack([
        meld_packed_reference(frames_u8[f], centroids_lab[f], k, metric, fast)
        for f, k in enumerate(k_actives)
    ])


def assign_frames_packed(frames_u8, centroids_lab, thresholds, k_actives=None,
                         mode="replace", metric="cie94", fast=False):
    """Packed palette indices of B frames, each against its own palette, in
    one launch; see `assign_frames_packed_reference` for the contract.
    Frame `f` of the result unpacks as a single image of the frame's shape
    (`utils/packing.py::unpack_tile_words`). `thresholds` is a float, B
    floats, or `[B]` float32 on the frames' device. A CPU tensor runs the
    plain twin; a CUDA tensor launches the assign kernel's frames mode or
    raises. The reference's `FRAMES_MAX_BK` (a TPU scalar-memory limit) has
    no counterpart: a block stages one frame's palette only, and past
    65,535 frames (the grid's y limit) the launcher issues the frames in
    groups, so any B takes one call."""
    if frames_u8.device.type == "cpu":
        return assign_frames_packed_reference(frames_u8, centroids_lab, thresholds,
                                              k_actives, mode, metric, fast)
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric,
                              "assign_frames_packed")
    _check_args(frames_u8[0], centroids_lab[0], None, mode, metric, "assign_frames_packed")
    out, _ = _launch_assign("assign_frames_packed", frames_u8, centroids_lab, thresholds,
                            k_actives, mode, 0, metric, fast, "packed")
    return out.reshape(frames_u8.shape[0], -1, LANES)


def quantize_frames(frames_u8, centroids_lab, thresholds, k_actives=None, mode="replace",
                    metric="cie94", fast=False):
    """`[B, H, W, 4]` uint8 RGBA of B frames, each against its own palette,
    any kp, in one launch; see `quantize_frames_reference` for the
    contract. A CPU tensor runs the plain twin; a CUDA tensor launches the
    assign kernel's colour-out frames mode or raises."""
    if frames_u8.device.type == "cpu":
        return quantize_frames_reference(frames_u8, centroids_lab, thresholds, k_actives,
                                         mode, metric, fast)
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric, "quantize_frames")
    _check_args(frames_u8[0], centroids_lab[0], None, mode, metric, "quantize_frames",
                max_k=None)
    out, n = _launch_assign("quantize_frames", frames_u8, centroids_lab, thresholds,
                            k_actives, mode, 0, metric, fast, "rgba")
    b, h, w = frames_u8.shape[0], frames_u8.shape[1], frames_u8.shape[2]
    return out[:, :n].view(torch.uint8).reshape(b, h, w, 4)


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


def _launch_meld(name, frames_u8, centroids_lab, k_actives, metric, fast):
    """Launch `csrc/quantize_meld.cu` over `frames_u8` (as
    `_launch_assign`); returns `[B, 3 * n_groups]` int32 words."""
    from kmeans_tpu_torch.ops._build import load_library

    _check_cuda_frames(frames_u8, centroids_lab, name)
    lib = load_library()
    device = frames_u8.device
    b, h, w = frames_u8.shape[0], frames_u8.shape[1], frames_u8.shape[2]
    kp = centroids_lab.shape[1]
    n, n_pad, tile_rows, _, _ = _layout(h, w, kp)
    n_groups = n_pad // 4
    out = torch.empty((b, 3 * n_groups), dtype=torch.int32, device=device)
    tier = assign_tier(fast, metric, kp)
    chunk = kp if tier != "exact" else STAGE_CHUNK
    with torch.cuda.device(device):
        lut = gamma_lut(device)
        code, gtab = _tier_operands(tier, centroids_lab)
        k_active, k_dev = _k_actives_operands(k_actives, device)
        err = lib.kmeans_meld(
            frames_u8.data_ptr(), n, _frame_stride(frames_u8), b,
            centroids_lab.data_ptr(), kp, k_active, _ptr(k_dev), chunk,
            KERNEL_METRICS[metric], code, _ptr(gtab), prune_m_for(kp),
            lut.data_ptr(), tile_rows, out.data_ptr(), n_groups,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, err, name)
    LAUNCHES_BY_MODE[name, metric, tier + ("-chunked" if kp > chunk else "")] += 1
    return out


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
    use) or raises. Any palette size takes one launch: past `STAGE_CHUNK`
    centroids the kernel stages them in chunks."""
    if rgb_u8.device.type == "cpu":
        return meld_packed_reference(rgb_u8, centroids_lab, k_active, metric, fast)
    k_active = _check_image_args(rgb_u8, centroids_lab, k_active, metric)
    return _launch_meld("meld_packed", rgb_u8[None], centroids_lab[None], [k_active],
                        metric, fast).reshape(-1, LANES)


def meld_frames_packed(frames_u8, centroids_lab, k_actives=None, metric="cie94", fast=False):
    """RGB24-packed meld output of B frames, each against its own palette,
    in one launch; see `meld_frames_packed_reference` for the contract.
    Frame `f` of the result unpacks as a single image
    (`utils/packing.py::unpack_rgb24_tile_words`). A CPU tensor runs the
    plain twin; a CUDA tensor launches the meld kernel's frames mode or
    raises."""
    if frames_u8.device.type == "cpu":
        return meld_frames_packed_reference(frames_u8, centroids_lab, k_actives, metric, fast)
    k_actives = _check_frames(frames_u8, centroids_lab, k_actives, metric,
                              "meld_frames_packed")
    return _launch_meld("meld_frames_packed", frames_u8, centroids_lab, k_actives, metric,
                        fast).reshape(frames_u8.shape[0], -1, LANES)


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
