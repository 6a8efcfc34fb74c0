"""K-means colour clustering in CIELAB, in PyTorch.

Port of the trainers of `kmeans_tpu/models/kmeans.py`:

- `plusplus_init`: farthest-point seeding from the deterministic
  `reference_seed_index`, with the min-distance map kept incrementally;
- `lloyd`: per-cluster (sum, count) by a one-hot matrix product (float64,
  rounded to float32, so TF32 never touches it),
  new centroid = sum / count (empty clusters keep their value and vote
  "not converged"), the CIE94 convergence vote, then re-assignment;
- `lloyd_accumulated` (the reference's `lloyd_pallas`): the same loop with
  each step's assignment and (sum, count) taken in one pass of the tile
  accumulator (`ops/kernels.py::lloyd_accumulate`, a CUDA kernel on the
  card), with no `[N, K]` intermediate; `fit_large` and
  `fit_large_restarts` train on it, and `fast=True` puts the accumulator's
  fast forms under every step at k > 16;
- `lloyd_chunked` / `fit_chunked`: the plain loop over row chunks of
  `_CHUNK_PIXELS`, for k > `ACCUM_MAX_K` past the element budget;
- `fit_restarts`: `restarts` seedings from `derive_restart_seeds`, run one
  after another, the lowest inertia wins;
- the reference's stop rule: at most 128 iterations, convergence checked
  after iterations 8, 16, ... only.

The JAX package runs each loop as one `lax.while_loop` on the device. Here
it is a Python loop of eager ops, and each checked iteration reads the
convergence flag back with one `.item()`, a host synchronisation every
8th iteration; the phase recorder bills the wait to `"lloyd_sync"`.

Every trainer takes the reference's per-pixel `weight=` (the bucketed
serving path pads images into fixed canvases and marks the padding with
weight 0): a pixel of weight <= 0 never seeds, restart seeds walk past
it, it adds exact zeros to every per-cluster sum and count (through the
accumulator's weight plane on the tile route), and the restarts' inertia
weighs each pixel's distance. The batched trainers take one weight
vector and one first seed index per member.
"""

from __future__ import annotations

from itertools import repeat
from typing import NamedTuple

import numpy as np
import torch

from kmeans_tpu_torch.ops.colorspace import fma, srgb8_to_lab_compiled
from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.ops.kernels import lloyd_accumulate, pack_lab_planes, pack_plane
from kmeans_tpu_torch.utils.profiling import phase

MAX_ITERATIONS = 128  # kmeans_tpu/models/kmeans.py:49
CONVERGENCE_CHECK_EVERY = 8
LAB_CONVERGENCE = 1.0

_BIG = 3.4e38  # above any CIE94^2
# CIE94's k1 and k2 as the float32 constants XLA folds them to.
_F32_K1 = float(np.float32(0.045))
_F32_K2 = float(np.float32(0.015))
_F32_INV_255 = float(np.float32(1.0) / np.float32(255.0))
# Row-chunk size of the memory-bounded trainer: `[CHUNK, K]` float32
# intermediates stay <= 256 MB at k = 256 (kmeans_tpu/models/kmeans.py:555).
_CHUNK_PIXELS = 1 << 18
_PLANE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def reference_seed_index(width: int, height: int) -> int:
    """Flat index of the first seed pixel: the reference's
    `fract(sin(dot(seed, (12.9898, 78.233))) * 43758.5453)` hash in numpy
    float32 (kmeans_tpu/models/kmeans.py:57)."""

    def rand(seed: float) -> float:
        v = np.float32(seed) * (np.float32(12.9898) + np.float32(78.233))
        s = np.sin(np.float32(v), dtype=np.float32) * np.float32(43758.5453)
        return float(s - np.floor(s))

    x = min(int(width * rand(42.0)), width - 1)
    y = min(int(height * rand(12.0)), height - 1)
    return y * width + x


def _valid(k: int, k_active: int | None, device) -> torch.Tensor:
    return torch.arange(k, device=device) < (k if k_active is None else k_active)


def _masked_d2(pixels, centroids, valid, metric="cie94"):
    """`[N, K]` squared delta-E; inactive centroids get `_BIG`."""
    _, dist_sq = metric_fns(metric)
    d2 = dist_sq(pixels[:, None, :], centroids[None, :, :])
    return torch.where(valid[None, :], d2, torch.full_like(d2, _BIG))


def assign_clusters(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    valid: torch.Tensor | None = None,
    metric: str = "cie94",
) -> torch.Tensor:
    """Nearest centroid of each pixel (first minimum wins):
    `pixels[N, 3]`, `centroids[K, 3]` -> `[N]` int64."""
    if valid is None:
        valid = torch.ones(centroids.shape[0], dtype=torch.bool, device=pixels.device)
    return torch.argmin(_masked_d2(pixels, centroids, valid, metric), dim=1)


class SeedLab(NamedTuple):
    """The colours the reference's compiled seeding reads, for a call site
    where it converts the pixels in the executable that seeds: `lab [...,
    N, 3]`, what its distance maps take on both sides; `inline [..., N,
    3]` (float64) or None, the unrounded channels its first map fuses on
    the pixel side where it recomputes them there (`_first_map_compiled`).
    The seeds' values stay the trainer's own `pixels`; only the picks
    follow this."""

    lab: torch.Tensor
    inline: torch.Tensor | None = None


def seed_lab(rgb8: torch.Tensor, lab: bool = True, inline: bool = True) -> SeedLab:
    """`SeedLab` of uint8 sRGB `[..., N, 3]`: Lab as
    `ops/colorspace.py::srgb8_to_lab_compiled` computes it, or with
    `lab=False` the unorm RGB the reference trains on in its RGB colour
    space, `x * f32(1 / 255)` (its `/ 255` folded), each channel exact in
    float64 on the inline side."""
    if lab:
        out = srgb8_to_lab_compiled(rgb8, inline)
        return SeedLab(*out) if inline else SeedLab(out)
    x = rgb8.to(torch.float32)
    return SeedLab(x * _F32_INV_255, x.double() * _F32_INV_255 if inline else None)


def _first_map_compiled(space, inline, c0):
    """The first seeding map under CIE94 as XLA-CPU compiles it with the
    colour conversion fused in (kmeans_tpu/models/kmeans.py:136 in the
    optimised HLO of `kmeans_tpu/api.py::_train_jit`): each channel
    difference is `inline - c0` rounded once (for a* that is `fma(fx - fy,
    500, -a_c)`), and the sums contract into multiply-adds. `space [...,
    N, 3]`, `c0 [..., 3]` -> `[..., N]`."""
    c0 = c0[..., None, :]
    la, lb = space[..., 1], space[..., 2]
    ca, cb = c0[..., 1], c0[..., 2]
    c1 = torch.sqrt(fma(la, la, lb * lb))
    c2 = torch.sqrt(fma(ca, ca, cb * cb))
    dl, da, db = (inline - c0.double()).float().unbind(-1)
    dc = c1 - c2
    s_c = fma(c1, _F32_K1, 1.0)
    s_h = fma(c1, _F32_K2, 1.0)
    dh2 = torch.clamp(fma(-dc, dc, fma(da, da, db * db)), min=0.0)
    q = dc / s_c
    return fma(q, q, dl * dl) + dh2 / (s_h * s_h)


def _first_map(space, first_rows, metric, seed):
    """The distance map to the first seed: `_first_map_compiled` where the
    reference fuses the Lab conversion in under CIE94, else the metric
    against `first_rows` (the seed's row repeated, laid out as `space`)."""
    if seed is not None and seed.inline is not None and metric == "cie94":
        return _first_map_compiled(space, seed.inline, first_rows[..., 0, :])
    _, dist_sq = metric_fns(metric)
    return dist_sq(space, first_rows)


def plusplus_init(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> torch.Tensor:
    """Farthest-point seeding: `pixels[N, 3]` Lab -> `[k, 3]` centroids.
    Centroid 0 is `pixels[first_index]`; each next one is the pixel with the
    largest distance to the chosen set (first maximum wins). With
    `k_active < k` the trailing rows stay zero and must stay masked. With
    `weight[N]`, a pixel of weight <= 0 never seeds: its distance-map
    entry is pinned to -1, below every real pixel's, and the running
    minimum keeps it there (kmeans_tpu/models/kmeans.py:113-139).

    With `seed`, the distance maps are taken on `seed.lab` (and the first
    one on `seed.inline`), as the reference's executable computes them
    where it converts and seeds together; the picked pixels' values come
    from `pixels`. Each map is taken against the picked pixel's row
    repeated N times, so both sides of the metric have one layout: the
    CPU's vectorized and scalar `atan2` differ in the last bit, which
    would leave a pixel at a CIEDE2000 distance above 0 from its own
    colour and move the picks at exact ties."""
    k_active = min(k, k if k_active is None else k_active)
    _, dist_sq = metric_fns(metric)
    space = pixels if seed is None else seed.lab
    n = space.shape[0]
    m = max(k_active, 1)
    picks = torch.zeros(m, dtype=torch.int64, device=pixels.device)
    picks[0] = first_index
    dmap = _first_map(space, torch.index_select(space, 0, picks[:1].expand(n)), metric, seed)
    if weight is not None:
        dmap = torch.where(weight > 0, dmap, torch.full_like(dmap, -1.0))
    for j in range(1, k_active):
        # The pick stays on the device (no host round trip).
        idx = torch.argmax(dmap).reshape(1)
        picks[j:j + 1] = idx
        dmap = torch.minimum(dmap, dist_sq(space, torch.index_select(space, 0, idx.expand(n))))
    centroids = torch.zeros((k, 3), dtype=torch.float32, device=pixels.device)
    centroids[:m] = torch.index_select(pixels, 0, picks)
    return centroids


def _update_centroids(
    pixels: torch.Tensor, assign: torch.Tensor, k: int, weight: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster `(sums [K, 3], counts [K])` through a one-hot matrix
    product, as the reference does on its matrix unit with the product
    pinned to full float32 (kmeans_tpu/models/kmeans.py:172-177). Here the
    product runs in float64 and is rounded back to float32: TF32 applies
    only to float32 products, so the sums are the same whatever the
    caller's matmul-precision setting, and no process-wide flag is read or
    set (a serving thread may be training beside the caller). Each float32
    pixel is exact in float64, so the sums are float32 roundings of
    near-exact totals. With `weight[N]` each one-hot row is scaled by its
    pixel's weight first (`:158-171`): a 0-weight row adds exact zeros."""
    sums, counts = onehot_totals(pixels, assign, k, weight)
    return sums.to(torch.float32), counts.to(torch.float32)


def onehot_totals(
    pixels: torch.Tensor, assign: torch.Tensor, k: int, weight: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """`_update_centroids` before its rounding: the float64 `(sums [K, 3],
    counts [K])` of the one-hot product. The sharded trainer adds the
    shards' float64 totals and rounds once, so one shard gives this
    function's bits rounded as `_update_centroids` rounds them."""
    onehot = torch.zeros(
        (pixels.shape[0], k), dtype=torch.float64, device=pixels.device
    ).scatter_(1, assign[:, None], 1.0)
    if weight is not None:
        onehot = onehot * weight.to(torch.float64)[:, None]
    return onehot.T @ pixels.to(torch.float64), onehot.sum(dim=0)


def _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric):
    """The Lloyd loop with the reference's termination protocol
    (kmeans_tpu/models/kmeans.py:184). `totals(centroids)` returns the
    per-cluster `(sums [k, 3], counts [k])` of the assignment to
    `centroids`. After completing 0-based iteration `j`, the loop stops
    only if `j > 0`, `j % 8 == 0` and every active centroid voted
    converged in that iteration. Returns `(centroids [k, 3], iterations)`."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, centroids.device)
    dist, _ = metric_fns(metric)
    iters = 0
    for j in range(max_iterations):
        sums, counts = totals(centroids)
        nonempty = counts > 0
        new_centroids = torch.where(
            nonempty[:, None],
            sums / torch.clamp(counts, min=1.0)[:, None],
            centroids,
        )
        checked = j > 0 and j % CONVERGENCE_CHECK_EVERY == 0
        if checked:
            moved = dist(new_centroids, centroids)
            votes = nonempty & (moved < convergence)
            with phase("lloyd_sync"):
                converged = bool(torch.all(votes | ~valid).item())
        centroids = new_centroids
        iters = j + 1
        if checked and converged:
            break
    return centroids, iters


def lloyd(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Lloyd iterations on the one-hot product update
    (kmeans_tpu/models/kmeans.py:184); `weight[N]` scales each pixel's
    contribution. Returns `(centroids [k, 3], iterations_run)`."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, pixels.device)

    def totals(cents):
        return _update_centroids(pixels, assign_clusters(pixels, cents, valid, metric), k,
                                 weight)

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def lloyd_accumulated(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    plane_dtype: str | None = None,
    fast: bool = False,
    weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Lloyd loop on the tile accumulator: the port of `lloyd_pallas`
    (kmeans_tpu/models/kmeans.py:241). The pixels are packed once into
    `[3, M, 128]` planes; each iteration is one `lloyd_accumulate` pass
    (assignment and per-cluster sums together, no `[N, K]` one-hot).
    `plane_dtype="bfloat16"` stores the planes half-width, which quantizes
    the training input (opt-in, as in the reference). `fast=True` acts
    only at k > 16 (`:288`): each step then assigns by the factorized
    CIE94 score or the pruned CIEDE2000 tier, so near-tie pixels may join
    another cluster than under the exact step; smaller palettes train
    exact. `weight[N]` travels as the kernel's weight plane, packed like
    the Lab planes (`:295`)."""
    if plane_dtype not in _PLANE_DTYPES:
        raise ValueError(f"plane_dtype must be None or 'bfloat16', got {plane_dtype!r}")
    planes, n_valid = pack_lab_planes(pixels, _PLANE_DTYPES[plane_dtype])
    weight_planes = _weight_plane(weight)
    fast = bool(fast) and centroids.shape[0] > 16

    def totals(cents):
        t = lloyd_accumulate(planes, cents, n_valid, k_active=k_active,
                             weight_planes=weight_planes, metric=metric, fast=fast)
        return t[:, :3], t[:, 3]

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def _weight_plane(weight: torch.Tensor | None) -> torch.Tensor | None:
    """`[N]` weights -> the accumulator's float32 `[M, 128]` weight plane
    (zero past N, like the Lab planes' padding), or None."""
    return None if weight is None else pack_plane(weight.to(torch.float32))


def _chunks(pixels: torch.Tensor):
    return torch.split(pixels, _CHUNK_PIXELS)


def _assign_chunked(pixels, centroids, valid, metric):
    """`assign_clusters` over row chunks: no `[N, K]` intermediate
    (kmeans_tpu/models/kmeans.py:558)."""
    return torch.cat([assign_clusters(px, centroids, valid, metric) for px in _chunks(pixels)])


def _update_chunked(pixels, assign, k, weight=None):
    """`_update_centroids` over row chunks, the partial (sums, counts)
    added in chunk order (kmeans_tpu/models/kmeans.py:572)."""
    weights = repeat(None) if weight is None else _chunks(weight)
    parts = [
        _update_centroids(px, asg, k, wgt)
        for px, asg, wgt in zip(_chunks(pixels), torch.split(assign, _CHUNK_PIXELS), weights)
    ]
    return (torch.stack([p[0] for p in parts]).sum(0),
            torch.stack([p[1] for p in parts]).sum(0))


def lloyd_chunked(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """`lloyd` with every `[N, K]` intermediate cut into row chunks: the
    memory-bounded trainer for large pixel counts at k > `ACCUM_MAX_K`
    (kmeans_tpu/models/kmeans.py:596). Plain PyTorch, as in the reference,
    which runs it outside any kernel."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, pixels.device)

    def totals(cents):
        return _update_chunked(pixels, _assign_chunked(pixels, cents, valid, metric), k, weight)

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def fit(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, int]:
    """Seed + Lloyd: `pixels[N, 3]` -> `(centroids [k, 3], iterations)`
    (kmeans_tpu/models/kmeans.py:719); `seed` as `plusplus_init` takes it."""
    centroids = plusplus_init(pixels, k, first_index, k_active, metric, weight, seed)
    return lloyd(pixels, centroids, convergence, max_iterations, k_active, metric, weight)


def fit_large(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    plane_dtype: str | None = None,
    fast: bool = False,
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, int]:
    """`fit` for large pixel counts: float32 seeding (always exact), then
    `lloyd_accumulated` (kmeans_tpu/models/kmeans.py:431)."""
    centroids = plusplus_init(pixels, k, first_index, k_active, metric, weight, seed)
    return lloyd_accumulated(
        pixels, centroids, convergence, max_iterations, k_active, metric, plane_dtype, fast,
        weight,
    )


def derive_restart_seeds(n: int, first_index: int, restarts: int,
                         weight: torch.Tensor | None = None) -> torch.Tensor:
    """Flat seed-pixel indices of `restarts` runs, `[restarts]` int32 on
    the CPU: restart 0 is `first_index`, restart r adds
    `floor(r * 0.618... * n)` in float32, modulo `n`
    (kmeans_tpu/models/kmeans.py:333). With `weight[N]`, restarts 1.. walk
    off the pad pixels: seed r becomes the (seed mod n_real)-th pixel of
    weight > 0, in index order (`:337-351`)."""
    golden = torch.tensor(0.6180339887498949, dtype=torch.float32)
    offs = torch.floor(torch.arange(restarts, dtype=torch.float32) * golden * n)
    offs = offs.to(torch.int32)
    seeds = torch.remainder(torch.tensor(first_index, dtype=torch.int32) + offs, n)
    if weight is not None:
        real = (weight > 0).cpu()
        order = torch.argsort((~real).to(torch.int8), stable=True)
        ranks = torch.remainder(seeds, max(int(real.sum()), 1)).to(torch.int64)
        seeds = torch.cat([seeds[:1], order[ranks][1:].to(torch.int32)])
    return seeds


def _best_of_restarts(fit_one, inertia, n, first_index, restarts, weight=None):
    """Run `fit_one(seed)` for each seed of `derive_restart_seeds`, one
    after another, and return the `(centroids, iterations)` of the run
    whose `inertia(centroids)` is lowest; on a tie the first, as
    `argmin` takes it."""
    runs, inertias = [], []
    for seed in derive_restart_seeds(n, first_index, restarts, weight).tolist():
        cents, iters = fit_one(seed)
        runs.append((cents, iters))
        inertias.append(inertia(cents))
    return runs[int(torch.argmin(torch.stack(inertias)).item())]


def _sum_min_d2(pixels, centroids, valid, metric, weight=None) -> torch.Tensor:
    """Sum over pixels of the squared delta-E to the nearest active
    centroid, each times its pixel's weight, one row chunk at a time."""
    weights = repeat(None) if weight is None else _chunks(weight)
    sums = []
    for px, wgt in zip(_chunks(pixels), weights):
        dmin = torch.min(_masked_d2(px, centroids, valid, metric), dim=1).values
        sums.append(torch.sum(dmin if wgt is None else dmin * wgt))
    return torch.stack(sums).sum()


def fit_restarts(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, int]:
    """`fit` with `restarts` seedings from `derive_restart_seeds`; the run
    with the lowest within-cluster inertia wins
    (kmeans_tpu/models/kmeans.py:368). The reference trains the restarts
    in one vmapped loop that freezes converged runs, so each run equals a
    single `fit` from its seed; here they run one after another."""
    def one(first):
        return fit(pixels, k, first, convergence, max_iterations, k_active, metric, weight,
                   seed)

    if restarts <= 1:
        return one(first_index)
    valid = _valid(k, k_active, pixels.device)
    return _best_of_restarts(
        one, lambda c: _sum_min_d2(pixels, c, valid, metric, weight),
        pixels.shape[0], first_index, restarts, weight,
    )


def fit_large_restarts(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    plane_dtype: str | None = None,
    fast: bool = False,
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, int]:
    """`fit_large` with `restarts` seedings (kmeans_tpu/models/kmeans.py:477).
    Each run's inertia is one extra accumulator pass with
    `emit_inertia=True` on float32 planes, whatever `plane_dtype` trained
    it (`:519-547`); the lowest wins. Under `fast=True` that pass runs
    exact for CIE94 (the factorized score is a rank, no distance) and
    keeps the pruned tier for CIEDE2000, whose winning distance is exact
    (`:534-543`). With `weight`, the pass reads the weight plane, so each
    distance counts times its pixel's weight."""
    def one(first):
        return fit_large(pixels, k, first, convergence, max_iterations,
                         k_active, metric, plane_dtype, fast, weight, seed)

    if restarts <= 1:
        return one(first_index)
    planes, n_valid = pack_lab_planes(pixels)
    weight_planes = _weight_plane(weight)

    def inertia(cents):
        totals = lloyd_accumulate(planes, cents, n_valid, k_active=k_active,
                                  weight_planes=weight_planes, metric=metric,
                                  emit_inertia=True, fast=bool(fast) and metric == "cie2000")
        return torch.sum(totals[:, 4])

    return _best_of_restarts(one, inertia, pixels.shape[0], first_index, restarts, weight)


def fit_chunked(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    weight: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, int]:
    """Memory-bounded fit: seeding + `lloyd_chunked`; restarts run one
    after another with a chunked inertia (kmeans_tpu/models/kmeans.py:652)."""
    def one(first):
        cents = plusplus_init(pixels, k, first, k_active, metric, weight, seed)
        return lloyd_chunked(pixels, cents, convergence, max_iterations, k_active, metric,
                             weight)

    if restarts <= 1:
        return one(first_index)
    valid = _valid(k, k_active, pixels.device)
    return _best_of_restarts(
        one, lambda c: _sum_min_d2(pixels, c, valid, metric, weight),
        pixels.shape[0], first_index, restarts, weight,
    )


# --- Batched training -------------------------------------------------------

# Member x pixel x cluster elements of one group of the batched assignment's
# `[members, N, K]` distances (~256 MB in float32); members are independent,
# so the grouping changes no result.
_BATCH_ELEMS = 1 << 26


def plusplus_init_batched(
    pixels: torch.Tensor,
    k: int,
    first_indices,
    k_actives,
    metric: str = "cie94",
    weights: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> torch.Tensor:
    """`plusplus_init` of M members at once: `pixels[M, N, 3]` (one image
    expanded along M shares its pixels), member `i` seeded at flat index
    `first_indices[i]` with `k_actives[i]` centroids and, with
    `weights[M, N]`, never at a pixel of weight <= 0 -> `[M, k, 3]`; `seed`
    laid out as `pixels`. The same elementwise operations per member;
    members past their `k_active` keep zero rows."""
    m, n = pixels.shape[0], pixels.shape[1]
    _, dist_sq = metric_fns(metric)
    space = pixels if seed is None else seed.lab
    rows = torch.arange(m, device=pixels.device)[:, None]
    ka = torch.tensor(k_actives, dtype=torch.int64).to(pixels.device)
    picks = torch.zeros((m, k), dtype=torch.int64, device=pixels.device)
    picks[:, 0] = torch.tensor(first_indices, dtype=torch.int64).to(pixels.device)
    dmap = _first_map(space, space[rows, picks[:, :1].expand(m, n)], metric, seed)
    if weights is not None:
        dmap = torch.where(weights > 0, dmap, torch.full_like(dmap, -1.0))
    for j in range(1, min(k, max(k_actives))):
        idx = torch.argmax(dmap, dim=1, keepdim=True)
        take = j < ka
        picks[:, j] = idx[:, 0]
        dmap = torch.where(take[:, None],
                           torch.minimum(dmap, dist_sq(space, space[rows, idx.expand(m, n)])),
                           dmap)
    centroids = pixels[rows, picks]
    kept = torch.arange(k, device=pixels.device)[None, :] < torch.clamp(ka, min=1)[:, None]
    return torch.where(kept[..., None], centroids, torch.zeros_like(centroids))


def _assign_batched(pixels, centroids, valid, metric):
    """`assign_clusters` of each member, `[M, N]`, in groups of members
    whose distances fit `_BATCH_ELEMS`."""
    m, n = pixels.shape[0], pixels.shape[1]
    step = max(1, _BATCH_ELEMS // max(n * centroids.shape[1], 1))
    out = []
    for i in range(0, m, step):
        px, cents, ok = pixels[i:i + step], centroids[i:i + step], valid[i:i + step]
        _, dist_sq = metric_fns(metric)
        d2 = dist_sq(px[:, :, None, :], cents[:, None, :, :])
        out.append(torch.argmin(torch.where(ok[:, None, :], d2, torch.full_like(d2, _BIG)), dim=2))
    return torch.cat(out)


def lloyd_batched(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    k_actives,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    metric: str = "cie94",
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`lloyd` of M members in one loop: `pixels[M, N, 3]`, `centroids[M,
    k, 3]`, `k_actives` M ints, optional `weights[M, N]`. Each step assigns
    every member at once (`_assign_batched`) and takes each member's
    `(sums, counts)` with the solo `_update_centroids`. A member that votes converged at a check
    freezes: later steps leave its centroids and iteration count alone, as
    a batched `lax.while_loop` does, so each member's result is its solo
    `lloyd`'s. One host synchronisation per check for all members.
    Returns `(centroids [M, k, 3], iterations [M] int64)`."""
    m, k = centroids.shape[0], centroids.shape[1]
    device = centroids.device
    ka = torch.tensor(k_actives, dtype=torch.int64).to(device)
    valid = torch.arange(k, device=device)[None, :] < ka[:, None]
    dist, _ = metric_fns(metric)
    running = torch.ones(m, dtype=torch.bool, device=device)
    iters = torch.zeros(m, dtype=torch.int64, device=device)
    for j in range(max_iterations):
        assign = _assign_batched(pixels, centroids, valid, metric)
        totals = [_update_centroids(pixels[i], assign[i], k,
                                    None if weights is None else weights[i])
                  for i in range(m)]
        sums = torch.stack([t[0] for t in totals])
        counts = torch.stack([t[1] for t in totals])
        nonempty = counts > 0
        new_centroids = torch.where(
            nonempty[..., None], sums / torch.clamp(counts, min=1.0)[..., None], centroids
        )
        checked = j > 0 and j % CONVERGENCE_CHECK_EVERY == 0
        if checked:
            votes = nonempty & (dist(new_centroids, centroids) < convergence)
            converged = torch.all(votes | ~valid, dim=1)
        centroids = torch.where(running[:, None, None], new_centroids, centroids)
        iters = torch.where(running, j + 1, iters)
        if checked:
            running = running & ~converged
            with phase("lloyd_sync"):
                if not bool(running.any().item()):
                    break
    return centroids, iters


def fit_restarts_batched(
    pixels: torch.Tensor,
    k: int,
    first_index,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_actives=None,
    metric: str = "cie94",
    weights: torch.Tensor | None = None,
    seed: SeedLab | None = None,
) -> tuple[torch.Tensor, list]:
    """`fit_restarts` of B members in one loop, the counterpart of the
    reference's `jax.vmap(fit_restarts)` (kmeans_tpu/api.py:3294, 3771):
    `pixels` is `[B, N, 3]` (member b trains on `pixels[b]`, all at `k`),
    or one `[N, 3]` image shared by B members with `k_actives` (B ints; the
    kmax padding of `reduce_batch`). `first_index` is one flat index for
    every member or B of them (the coalescers' frames differ in size);
    `weights` is None, one `[N]` vector for every member, or `[B, N]`
    (bucketed canvases: 0 on the padding). Member b seeds at its first
    index (restart r at `derive_restart_seeds`'s r-th index, walked off
    its 0-weight pixels) and all B x restarts runs share one
    `lloyd_batched` loop; each member keeps its run of least weighted
    inertia, the first on a tie. `seed` as `plusplus_init` takes it, laid
    out as `pixels`. Returns `(centroids [B, k, 3], iterations of each
    member's winner)`."""
    n = pixels.shape[-2]
    if pixels.dim() == 2:
        if k_actives is None:
            raise ValueError("a shared [N, 3] image needs k_actives, one per member")
        b = len(k_actives)
    else:
        b = pixels.shape[0]
    k_actives = [k] * b if k_actives is None else [int(x) for x in k_actives]
    firsts = [int(first_index)] * b if np.ndim(first_index) == 0 else [int(f) for f in first_index]
    if weights is not None and weights.dim() == 1:
        weights = weights.expand(b, n)

    def member_seeds(i):
        if restarts <= 1:
            return [firsts[i]]
        return derive_restart_seeds(n, firsts[i], restarts,
                                    None if weights is None else weights[i]).tolist()

    seeds = [member_seeds(i) for i in range(b)]
    r = len(seeds[0])
    if pixels.dim() == 2:
        runs_px = pixels.expand(b * r, n, 3)
    else:
        runs_px = pixels.repeat_interleave(r, dim=0) if r > 1 else pixels
    run_w = None if weights is None else (weights.repeat_interleave(r, dim=0) if r > 1
                                          else weights)
    run_ka = [ka for ka in k_actives for _ in range(r)]
    run_seed = None
    if seed is not None:
        run_seed = SeedLab(*(None if t is None else
                             t.expand(b * r, *t.shape) if pixels.dim() == 2 else
                             t.repeat_interleave(r, dim=0) if r > 1 else t for t in seed))
    cents = plusplus_init_batched(runs_px, k, [s for member in seeds for s in member], run_ka,
                                  metric, run_w, run_seed)
    cents, iters = lloyd_batched(runs_px, cents, run_ka, convergence, max_iterations, metric,
                                 run_w)
    iters = iters.tolist()
    if r == 1:
        return cents, iters
    valid = torch.arange(k, device=pixels.device)[None, :] < torch.tensor(run_ka).to(
        pixels.device)[:, None]
    inertia = torch.stack([
        _sum_min_d2(runs_px[i], cents[i], valid[i], metric, None if run_w is None else run_w[i])
        for i in range(b * r)])
    best = torch.argmin(inertia.reshape(b, r), dim=1).tolist()
    return (torch.stack([cents[i * r + w] for i, w in enumerate(best)]),
            [iters[i * r + w] for i, w in enumerate(best)])
