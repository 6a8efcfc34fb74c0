"""K-means colour clustering in CIELAB, in PyTorch.

Port of the trainers of `kmeans_tpu/models/kmeans.py`:

- `plusplus_init`: farthest-point seeding from the deterministic
  `reference_seed_index`, with the min-distance map kept incrementally;
- `lloyd`: per-cluster (sum, count) by a one-hot float32 matrix product,
  new centroid = sum / count (empty clusters keep their value and vote
  "not converged"), the CIE94 convergence vote, then re-assignment;
- `lloyd_accumulated` (the reference's `lloyd_pallas`): the same loop with
  each step's assignment and (sum, count) taken in one pass of the tile
  accumulator (`ops/kernels.py::lloyd_accumulate`, a CUDA kernel on the
  card), with no `[N, K]` intermediate; `fit_large` and
  `fit_large_restarts` train on it;
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
Per-pixel weights (`weight=` in the reference) wait for bucketing
(ROADMAP A.9); the accumulator already takes a weight plane.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.ops.kernels import lloyd_accumulate, pack_lab_planes
from kmeans_tpu_torch.utils.profiling import phase

MAX_ITERATIONS = 128  # kmeans_tpu/models/kmeans.py:49
CONVERGENCE_CHECK_EVERY = 8
LAB_CONVERGENCE = 1.0

_BIG = 3.4e38  # above any CIE94^2
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


def plusplus_init(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    k_active: int | None = None,
    metric: str = "cie94",
) -> torch.Tensor:
    """Farthest-point seeding: `pixels[N, 3]` Lab -> `[k, 3]` centroids.
    Centroid 0 is `pixels[first_index]`; each next one is the pixel with the
    largest distance to the chosen set (first maximum wins). With
    `k_active < k` the trailing rows stay zero and must stay masked."""
    k_active = k if k_active is None else k_active
    _, dist_sq = metric_fns(metric)
    centroids = torch.zeros((k, 3), dtype=torch.float32, device=pixels.device)
    c0 = pixels[first_index]
    centroids[0] = c0
    dmap = dist_sq(pixels, c0[None, :])
    for j in range(1, min(k, k_active)):
        # index_select keeps the pick on the device (no host round trip).
        new_c = torch.index_select(pixels, 0, torch.argmax(dmap).reshape(1))
        centroids[j] = new_c[0]
        dmap = torch.minimum(dmap, dist_sq(pixels, new_c))
    return centroids


def _update_centroids(
    pixels: torch.Tensor, assign: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster `(sums [K, 3], counts [K])` through a one-hot float32
    matrix product, as the reference does on its matrix unit. The product
    must run in full float32: on CUDA, TF32 would perturb the sums enough
    to flip convergence votes, so this raises if TF32 matmuls are enabled
    (PyTorch's default leaves them off)."""
    if pixels.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the k-means update needs full float32 matmuls; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    onehot = torch.zeros(
        (pixels.shape[0], k), dtype=torch.float32, device=pixels.device
    ).scatter_(1, assign[:, None], 1.0)
    sums = onehot.T @ pixels
    counts = onehot.sum(dim=0)
    return sums, counts


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
) -> tuple[torch.Tensor, int]:
    """Lloyd iterations on the one-hot product update
    (kmeans_tpu/models/kmeans.py:184). Returns
    `(centroids [k, 3], iterations_run)`."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, pixels.device)

    def totals(cents):
        return _update_centroids(pixels, assign_clusters(pixels, cents, valid, metric), k)

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def lloyd_accumulated(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    plane_dtype: str | None = None,
) -> tuple[torch.Tensor, int]:
    """Lloyd loop on the tile accumulator: the port of `lloyd_pallas`
    (kmeans_tpu/models/kmeans.py:241). The pixels are packed once into
    `[3, M, 128]` planes; each iteration is one `lloyd_accumulate` pass
    (assignment and per-cluster sums together, no `[N, K]` one-hot).
    `plane_dtype="bfloat16"` stores the planes half-width, which quantizes
    the training input (opt-in, as in the reference)."""
    if plane_dtype not in _PLANE_DTYPES:
        raise ValueError(f"plane_dtype must be None or 'bfloat16', got {plane_dtype!r}")
    planes, n_valid = pack_lab_planes(pixels, _PLANE_DTYPES[plane_dtype])

    def totals(cents):
        t = lloyd_accumulate(planes, cents, n_valid, k_active=k_active, metric=metric)
        return t[:, :3], t[:, 3]

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def _chunks(pixels: torch.Tensor):
    return torch.split(pixels, _CHUNK_PIXELS)


def _assign_chunked(pixels, centroids, valid, metric):
    """`assign_clusters` over row chunks: no `[N, K]` intermediate
    (kmeans_tpu/models/kmeans.py:558)."""
    return torch.cat([assign_clusters(px, centroids, valid, metric) for px in _chunks(pixels)])


def _update_chunked(pixels, assign, k):
    """`_update_centroids` over row chunks, the partial (sums, counts)
    added in chunk order (kmeans_tpu/models/kmeans.py:572)."""
    parts = [
        _update_centroids(px, asg, k)
        for px, asg in zip(_chunks(pixels), torch.split(assign, _CHUNK_PIXELS))
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
) -> tuple[torch.Tensor, int]:
    """`lloyd` with every `[N, K]` intermediate cut into row chunks: the
    memory-bounded trainer for large pixel counts at k > `ACCUM_MAX_K`
    (kmeans_tpu/models/kmeans.py:596). Plain PyTorch, as in the reference,
    which runs it outside any kernel."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, pixels.device)

    def totals(cents):
        return _update_chunked(pixels, _assign_chunked(pixels, cents, valid, metric), k)

    return _lloyd_loop(centroids, totals, convergence, max_iterations, k_active, metric)


def fit(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
) -> tuple[torch.Tensor, int]:
    """Seed + Lloyd: `pixels[N, 3]` -> `(centroids [k, 3], iterations)`
    (kmeans_tpu/models/kmeans.py:719)."""
    centroids = plusplus_init(pixels, k, first_index, k_active, metric)
    return lloyd(pixels, centroids, convergence, max_iterations, k_active, metric)


def fit_large(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
    plane_dtype: str | None = None,
) -> tuple[torch.Tensor, int]:
    """`fit` for large pixel counts: float32 seeding, then
    `lloyd_accumulated` (kmeans_tpu/models/kmeans.py:431)."""
    centroids = plusplus_init(pixels, k, first_index, k_active, metric)
    return lloyd_accumulated(
        pixels, centroids, convergence, max_iterations, k_active, metric, plane_dtype
    )


def derive_restart_seeds(n: int, first_index: int, restarts: int) -> torch.Tensor:
    """Flat seed-pixel indices of `restarts` runs, `[restarts]` int32 on
    the CPU: restart 0 is `first_index`, restart r adds
    `floor(r * 0.618... * n)` in float32, modulo `n`
    (kmeans_tpu/models/kmeans.py:333)."""
    golden = torch.tensor(0.6180339887498949, dtype=torch.float32)
    offs = torch.floor(torch.arange(restarts, dtype=torch.float32) * golden * n)
    offs = offs.to(torch.int32)
    return torch.remainder(torch.tensor(first_index, dtype=torch.int32) + offs, n)


def _best_of_restarts(fit_one, inertia, n, first_index, restarts):
    """Run `fit_one(seed)` for each seed of `derive_restart_seeds`, one
    after another, and return the `(centroids, iterations)` of the run
    whose `inertia(centroids)` is lowest; on a tie the first, as
    `argmin` takes it."""
    runs, inertias = [], []
    for seed in derive_restart_seeds(n, first_index, restarts).tolist():
        cents, iters = fit_one(seed)
        runs.append((cents, iters))
        inertias.append(inertia(cents))
    return runs[int(torch.argmin(torch.stack(inertias)).item())]


def _sum_min_d2(pixels, centroids, valid, metric) -> torch.Tensor:
    """Sum over pixels of the squared delta-E to the nearest active
    centroid, one row chunk at a time."""
    return torch.stack([
        torch.sum(torch.min(_masked_d2(px, centroids, valid, metric), dim=1).values)
        for px in _chunks(pixels)
    ]).sum()


def fit_restarts(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
) -> tuple[torch.Tensor, int]:
    """`fit` with `restarts` seedings from `derive_restart_seeds`; the run
    with the lowest within-cluster inertia wins
    (kmeans_tpu/models/kmeans.py:368). The reference trains the restarts
    in one vmapped loop that freezes converged runs, so each run equals a
    single `fit` from its seed; here they run one after another."""
    def one(seed):
        return fit(pixels, k, seed, convergence, max_iterations, k_active, metric)

    if restarts <= 1:
        return one(first_index)
    valid = _valid(k, k_active, pixels.device)
    return _best_of_restarts(
        one, lambda c: _sum_min_d2(pixels, c, valid, metric),
        pixels.shape[0], first_index, restarts,
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
) -> tuple[torch.Tensor, int]:
    """`fit_large` with `restarts` seedings (kmeans_tpu/models/kmeans.py:477).
    Each run's inertia is one extra accumulator pass with
    `emit_inertia=True` on float32 planes, whatever `plane_dtype` trained
    it (`:519-547`); the lowest wins."""
    def one(seed):
        return fit_large(pixels, k, seed, convergence, max_iterations,
                         k_active, metric, plane_dtype)

    if restarts <= 1:
        return one(first_index)
    planes, n_valid = pack_lab_planes(pixels)

    def inertia(cents):
        totals = lloyd_accumulate(planes, cents, n_valid, k_active=k_active,
                                  metric=metric, emit_inertia=True)
        return torch.sum(totals[:, 4])

    return _best_of_restarts(one, inertia, pixels.shape[0], first_index, restarts)


def fit_chunked(
    pixels: torch.Tensor,
    k: int,
    first_index: int,
    restarts: int = 1,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
) -> tuple[torch.Tensor, int]:
    """Memory-bounded fit: seeding + `lloyd_chunked`; restarts run one
    after another with a chunked inertia (kmeans_tpu/models/kmeans.py:652)."""
    def one(seed):
        cents = plusplus_init(pixels, k, seed, k_active, metric)
        return lloyd_chunked(pixels, cents, convergence, max_iterations, k_active, metric)

    if restarts <= 1:
        return one(first_index)
    valid = _valid(k, k_active, pixels.device)
    return _best_of_restarts(
        one, lambda c: _sum_min_d2(pixels, c, valid, metric),
        pixels.shape[0], first_index, restarts,
    )
