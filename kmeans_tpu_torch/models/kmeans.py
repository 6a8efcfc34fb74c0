"""K-means colour clustering in CIELAB, in PyTorch.

Port of the training half of `kmeans_tpu/models/kmeans.py` that the
shrunk-image path runs:

- `plusplus_init`: farthest-point seeding from the deterministic
  `reference_seed_index`, with the min-distance map kept incrementally;
- `lloyd`: per-cluster (sum, count) by a one-hot float32 matrix product,
  new centroid = sum / count (empty clusters keep their value and vote
  "not converged"), the CIE94 convergence vote, then re-assignment;
- the reference's stop rule: at most 128 iterations, convergence checked
  after iterations 8, 16, ... only.

The JAX package runs the loop as one `lax.while_loop` on the device. Here
it is a Python loop of eager ops, and each checked iteration reads the
convergence flag back with one `.item()`, a host synchronisation every
8th iteration; the phase recorder bills the wait to `"lloyd_sync"`.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.utils.profiling import phase

MAX_ITERATIONS = 128  # kmeans_tpu/models/kmeans.py:49
CONVERGENCE_CHECK_EVERY = 8
LAB_CONVERGENCE = 1.0

_BIG = 3.4e38  # above any CIE94^2


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


def lloyd(
    pixels: torch.Tensor,
    centroids: torch.Tensor,
    convergence: float = LAB_CONVERGENCE,
    max_iterations: int = MAX_ITERATIONS,
    k_active: int | None = None,
    metric: str = "cie94",
) -> tuple[torch.Tensor, int]:
    """Lloyd iterations with the reference's termination protocol
    (kmeans_tpu/models/kmeans.py:184). After completing 0-based iteration
    `j`, the loop stops only if `j > 0`, `j % 8 == 0` and every active
    centroid voted converged in that iteration. Returns
    `(centroids [k, 3], iterations_run)`."""
    k = centroids.shape[0]
    valid = _valid(k, k_active, pixels.device)
    dist, _ = metric_fns(metric)
    assign = assign_clusters(pixels, centroids, valid, metric)
    iters = 0
    for j in range(max_iterations):
        sums, counts = _update_centroids(pixels, assign, k)
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
        assign = assign_clusters(pixels, centroids, valid, metric)
        iters = j + 1
        if checked and converged:
            break
    return centroids, iters


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
    """`fit` with `restarts` seedings (kmeans_tpu/models/kmeans.py:368).
    Only `restarts=1`, the reference seed, is ported."""
    if restarts != 1:
        raise NotImplementedError(
            "restarts > 1 is not ported to the PyTorch package yet (ROADMAP A.8)"
        )
    return fit(pixels, k, first_index, convergence, max_iterations, k_active, metric)
