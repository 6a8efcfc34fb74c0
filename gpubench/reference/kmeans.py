"""K-means in CIELAB under CIE94, in plain PyTorch: the benchmark's reference
for the trained palettes.

The semantics the quantizer states, written out once more:

- CIE94 with the pixel (or candidate) first: S_C and S_H take the first
  argument's chroma. An argmin over the squared distance picks the first
  minimum.
- Seeding: farthest point. Centroid 0 is the pixel at `first_seed_index`;
  each next one is the pixel with the largest distance to the chosen set
  (the first maximum wins), the running minimum kept incrementally. The
  distance maps are taken on the folded Lab (`colour.srgb8_to_lab_folded`),
  the first one of a solo training with a* and b* recomputed inline, and
  the seeds' values are the training Lab.
- Lloyd: each step assigns every pixel to its nearest centroid and takes
  per-cluster sums and counts through a one-hot product in float64,
  rounded to float32; new centroid = sum / count, an empty cluster keeps
  its value and votes "not converged". Convergence is checked after steps
  8, 16, ... only (0-based step `j > 0`, `j % 8 == 0`): every centroid must
  have moved less than 1.0 by CIE94 (new centroid first). At most 128
  steps. A batch trains each member alone; a member that converged stops
  moving.

Large trainings run in row blocks of `BLOCK_PIXELS`; their float64 sums
are added across blocks before the one rounding to float32.

`lowp=True` is the control: the Lab pixels, centroids and every distance
in bfloat16, the sums rounded to bfloat16, the first map not inlined.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.colour import fma

MAX_STEPS = 128
CHECK_EVERY = 8
CONVERGENCE = 1.0
BLOCK_PIXELS = 1 << 20
K1 = 0.045
K2 = 0.015
F32_K1 = float(np.float32(K1))
F32_K2 = float(np.float32(K2))


def d2_cie94(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """Squared CIE94 distance, broadcasting over leading axes."""
    dl = lab1[..., 0] - lab2[..., 0]
    da = lab1[..., 1] - lab2[..., 1]
    db = lab1[..., 2] - lab2[..., 2]
    c1 = torch.sqrt(lab1[..., 1] * lab1[..., 1] + lab1[..., 2] * lab1[..., 2])
    c2 = torch.sqrt(lab2[..., 1] * lab2[..., 1] + lab2[..., 2] * lab2[..., 2])
    dcab = c1 - c2
    dhab_sq = torch.clamp(da * da + db * db - dcab * dcab, min=0.0)
    sc = 1.0 + K1 * c1
    sh = 1.0 + K2 * c1
    t = dcab / sc
    return dl * dl + t * t + dhab_sq / (sh * sh)


def dist_cie94(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d2_cie94(lab1, lab2))


def first_seed_index(width: int, height: int) -> int:
    """Flat index of the first seed: `fract(sin(seed * (12.9898 + 78.233))
    * 43758.5453)` in float32 for x (seed 42) and y (seed 12)."""

    def rand(seed: float) -> float:
        v = np.float32(seed) * (np.float32(12.9898) + np.float32(78.233))
        s = np.sin(np.float32(v), dtype=np.float32) * np.float32(43758.5453)
        return float(s - np.floor(s))

    x = min(int(width * rand(42.0)), width - 1)
    y = min(int(height * rand(12.0)), height - 1)
    return y * width + x


def first_map_inline(space: torch.Tensor, inline: torch.Tensor, c0: torch.Tensor):
    """The first seeding map with the pixel's a* and b* taken inline: each
    channel difference `inline - c0` rounded once, the sums as fused
    multiply-adds. `space [N, 3]`, `inline [N, 3]` float64, `c0 [3]`."""
    c0 = c0[None, :]
    la, lb = space[..., 1], space[..., 2]
    ca, cb = c0[..., 1], c0[..., 2]
    c1 = torch.sqrt(fma(la, la, lb * lb))
    c2 = torch.sqrt(fma(ca, ca, cb * cb))
    dl, da, db = (inline - c0.double()).float().unbind(-1)
    dc = c1 - c2
    s_c = fma(c1, F32_K1, 1.0)
    s_h = fma(c1, F32_K2, 1.0)
    dh2 = torch.clamp(fma(-dc, dc, fma(da, da, db * db)), min=0.0)
    q = dc / s_c
    return fma(q, q, dl * dl) + dh2 / (s_h * s_h)


def seed(pixels: torch.Tensor, k: int, first: int, space: torch.Tensor,
         inline: torch.Tensor | None) -> torch.Tensor:
    """Farthest-point seeds `[k, 3]` of `pixels [N, 3]`, the maps on
    `space` (and the first on `inline` when given)."""
    n = space.shape[0]
    picks = torch.zeros(k, dtype=torch.int64, device=pixels.device)
    picks[0] = first
    rows = torch.index_select(space, 0, picks[:1].expand(n))
    dmap = (first_map_inline(space, inline, rows[0]) if inline is not None
            else d2_cie94(space, rows))
    for j in range(1, k):
        idx = torch.argmax(dmap).reshape(1)
        picks[j:j + 1] = idx
        dmap = torch.minimum(dmap, d2_cie94(space, torch.index_select(space, 0, idx.expand(n))))
    return torch.index_select(pixels, 0, picks)


def seed_batched(pixels: torch.Tensor, k: int, first: int, space: torch.Tensor) -> torch.Tensor:
    """`seed` of each member of `pixels [M, N, 3]` at once -> `[M, k, 3]`."""
    m, n = pixels.shape[0], pixels.shape[1]
    rows = torch.arange(m, device=pixels.device)[:, None]
    picks = torch.full((m, k), first, dtype=torch.int64, device=pixels.device)
    dmap = d2_cie94(space, space[rows, picks[:, :1].expand(m, n)])
    for j in range(1, k):
        idx = torch.argmax(dmap, dim=1, keepdim=True)
        picks[:, j] = idx[:, 0]
        dmap = torch.minimum(dmap, d2_cie94(space, space[rows, idx.expand(m, n)]))
    return pixels[rows, picks]


def nearest(pixels: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Index of each pixel's nearest centroid, `[N]` int64, in row blocks."""
    return torch.cat([torch.argmin(d2_cie94(px[:, None, :], centroids[None, :, :]), dim=1)
                      for px in torch.split(pixels, BLOCK_PIXELS)])


def onehot_totals(pixels: torch.Tensor, assign: torch.Tensor, k: int):
    """float64 `(sums [k, 3], counts [k])` of one block by a one-hot product."""
    onehot = torch.zeros((pixels.shape[0], k), dtype=torch.float64,
                         device=pixels.device).scatter_(1, assign[:, None], 1.0)
    return onehot.T @ pixels.to(torch.float64), onehot.sum(dim=0)


def totals(pixels: torch.Tensor, centroids: torch.Tensor):
    """Per-cluster `(sums, counts)` of the assignment to `centroids`, in the
    centroids' dtype: float64 over all blocks, rounded once."""
    k = centroids.shape[0]
    sums = counts = None
    for px in torch.split(pixels, BLOCK_PIXELS):
        s, c = onehot_totals(px, nearest(px, centroids), k)
        sums, counts = (s, c) if sums is None else (sums + s, counts + c)
    return sums.to(centroids.dtype), counts.to(centroids.dtype)


def lloyd(pixels: torch.Tensor, centroids: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Lloyd steps from `centroids` until the stop rule; `(centroids, steps)`."""
    steps = 0
    for j in range(MAX_STEPS):
        sums, counts = totals(pixels, centroids)
        nonempty = counts > 0
        new = torch.where(nonempty[:, None], sums / torch.clamp(counts, min=1.0)[:, None],
                          centroids)
        checked = j > 0 and j % CHECK_EVERY == 0
        converged = checked and bool(torch.all(
            nonempty & (dist_cie94(new, centroids) < CONVERGENCE)).item())
        centroids, steps = new, j + 1
        if converged:
            break
    return centroids, steps


def lloyd_batched(pixels: torch.Tensor, centroids: torch.Tensor):
    """`lloyd` of each member of `pixels [M, N, 3]` in one loop; a member
    that converged keeps its centroids and step count. Returns
    `(centroids [M, k, 3], steps [M])`."""
    m, k = centroids.shape[0], centroids.shape[1]
    running = torch.ones(m, dtype=torch.bool, device=centroids.device)
    steps = torch.zeros(m, dtype=torch.int64, device=centroids.device)
    for j in range(MAX_STEPS):
        parts = [onehot_totals(pixels[i], nearest(pixels[i], centroids[i]), k) for i in range(m)]
        sums = torch.stack([p[0].to(centroids.dtype) for p in parts])
        counts = torch.stack([p[1].to(centroids.dtype) for p in parts])
        nonempty = counts > 0
        new = torch.where(nonempty[..., None],
                          sums / torch.clamp(counts, min=1.0)[..., None], centroids)
        checked = j > 0 and j % CHECK_EVERY == 0
        if checked:
            converged = torch.all(nonempty & (dist_cie94(new, centroids) < CONVERGENCE), dim=1)
        centroids = torch.where(running[:, None, None], new, centroids)
        steps = torch.where(running, j + 1, steps)
        if checked:
            running = running & ~converged
            if not bool(running.any().item()):
                break
    return centroids, steps
