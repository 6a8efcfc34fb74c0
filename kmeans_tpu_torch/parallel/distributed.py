"""Pixel-sharded k-means: one image's pixels split over the mesh's pixel axis.

Port of `kmeans_tpu/parallel/distributed.py`. Pixels `[N, 3]` split into
equal row blocks, one a device of a mesh row (N must divide by the row's
length: pad and give the padding weight 0); each step runs on every shard
and only small partials cross to the mesh's first device
(`parallel/collectives.py`):

- farthest-point seeding (`seed_sharded`): each shard's argmax, gathered
  with its global index, the global pick by the single-device rule (the
  first maximum by global index), the pixel taken from the shard that owns
  it. There are no sums, so the seeds are `models/kmeans.py::plusplus_init`'s
  bit for bit on any shard count;
- Lloyd's per-cluster (sum, count): each shard's partials added in shard
  order, then the single-device loop's update, convergence vote and stop
  rule (`models/kmeans.py::_lloyd_loop`, one host synchronisation a check).
  The trainers (`TRAINERS`) differ in the partials:
  - `"onehot"`: the one-hot product in float64 (`onehot_totals`), the
    shards' float64 totals added and rounded once, so one shard gives the
    single-device `lloyd`'s bits;
  - `"pallas"`: the tile accumulator (`ops/kernels.py::lloyd_accumulate`,
    `csrc/lloyd_accumulate.cu` on the card) on each shard's planes and
    weight plane, one launch a shard a step, its `[K, 4]` float32 totals
    added (the reference's name for its Pallas kernel route);
  - `"chunked"`: the row-chunked update (`_update_chunked`), float32.

With `restarts > 1` the seeds of `derive_restart_seeds` train one after
another and the run of least psum'd inertia wins, as on one device.
`fit_sharded_batch` splits frames over the mesh's data axis: each frame
trains on the pixel axis of its data row.

A pixel of weight 0 never seeds (its distance is pinned to -1) and adds
exact zeros. `weight=None` means every pixel is real, as the single-device
trainers read it.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.models.kmeans import LAB_CONVERGENCE
from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.ops.kernels import lloyd_accumulate, pack_lab_planes
from kmeans_tpu_torch.parallel.collectives import all_gather, psum, replicate, to_device
from kmeans_tpu_torch.parallel.mesh import DATA_AXIS

TRAINERS = ("onehot", "pallas", "chunked")
_NO_INDEX = torch.iinfo(torch.int64).max


class _Shards:
    """One image's pixels `[N, 3]` (and weights `[N]`) in equal row blocks,
    block s on `devices[s]`; `root` is `devices[0]`."""

    def __init__(self, devices, pixels: torch.Tensor, weight: torch.Tensor | None):
        n, p = pixels.shape[0], len(devices)
        if n % p:
            raise ValueError(f"{n} pixels do not split over {p} shards: pad them (weight 0)")
        self.n, self.n_local, self.devices, self.root = n, n // p, list(devices), devices[0]
        self.pixels = self._split(pixels.to(torch.float32))
        self.weight = (None if weight is None else self._split(weight.to(torch.float32)))

    def _split(self, t: torch.Tensor) -> list:
        m = self.n_local
        return [to_device(t[s * m:(s + 1) * m], d).contiguous()
                for s, d in enumerate(self.devices)]

    def weight_of(self, s: int):
        return None if self.weight is None else self.weight[s]

    def full_weight(self):
        """The weights on the host, for `derive_restart_seeds`."""
        return None if self.weight is None else torch.cat([w.cpu() for w in self.weight])


def _global_argmax(dmaps, n_local: int, root):
    """`(value, global flat index)` of the largest entry of the shards'
    distance maps, the first by global index on a tie
    (kmeans_tpu/parallel/distributed.py:52): each shard's argmax, gathered
    on `root`."""
    vals, idxs = [], []
    for s, d in enumerate(dmaps):
        i = torch.argmax(d).reshape(1)
        vals.append(torch.index_select(d, 0, i))
        idxs.append(i + s * n_local)
    vals, idxs = all_gather(vals, root)[:, 0], all_gather(idxs, root)[:, 0]
    best = torch.max(vals)
    return best, torch.min(torch.where(vals == best, idxs, torch.full_like(idxs, _NO_INDEX)))


def _take_global(pixels, index: torch.Tensor, n_local: int, root) -> torch.Tensor:
    """Pixel `index` (a 0-dim int64 on `root`) of the sharded store as `[1,
    3]` on `root`, from the shard that owns it (distributed.py:68): a
    selection, not a sum, so the pixel keeps its bits."""
    out = None
    for s, (px, i) in enumerate(zip(pixels, replicate(index, [p.device for p in pixels]))):
        lo = s * n_local
        at = torch.clamp(i - lo, 0, n_local - 1).reshape(1)
        local = to_device(torch.index_select(px, 0, at), root)
        out = local if out is None else torch.where((index >= lo) & (index < lo + n_local),
                                                    local, out)
    return out


def _seed(shards: _Shards, k: int, first_index: int, k_active=None, metric="cie94"):
    """`plusplus_init` over the shards (distributed.py:79): `[k, 3]` on the
    root; rows past `k_active` stay zero."""
    k_active = k if k_active is None else int(k_active)
    _, dist_sq = metric_fns(metric)
    root = shards.root
    centroids = torch.zeros((k, 3), dtype=torch.float32, device=root)
    s0, i0 = divmod(int(first_index), shards.n_local)
    c0 = to_device(shards.pixels[s0][i0:i0 + 1], root)
    centroids[0] = c0[0]
    # Each map against the pick's row repeated, laid out as the shard, as
    # `plusplus_init` takes it: the CPU's vectorized and scalar `atan2`
    # differ in the last bit, which would leave an exact tie above 0.
    dmaps = [dist_sq(px, c.expand_as(px).contiguous())
             for px, c in zip(shards.pixels, replicate(c0, shards.devices))]
    if shards.weight is not None:
        dmaps = [torch.where(w > 0, d, torch.full_like(d, -1.0))
                 for d, w in zip(dmaps, shards.weight)]
    for j in range(1, min(k, k_active)):
        _, index = _global_argmax(dmaps, shards.n_local, root)
        new_c = _take_global(shards.pixels, index, shards.n_local, root)
        centroids[j] = new_c[0]
        dmaps = [torch.minimum(d, dist_sq(px, c.expand_as(px).contiguous()))
                 for d, px, c in zip(dmaps, shards.pixels, replicate(new_c, shards.devices))]
    return centroids


def seed_sharded(mesh, pixels, weight, k: int, first_index: int, k_active=None,
                 metric: str = "cie94") -> torch.Tensor:
    """The sharded farthest-point seeds of `pixels` over the mesh's pixel
    axis: `[k, 3]` on the mesh's first device, equal to
    `plusplus_init(pixels, k, first_index, k_active, metric, weight)`."""
    return _seed(_Shards(mesh.row(0), pixels, weight), k, first_index, k_active, metric)


def _loop(shards, centroids, partials, combine, convergence, k_active, metric):
    """The single-device Lloyd loop (`_lloyd_loop`) whose totals are the
    shards' `partials(s, centroids on s's device)` joined by `combine`."""
    def totals(cents):
        return combine([partials(s, c) for s, c in enumerate(replicate(cents, shards.devices))])

    return km._lloyd_loop(centroids, totals, convergence, km.MAX_ITERATIONS, k_active, metric)


def _onehot(shards, k, k_active, metric, fast, plane_dtype):
    """The one-hot trainer (distributed.py:116, 180): float64 partials,
    added in float64 and rounded once."""
    valid = [km._valid(k, k_active, d) for d in shards.devices]
    root = shards.root

    def partials(s, cents):
        px = shards.pixels[s]
        return km.onehot_totals(px, km.assign_clusters(px, cents, valid[s], metric), k,
                                shards.weight_of(s))

    def combine(parts):
        return (psum([p[0] for p in parts], root).to(torch.float32),
                psum([p[1] for p in parts], root).to(torch.float32))

    def inertia(cents):
        return psum([km._sum_min_d2(px, c, valid[s], metric, shards.weight_of(s))
                     for s, (px, c) in enumerate(zip(shards.pixels,
                                                     replicate(cents, shards.devices)))], root)

    return partials, combine, inertia


def _pallas(shards, k, k_active, metric, fast, plane_dtype):
    """The accumulator trainer (distributed.py:232, 319, 352): one
    `lloyd_accumulate` a shard a step on its planes and weight plane, the
    `[K, 4]` totals added; the inertia is the `emit_inertia` column on
    float32 planes, summed. `fast` acts at k > 16, as on one device."""
    if plane_dtype not in km._PLANE_DTYPES:
        raise ValueError(f"plane_dtype must be None or 'bfloat16', got {plane_dtype!r}")
    packed = [pack_lab_planes(px, km._PLANE_DTYPES[plane_dtype]) for px in shards.pixels]
    wplanes = [km._weight_plane(shards.weight_of(s)) for s in range(len(shards.devices))]
    step_fast = bool(fast) and k > 16
    root = shards.root
    f32 = []

    def partials(s, cents):
        planes, n_valid = packed[s]
        return lloyd_accumulate(planes, cents, n_valid, k_active=k_active,
                                weight_planes=wplanes[s], metric=metric, fast=step_fast)

    def combine(parts):
        t = psum(parts, root)
        return t[:, :3], t[:, 3]

    def inertia(cents):
        if not f32:
            f32.extend(packed if plane_dtype is None else
                       [pack_lab_planes(px) for px in shards.pixels])
        return psum([torch.sum(lloyd_accumulate(
            planes, c, n_valid, k_active=k_active, weight_planes=wplanes[s], metric=metric,
            emit_inertia=True, fast=bool(fast) and metric == "cie2000")[:, 4])
            for s, ((planes, n_valid), c) in enumerate(zip(f32, replicate(cents,
                                                                         shards.devices)))],
            root)

    return partials, combine, inertia


def _chunked(shards, k, k_active, metric, fast, plane_dtype):
    """The row-chunked trainer (distributed.py:391, 446): each shard's
    `_update_chunked` float32 partials, added."""
    valid = [km._valid(k, k_active, d) for d in shards.devices]
    root = shards.root

    def partials(s, cents):
        px = shards.pixels[s]
        return km._update_chunked(px, km._assign_chunked(px, cents, valid[s], metric), k,
                                  shards.weight_of(s))

    def combine(parts):
        return psum([p[0] for p in parts], root), psum([p[1] for p in parts], root)

    def inertia(cents):
        return psum([km._sum_min_d2(px, c, valid[s], metric, shards.weight_of(s))
                     for s, (px, c) in enumerate(zip(shards.pixels,
                                                     replicate(cents, shards.devices)))], root)

    return partials, combine, inertia


_BODIES = {"onehot": _onehot, "pallas": _pallas, "chunked": _chunked}


def _fit_row(devices, pixels, weight, k, first_index, convergence, k_active, metric, restarts,
             trainer, fast, plane_dtype):
    """`fit_sharded` over the pixel-axis `devices` of one mesh row."""
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}")
    shards = _Shards(devices, pixels, weight)
    partials, combine, inertia = _BODIES[trainer](shards, k, k_active, metric, fast,
                                                  plane_dtype)

    def fit_one(seed):
        cents = _seed(shards, k, seed, k_active, metric)
        return _loop(shards, cents, partials, combine, convergence, k_active, metric)

    if restarts <= 1:
        return fit_one(first_index)
    return km._best_of_restarts(fit_one, inertia, shards.n, first_index, restarts,
                                shards.full_weight())


def fit_sharded(
    mesh,
    pixels: torch.Tensor,
    weight: torch.Tensor | None,
    k: int,
    first_index: int,
    convergence: float = LAB_CONVERGENCE,
    k_active=None,
    metric: str = "cie94",
    restarts: int = 1,
    trainer: str = "onehot",
    fast: bool = False,
    plane_dtype=None,
):
    """Pixel-sharded fit of one image (kmeans_tpu/parallel/distributed.py:497):
    `pixels[N, 3]` Lab split over the mesh's pixel axis (N a multiple of
    its size; pad with weight 0), trained by `trainer` (`TRAINERS`, the
    routes of `api._sharded_trainer_route`). `fast` and `plane_dtype`
    reach the `"pallas"` trainer only. Returns `(centroids [k, 3] on the
    mesh's first device, iterations)`."""
    return _fit_row(mesh.row(0), pixels, weight, k, first_index, convergence, k_active, metric,
                    restarts, trainer, fast, plane_dtype)


def fit_frames(mesh, pixels, weight, k, first_index, k_actives, convergence=LAB_CONVERGENCE,
               metric="cie94", restarts=1, trainer="onehot", fast=False, plane_dtype=None):
    """`fit_sharded_batch` with each frame's iterations: `(centroids [B, k,
    3] on the mesh's first device, [B] ints)`. `pixels` is `[B, N, 3]` or
    a list of B `[N, 3]` tensors (each best on its data row's first
    device), `weight` None, `[B, N]` or a list."""
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}")
    b, data = len(pixels), mesh.shape[DATA_AXIS]
    if b % data:
        raise ValueError(f"{b} frames do not split over the data axis of {data}")
    firsts = np.broadcast_to(np.asarray(first_index, dtype=np.int64).reshape(-1), (b,))
    k_actives = [int(a) for a in np.broadcast_to(np.asarray(k_actives).reshape(-1), (b,))]
    cents, iters = [], []
    for i in range(b):
        c, it = _fit_row(mesh.row(i // (b // data)), pixels[i],
                         None if weight is None else weight[i], k, int(firsts[i]), convergence,
                         k_actives[i], metric, restarts, trainer, fast, plane_dtype)
        cents.append(to_device(c, mesh.root))
        iters.append(it)
    return torch.stack(cents), iters


def fit_sharded_batch(
    mesh,
    pixels,
    weight,
    k: int,
    first_index,
    k_actives,
    convergence: float = LAB_CONVERGENCE,
    metric: str = "cie94",
    restarts: int = 1,
    trainer: str = "onehot",
    fast: bool = False,
    plane_dtype=None,
) -> torch.Tensor:
    """Batched fit (kmeans_tpu/parallel/distributed.py:628): frames
    `pixels[B, N, 3]` over the mesh's data axis (B a multiple of its
    size; frame b on data row `b // (B / data)`), each frame's pixels over
    that row's pixel axis, with its own `k_actives[b]` and seed
    (`first_index` one int or B of them). Frames train one after another,
    each as `fit_sharded` trains it. Returns `centroids [B, k, 3]` on the
    mesh's first device."""
    return fit_frames(mesh, pixels, weight, k, first_index, k_actives, convergence, metric,
                      restarts, trainer, fast, plane_dtype)[0]
