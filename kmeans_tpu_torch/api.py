"""Public API: `ImageProcessor` with `palette` / `find` / `reduce` and the
frame batches, in PyTorch.

Port of the k-means path of `kmeans_tpu/api.py`. The entry points keep
the reference's signatures and results:

- `palette(k, image)` -> `[k, 4]` RGBA8 colours sorted by Lab L* ascending;
- `find(image, colors, mode)` -> the image recoloured with a fixed palette;
- `reduce(k, image, algo, mode)` -> the image recoloured with a trained
  palette;
- `find_batch(images, colors, mode)`, `reduce_images(images, k, mode)`,
  `palette_images(images, k)` and `reduce_batch(image, ks, mode)`: the
  same over frames of one size (GIF frames), or one image at several k.

`reduce` runs the reference's indexed and meld routes
(`api.py:1419-1503`): the host strips alpha and uploads RGB; on the device
the image is shrunk to the training size (<= 256 px, or full resolution
with `train_max_size=None`), converted to Lab and clustered by the trainer
that `_fit_auto` picks (`models/kmeans.py`; past the reference's size
gates, the tile accumulator `ops/kernels.py::lloyd_accumulate`, a CUDA
kernel on the card). For replace and dither the assign pass
(`ops/kernels.py::assign_packed`, a CUDA kernel on the card) writes
bit-packed palette indices, and the host reads back the words and the
palette and unpacks them into RGBA; past `INDEXED_MAX_K` colours the same
kernel writes each pixel's RGBA word (`quantize_rgba`), read back as it
is. For meld the meld pass (`ops/kernels.py::meld_packed`, a CUDA kernel
on the card) writes the blended pixels as packed RGB bytes, and the host
unpacks them. The host's alpha strip and unpacks run the native runtime
(`kmeans_tpu_torch/runtime/`), as the reference's run its extension.
`find` runs the same output passes with the caller's palette. The frame
batches train every frame in one batched Lloyd loop
(`fit_restarts_batched`) and recolour all frames in one launch of the
kernels' frames mode, each frame with its own palette. `delta_e="2000"`
puts CIEDE2000 in place of CIE94 in training, dithering and the output
passes. `fast=True` puts the fast tiers of `ops/kernels.py` (the
factorized CIE94 score, the pruned CIEDE2000 tier) under the accumulator
route's training and under the output passes (not under `reduce_batch`'s,
as in the reference); they act at 16 < k <= 512 only, and outside that
range the results equal `fast=False` bit for bit. The shrunk, batched and
row-chunked trainings never see `fast`, as in the reference.

`algo=Algorithm.OCTREE`, `MEDIANCUT` or `WU` (`palette`, `reduce`,
`palette_images`, `palette_many`) runs the reference's host palette
algorithms (`models/octree.py`, `models/mediancut.py`, `models/wu.py`,
numpy): the image shrinks to `OCTREE_MAX_SIZE` on the device, as the
reference runs that shrink, op by op (`ops/resize.py::resize_uint8_eager`;
under bucketing the canvas shrink `resize_to_canvas`), its bytes come back
to the host for the algorithm, and `reduce` recolours with the resulting
palette through the same output passes as `find`.

`ImageProcessor(bucketing=True)` is the reference's serving mode
(`kmeans_tpu/api.py:1148-1260`, `utils/bucketing.py`): each image pads
bottom and right to its shape bucket, the training shrink lands in a
fixed canvas whose padding trains with weight 0
(`ops/resize.py::resize_to_canvas`), the cluster axis pads to
`bucket_k(k)` with the real count in `k_active`, the output pass runs on
the padded image and the host crops. Eager PyTorch compiles nothing per
shape, so a bucket here is what coalesces requests of different sizes:
`reduce_many`, `find_many` and `palette_many` group same-bucket images
into one batched Lloyd loop and one frames launch, and `warmup` issues one
dummy request per key the reference would compile, which builds the CUDA
library and launches every kernel instance those sizes reach before the
first real request.

Images larger than device memory go through the card in row bands
(`reduce_streamed`, `palette_streamed`, `find_streamed`; the reference's
`api.py:2468-2675`), so device memory holds one band, not the image: the
bands shrink along their columns into a training strip that trains as a
bucketed image, then each band, padded to its bucket, takes the output
pass with its first row as the dither `row_offset` and unpacks into its
rows of the host output. `reduce_pipelined` runs `reduce` over many
images with the next ones' uploads and the last ones' unpacks in worker
threads beside the training (a side stream, page-locked buffers and
events on the card).

The `*_sharded` entry points (`find_sharded`, `palette_sharded`,
`reduce_sharded`, `reduce_images_sharded`, `palette_images_sharded`,
`find_batch_sharded`; the reference's `api.py:1996-2468`) run over a mesh
of devices in this one process (`parallel/`): the training's pixels split
over the mesh's pixel axis, each shard's partial sums added in shard order
on the first device, and the output pass's rows split likewise, each shard
launching the same kernels with its own `row_offset`; frames split over the
data axis. `mesh=` picks the devices (`parallel.make_mesh`; a device may
repeat, so one card runs the 2- and 4-shard code), `None` every visible
card (the CPU alone for a CPU processor).

`ImageProcessor(pipeline=True)` is the reference's pipeline mode
(`kmeans_tpu/api.py:83-91, 984-996`): the k-means trainings of `palette`,
`palette_images` and `palette_many` upload a training strip shrunk on the
host (`ops/resize.py::resize_uint8_np`, about 0.1 MB at 4K) instead of the
image (about 25 MB), the host palette algorithms shrink on the host with no
transfer, and `reduce` of an image of at least `PIPELINE_BAND_ROWS *
PIPELINE_MIN_BANDS` rows (replace and dither, up to `INDEXED_MAX_K`
colours, unbucketed, with a training cap) trains on that strip first, then
sends the image through the card in bands of `PIPELINE_BAND_ROWS` rows
(`_reduce_banded`): on the card each band's host strip, upload, output
pass, readback and unpack overlap the other bands' and the training. The
host shrink rounds a sample at an exact 0.5 tie one u8 step apart from the
device shrink now and then, so a palette may move by a step; the output
pass is per pixel, so the bands give the monolithic pass's pixels for the
same centroids.

The device is explicit: `ImageProcessor(device=None)` means CUDA and
raises when there is none. The plain-PyTorch CPU path runs only when the
caller names `device="cpu"`; nothing falls back to another path.
"""

from __future__ import annotations

import contextlib
import contextvars
from concurrent.futures import Future, ThreadPoolExecutor
from enum import Enum

import numpy as np
import torch

from kmeans_tpu_torch import runtime
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.models import kmeans as kmeans_model
from kmeans_tpu_torch.models.kmeans import SeedLab
from kmeans_tpu_torch.models.mediancut import extract_palette_mediancut
from kmeans_tpu_torch.models.octree import extract_palette_octree
from kmeans_tpu_torch.models.wu import extract_palette_wu
from kmeans_tpu_torch.ops._math import div
from kmeans_tpu_torch.ops.colorspace import lab_to_srgb8, srgb8_to_lab, srgb8_to_lab_np
from kmeans_tpu_torch.ops.kernels import (
    ACCUM_MAX_K,
    INDEXED_MAX_K,
    assign_frames_packed,
    assign_packed,
    meld_frames_packed,
    meld_packed,
    quant_tile_rows,
    quantize_frames,
    quantize_rgba,
)
from kmeans_tpu_torch.ops.quantize import dither_threshold, dither_thresholds
from kmeans_tpu_torch.ops.resize import (
    resize_to_canvas,
    resize_uint8,
    resize_uint8_eager,
    resize_uint8_np,
    shrink_columns,
    shrunk_dimensions,
)
from kmeans_tpu_torch.parallel.collectives import shard_rows
from kmeans_tpu_torch.parallel.distributed import fit_frames, fit_sharded
from kmeans_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from kmeans_tpu_torch.parallel.sharded_ops import (
    _assign_words,
    _fetch,
    _meld_words,
    _row_sharded,
    quantize_image_sharded,
    unpack_fused_sharded,
    unpack_meld_sharded,
)
from kmeans_tpu_torch.utils.bucketing import (
    bucket_frames,
    bucket_k,
    bucket_shape,
    next_bucket,
    pad_palette_k,
)
from kmeans_tpu_torch.utils.packing import (
    pack_bits,
    unpack_rgb24_tile_words,
    unpack_tile_words_gather,
)
from kmeans_tpu_torch.utils.profiling import phase as _phase
from kmeans_tpu_torch.utils.profiling import phase_sync as _phase_sync

# Training-image shrink cap (kmeans_tpu/api.py:80).
MAX_IMAGE_DIMENSION = 256
# The host palette algorithms' shrink cap (kmeans_tpu/api.py:82).
OCTREE_MAX_SIZE = 128
# Above this many training pixels (k <= 64) the one-hot update's [N, K]
# intermediate dominates memory and training moves to the tile
# accumulator (kmeans_tpu/api.py:160).
_LARGE_TRAIN_PIXELS = 1 << 20
# For k > 64, the element budget past which the plain trainer's [N, K]
# intermediates leave it (~768 MB each in float32): the tile accumulator
# takes k <= ACCUM_MAX_K, the row-chunked trainer the rest
# (kmeans_tpu/api.py:167).
_CHUNKED_TRAIN_ELEMS = 192 * (1 << 20)
# Images `reduce_pipelined` uploads ahead of the one it trains
# (kmeans_tpu/api.py:2693), and bands the banded `reduce` uploads ahead of
# the one it recolours: overlap without holding every image or band on the
# card.
_PIPELINE_WINDOW = 4
# Pipeline mode's banded `reduce` (kmeans_tpu/api.py:83-91): rows a band,
# and the bands an image must fill before `reduce` goes by bands.
PIPELINE_BAND_ROWS = 512
PIPELINE_MIN_BANDS = 4


class ColorSpace(Enum):
    """Working colour space."""

    LAB = "lab"
    RGB = "rgb"

    @property
    def convergence(self) -> float:
        return {ColorSpace.LAB: 1.0, ColorSpace.RGB: 0.01}[self]


class Algorithm(Enum):
    """Palette algorithm."""

    KMEANS = "kmeans"
    OCTREE = "octree"
    MEDIANCUT = "mediancut"
    WU = "wu"


class ReduceMode(Enum):
    """Output mode."""

    REPLACE = "replace"
    DITHER = "dither"
    MELD = "meld"


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ImageProcessor runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain PyTorch path"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


def _host_rgb(pixels: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """Contiguous `[..., :3]` copy: alpha is ignored by the whole pipeline,
    so only RGB is uploaded (kmeans_tpu/api.py:184). Contiguous RGBA8 input
    takes the native one-pass strip (`runtime.strip_alpha`), as in the
    reference; numpy's strided copy is its twin and serves other input.
    `out` (a writable C-contiguous uint8 array of the result's shape) takes
    the bytes in place of a new array."""
    arr = np.asarray(pixels)
    if arr.dtype == np.uint8 and arr.ndim >= 1 and arr.shape[-1] == 4 and arr.flags.c_contiguous:
        return runtime.strip_alpha(arr, out=out)
    if out is None:
        return np.ascontiguousarray(arr[..., :3])
    out[...] = arr[..., :3]
    return out


def _fit_auto(work, k, first_index, convergence, restarts=1, plane_dtype=None,
              metric="cie94", fast=False, weight=None, k_active=None, seed=None):
    """Pick the trainer as the reference does (kmeans_tpu/api.py:205), with
    its `pallas_ok` read as "the accumulator route": the CUDA kernel on the
    card, its plain twin on the CPU, so both devices run one algorithm.
    Both metrics take that route, as both are in the reference's
    `PALLAS_METRICS`. `plane_dtype` and `fast` reach only the accumulator
    route; `weight` (the bucketed canvas's), `k_active` and `seed`
    (`models/kmeans.py::plusplus_init`) reach every route."""
    def fit_accumulated():
        return kmeans_model.fit_large_restarts(
            work, k, first_index, restarts=restarts, convergence=convergence,
            k_active=k_active, metric=metric, plane_dtype=plane_dtype, fast=fast,
            weight=weight, seed=seed,
        )

    if k > 64 and work.shape[0] * k > _CHUNKED_TRAIN_ELEMS:
        if k <= ACCUM_MAX_K:
            return fit_accumulated()
        return kmeans_model.fit_chunked(
            work, k, first_index, restarts=restarts, convergence=convergence,
            k_active=k_active, metric=metric, weight=weight, seed=seed,
        )
    if k <= 64 and work.shape[0] > _LARGE_TRAIN_PIXELS:
        return fit_accumulated()
    return kmeans_model.fit_restarts(
        work, k, first_index, restarts=restarts, convergence=convergence,
        k_active=k_active, metric=metric, weight=weight, seed=seed,
    )


def _plain_fit_route(n_px: int, kp: int) -> bool:
    """True when `_fit_auto` takes the plain `fit_restarts` for a training
    of `n_px` pixels at `kp` (padded) clusters (kmeans_tpu/api.py:272):
    the only route the coalescers batch; the others (the accumulator, the
    row-chunked trainer) train one image at a time, as solo requests do,
    so a coalesced request keeps solo memory behaviour. The mirror of
    `_fit_auto`'s branches with the reference's `use_pallas` true, as
    `_fit_auto` reads it; keep the two in step."""
    if kp > 64 and n_px * kp > _CHUNKED_TRAIN_ELEMS:
        return False
    return not (kp <= 64 and n_px > _LARGE_TRAIN_PIXELS)


def _sharded_trainer_route(n_px: int, kp: int) -> str:
    """`fit_sharded`'s trainer for a training of `n_px` (real) pixels at `kp`
    (padded) clusters (kmeans_tpu/api.py:294): the sharded mirror of
    `_fit_auto`'s branches, keep the two in step. Past the element budget
    at k > 64 the accumulator (`"pallas"`) up to `ACCUM_MAX_K`, the
    row-chunked trainer above; past `_LARGE_TRAIN_PIXELS` at k <= 64 the
    accumulator; else the one-hot trainer. The reference's route with its
    `use_pallas` true, as `_fit_auto` reads it (the accumulator runs on
    both devices: the CUDA kernel on the card, its twin on the CPU, under
    both metrics), so a one-shard mesh trains as the single-device call
    does; its `fast` does not change the route."""
    if kp > 64 and n_px * kp > _CHUNKED_TRAIN_ELEMS:
        return "pallas" if kp <= ACCUM_MAX_K else "chunked"
    return "pallas" if kp <= 64 and n_px > _LARGE_TRAIN_PIXELS else "onehot"


def _sharded_work(frames_u8: torch.Tensor, sh: int, sw: int, n_pad: int):
    """The pixel-sharded training store of B same-sized `[B, H, W, 3]`
    uint8 frames on their device (kmeans_tpu/api.py:576 `_sharded_work_jit`):
    each frame shrunk to `[sh, sw]` as `_train` shrinks it, Lab, flattened
    and concatenated (frame 0 first: the seed index addresses it), then
    zero rows of weight 0 up to `n_pad`. Returns `(work [n_pad, 3],
    weight [n_pad])`, the weight None when nothing pads (every pixel real,
    as the single-device trainers read no weight)."""
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    shrunk = frames_u8 if (h, w) == (sh, sw) else resize_uint8(frames_u8, sh, sw)
    return _pad_store(srgb8_to_lab(shrunk.reshape(-1, 3)), None, n_pad)


def _pad_store(work: torch.Tensor, weight, n_pad: int):
    """`work [N, 3]` and `weight [N]` (None: all real) padded with zero rows
    of weight 0 to `n_pad` rows (kmeans_tpu/api.py:2218-2222)."""
    n = work.shape[0]
    if n_pad == n:
        return work, weight
    if weight is None:
        weight = torch.ones(n, dtype=torch.float32, device=work.device)
    zeros = torch.zeros((n_pad - n, 3), dtype=work.dtype, device=work.device)
    return (torch.cat([work, zeros]),
            torch.cat([weight, torch.zeros(n_pad - n, dtype=weight.dtype, device=work.device)]))


def _train(pixels_u8, k, train_shape, first_index, convergence, lab=True,
           restarts=1, train_dtype=None, metric="cie94", fast=False):
    """Shrink -> colour space -> seed -> Lloyd, on the pixels' device
    (kmeans_tpu/api.py::_train_jit). Returns `(centroids, iterations)`."""
    sh, sw = train_shape
    if (pixels_u8.shape[0], pixels_u8.shape[1]) != (sh, sw):
        pixels_u8 = resize_uint8(pixels_u8, sh, sw)
    rgb = pixels_u8[..., :3].reshape(-1, 3)
    work = srgb8_to_lab(rgb) if lab else div(rgb.to(torch.float32), 255.0)
    return _fit_auto(work, k, first_index, convergence, restarts, train_dtype, metric, fast,
                     seed=kmeans_model.seed_lab(rgb, lab))


def _lab_palette_to_u8(centroids: torch.Tensor):
    """Lab palette(s) `[..., k, 3]` -> `([..., k, 4]` RGBA8, `[..., k]` L*
    of the u8 colours) (kmeans_tpu/api.py:792)."""
    rgb8 = lab_to_srgb8(centroids)
    lightness = srgb8_to_lab(rgb8)[..., 0]
    alpha = torch.full(rgb8.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb8.device)
    return torch.cat([rgb8, alpha], dim=-1), lightness


def _host_fetch(*tensors) -> tuple:
    return tuple(t.cpu().numpy() for t in tensors)


def _unpack_gather(words, h, w, kp, palette_rgba, out=None) -> np.ndarray:
    """`palette_rgba[indices]` from the packed words (kmeans_tpu/api.py:505)."""
    return unpack_tile_words_gather(
        words, h, w, pack_bits(kp), palette_rgba, tile_rows=quant_tile_rows(kp), out=out
    )


def _unpack_meld(words, h, w, kp, out=None) -> np.ndarray:
    """`[h, w, 4]` RGBA from the meld pass's RGB24 words
    (kmeans_tpu/api.py:494)."""
    return unpack_rgb24_tile_words(words, h, w, tile_rows=quant_tile_rows(kp), out=out)


def _palette_readback(centroids: torch.Tensor, k: int) -> np.ndarray:
    """Centroids -> `[k, 4]` RGBA8 sorted by L* ascending
    (kmeans_tpu/api.py:820)."""
    with _phase("readback"):
        rgba, lightness = _host_fetch(*_lab_palette_to_u8(centroids))
    with _phase("host_sort"):
        rgba, lightness = rgba[:k], lightness[:k]
        return rgba[np.argsort(lightness, kind="stable")]


def _unpack(kind: str, out: np.ndarray, h: int, w: int, kp: int, palette_rgba,
            dest=None) -> np.ndarray:
    """`[h, w, 4]` RGBA8 from one image's host copy of an output pass:
    packed indices and their palette, RGB24 words, or RGBA as it is. The
    output pass may have run on more rows than `h` (a padded band): only
    its first `h` rows unpack. `dest`, a writable C-contiguous `[h, w, 4]`
    uint8 array, takes the pixels in place of a new array."""
    if kind == "indexed":
        return _unpack_gather(out, h, w, kp, palette_rgba, dest)
    if kind == "meld":
        return _unpack_meld(out, h, w, kp, dest)
    if dest is None:
        return out
    dest[...] = out[:h]
    return dest


def _submit(pool, fn, *args) -> Future:
    """`fn(*args)` on `pool`'s thread in a copy of the caller's context
    (so the phase recorder of `utils/profiling.py` sees it), or, with no
    pool, run now in this thread."""
    if pool is not None:
        return pool.submit(contextvars.copy_context().run, fn, *args)
    done = Future()
    done.set_result(fn(*args))
    return done


def _as_image(image) -> Image:
    if isinstance(image, Image):
        return image
    arr = np.asarray(image, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[-1] != 4:
        raise ValueError("expected an Image or an [H, W, 4] uint8 array")
    return Image((arr.shape[1], arr.shape[0]), arr)


def _colors_rgba(colors) -> np.ndarray:
    arr = np.asarray(colors, dtype=np.uint8)
    if arr.ndim == 2 and arr.shape[1] == 3:
        arr = np.concatenate([arr, np.full((arr.shape[0], 1), 255, np.uint8)], axis=1)
    return arr.reshape(-1, 4)


def _colors_to_lab(colors: np.ndarray) -> np.ndarray:
    """User RGBA8 colours -> Lab centroids (host-side numpy)."""
    colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 4)
    return srgb8_to_lab_np(colors[:, :3])


def _cpu_palette_from_rgb(rgb: np.ndarray, k: int, algo) -> np.ndarray:
    """A host palette algorithm over `[N, 3]` RGB rows, sorted by L*
    (kmeans_tpu/api.py:865)."""
    with _phase("host_palette"):
        if algo is Algorithm.MEDIANCUT:
            colors = extract_palette_mediancut(rgb, k)
        elif algo is Algorithm.WU:
            colors = extract_palette_wu(rgb, k)
        else:
            colors = extract_palette_octree(rgb, k)
        return _sort_by_lightness(np.asarray(colors, dtype=np.uint8))


def _sort_by_lightness(colors_u8: np.ndarray) -> np.ndarray:
    """RGBA8 colours sorted by Lab L* ascending (kmeans_tpu/api.py:877)."""
    lightness = srgb8_to_lab_np(colors_u8[:, :3])[:, 0]
    return colors_u8[np.argsort(lightness, kind="stable")]


def _as_frames(images) -> list:
    """Images of one size, as `Image`s; raises on none or mixed sizes."""
    frames = [_as_image(im) for im in images]
    if not frames:
        raise ValueError("need at least one frame")
    if any(f.dimensions != frames[0].dimensions for f in frames):
        raise ValueError("all frames must share dimensions")
    return frames


def _stack_rgb(frames, rows: int) -> np.ndarray:
    """`[B, rows, W, 3]` RGB of the frames, each stripped by `_host_rgb`
    straight into its slot (kmeans_tpu/api.py:1690, 3669-3673); rows past a
    frame's height are zero."""
    h, w = frames[0].pixels.shape[:2]
    stack = np.empty((len(frames), rows, w, 3), np.uint8)
    for i, f in enumerate(frames):
        _host_rgb(f.pixels, out=stack[i, :h])
    stack[:, h:] = 0
    return stack


def _as_tensor(pixels) -> torch.Tensor:
    """A host tensor of an image's pixels, sharing the array's memory when
    it is contiguous and writable (else from one copy)."""
    arr = np.asarray(pixels)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _validate_k(k) -> None:
    try:
        ok = int(k) == k and int(k) >= 1
    except (TypeError, ValueError):
        ok = False
    if not ok:
        raise ValueError("k must be an integer higher than 0.")


class ImageProcessor:
    """Entry point of the port. `device` is a CUDA device (the default,
    `None`, means `"cuda"` and raises without one) or `"cpu"` for the plain
    PyTorch path. The other arguments mirror `kmeans_tpu.ImageProcessor`.
    `delta_e` is `"94"` (CIE94) or `"2000"` (CIEDE2000), as in the
    reference. `train_max_size=None` trains on every pixel; past the
    reference's size gates that runs on the tile accumulator. `restarts` and
    `train_dtype="bfloat16"` (accumulator planes only) act as in the
    reference. `fast=True` opts into the fast tiers (module docstring):
    not bit-equal to exact at 16 < k <= 512, equal outside.
    `bucketing=True` is the serving mode (module docstring); with it,
    `train_dtype` raises, as in the reference. `pipeline=True` is the
    pipeline mode (module docstring), off by default as in the reference:
    host-shrunk training strips and the banded `reduce`. `last_iterations`
    holds the Lloyd iteration count of the latest training (of a batch: its
    longest member's)."""

    def __init__(
        self,
        device=None,
        train_max_size: int | None = MAX_IMAGE_DIMENSION,
        bucketing: bool = False,
        fast: bool = False,
        delta_e: str = "94",
        restarts: int = 1,
        pipeline: bool = False,
        train_dtype: str | None = None,
    ):
        aliases = {"94": "cie94", "cie94": "cie94", "2000": "cie2000", "cie2000": "cie2000"}
        if str(delta_e) not in aliases:
            raise ValueError(f"delta_e must be one of {sorted(aliases)}, got {delta_e!r}")
        if int(restarts) < 1:
            raise ValueError("restarts must be >= 1")
        if train_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"train_dtype must be 'bfloat16', 'float32' or None, got {train_dtype!r}"
            )
        if train_dtype is not None and bucketing:
            # kmeans_tpu/api.py:1020-1025.
            raise ValueError(
                "train_dtype is not supported with bucketing=True (the bucketed trainers "
                "do not route through the accumulator's plane store)"
            )
        self.device = _resolve_device(device)
        self.delta_e = aliases[str(delta_e)]
        self.train_max_size = None if train_max_size is None else int(train_max_size)
        self.bucketing = bool(bucketing)
        self.restarts = int(restarts)
        self.fast = bool(fast)
        self.pipeline = bool(pipeline)
        self.train_dtype = None if train_dtype == "float32" else train_dtype
        self.last_iterations: int | None = None

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _upload_padded(self, frames, rows: int, cols: int, count: int | None = None,
                       pinned: bool = False, device=None):
        """The frames padded on the device into `[count, rows, cols, 3]`
        uint8: each frame at the top left, zero past its edges
        (`pad_to_bucket`, kmeans_tpu/api.py:1166), and frames past the last
        copies of frame 0 (the reference's frame-count bucketing, `:1683`).
        Each frame uploads as it is, alpha included (no host copy when its
        array is contiguous), and loses alpha on the device: a host pad
        would be a strided copy of every pixel. `pinned` (CUDA only) copies
        each frame into page-locked memory and uploads it asynchronously
        on the current stream. `device` is where they go (default: the
        processor's device)."""
        count = len(frames) if count is None else count
        device = self.device if device is None else device
        with _phase("upload"):
            dev = torch.zeros((count, rows, cols, 3), dtype=torch.uint8, device=device)
            for i, f in enumerate(frames):
                px = _as_tensor(f.pixels)
                px = (px.pin_memory().to(device, non_blocking=True) if pinned
                      else px.to(device))
                dev[i, :px.shape[0], :px.shape[1]] = px[..., :3]
            dev[len(frames):] = dev[0]
            _phase_sync(dev)
        return dev

    def extract_palette_kmeans(
        self, image: Image, k: int, color_space: ColorSpace = ColorSpace.LAB
    ) -> torch.Tensor:
        """Train `k` centroids on the shrunk image; returns `[k, 3]` in the
        working space, on the processor's device (kmeans_tpu/api.py:1035).
        Under pipeline mode only the host-shrunk strip uploads
        (`_pipeline_strip`), and the training's shrink has nothing left to
        do."""
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        first = kmeans_model.reference_seed_index(sw, sh)
        with _phase("host_prep"):
            rgb = _host_rgb(self._pipeline_strip(image).pixels)
        with _phase("upload"):
            dev = self._upload(rgb)
            _phase_sync(dev)
        with _phase("device"):
            centroids, self.last_iterations = _train(
                dev, k, (sh, sw), first, color_space.convergence,
                lab=color_space is ColorSpace.LAB, restarts=self.restarts,
                train_dtype=self.train_dtype, metric=self.delta_e, fast=self.fast,
            )
            _phase_sync(centroids)
        return centroids

    def _pipeline_strip_dims(self, w: int, h: int) -> tuple[int, int]:
        """`(width, height)` of the training strip `_pipeline_strip` makes:
        the training size under pipeline mode, else the image's
        (kmeans_tpu/api.py:1121)."""
        if self.pipeline:
            return shrunk_dimensions(w, h, self.train_max_size)
        return w, h

    def _pipeline_strip(self, image: Image) -> Image:
        """Under pipeline mode, the image shrunk to its training size on the
        host (`resize_uint8_np`, kmeans_tpu/api.py:1129), alpha shrunk too
        and ignored like the image's; else, or when no shrink applies, the
        image itself: a same-size resample is not the identity (the
        corner-aligned sampler blends neighbours)."""
        w, h = image.dimensions
        sw, sh = self._pipeline_strip_dims(w, h)
        if (sw, sh) == (w, h):
            return image
        return Image((sw, sh), resize_uint8_np(image.pixels, sh, sw))

    # --- The host palette algorithms (kmeans_tpu/api.py:1085-1125) -----------

    def _cpu_palette_u8(self, image: Image, k: int, algo, dev=None) -> np.ndarray:
        """`[<= k, 4]` RGBA8 palette of a host algorithm, L*-sorted
        (kmeans_tpu/api.py:1085). `dev` is the image already on the device
        (`[H, W, 3]`, or its bucket under bucketing), if uploaded."""
        return _cpu_palette_from_rgb(self._cpu_shrunk_rgb(image, dev), k, algo)

    def _cpu_shrunk_rgb(self, image: Image, dev=None) -> np.ndarray:
        """The image shrunk to `OCTREE_MAX_SIZE`, as `[N, 3]` RGB rows
        (kmeans_tpu/api.py:1992)."""
        return self._shrunk_pixels(image, OCTREE_MAX_SIZE, dev).reshape(-1, 3)

    def _shrunk_pixels(self, image: Image, cap: int, dev=None) -> np.ndarray:
        """`[sh, sw, 3]` host RGB of the image shrunk to `cap`
        (kmeans_tpu/api.py:1093): the image as it is when it fits, else
        shrunk. Under pipeline mode the host shrinks it (`resize_uint8_np`,
        no transfer, `:1104-1111`); else the device does and the bytes come
        back: unbucketed, the reference's eager shrink
        (`resize_uint8_eager`); under bucketing the padded image shrinks
        into its canvas (`resize_to_canvas`, the reference's
        `_canvas_shrink_jit:770`) and the host crops."""
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, cap)
        if (sw, sh) == (w, h):
            with _phase("host_prep"):
                return _host_rgb(image.pixels)
        if self.pipeline:
            with _phase("shrink"):
                return resize_uint8_np(np.asarray(image.pixels)[..., :3], sh, sw)
        dev = self._upload_image(image) if dev is None else dev
        with _phase("shrink"):
            if self.bucketing:
                canvas = (min(cap, dev.shape[0]), min(cap, dev.shape[1]))
                shrunk, _ = resize_to_canvas(dev, *canvas, h, w, sh, sw)
            else:
                shrunk = resize_uint8_eager(dev, sh, sw)
            _phase_sync(shrunk)
        with _phase("readback"):
            return shrunk.cpu().numpy()[:sh, :sw]

    def _upload_image(self, image: Image, pinned: bool = False) -> torch.Tensor:
        """The image's RGB on the device, under bucketing padded to its
        bucket (`_upload_padded`). `pinned` (CUDA only) makes the host copy
        into page-locked memory and uploads it asynchronously on the
        current stream."""
        if self.bucketing:
            w, h = image.dimensions
            return self._upload_padded([image], *bucket_shape(h, w), pinned=pinned)[0]
        with _phase("host_prep"):
            if pinned:
                rgb = torch.empty(image.pixels.shape[:2] + (3,), dtype=torch.uint8,
                                  pin_memory=True)
                rgb.numpy()[...] = image.pixels[..., :3]
            else:
                rgb = torch.from_numpy(_host_rgb(image.pixels))
        with _phase("upload"):
            dev = rgb.to(self.device, non_blocking=pinned)
            _phase_sync(dev)
        return dev

    def _reduce_cpu_palette(self, image: Image, k: int, algo, mode: str) -> np.ndarray:
        """`reduce` with a host palette algorithm (kmeans_tpu/api.py:1525-1537):
        the image uploads once, its shrink feeds the algorithm, and the
        palette's output pass runs on the uploaded image; under bucketing on
        the padded bucket, the palette padded to `bucket_k` rows (masked by
        `k_active`), and the host crops."""
        w, h = image.dimensions
        dev = self._upload_image(image)
        palette_u8 = self._cpu_palette_u8(image, k, algo, dev)
        with _phase("upload"):
            palette_lab = self._upload(_colors_to_lab(palette_u8))
        k_active = None
        if self.bucketing:
            palette_lab, k_active = pad_palette_k(palette_lab)
        return self._quantize(dev, palette_lab, mode, k_active)[:h, :w]

    # --- Bucketed training (kmeans_tpu/api.py:606, 1148) ---------------------

    def _bucket_train_args(self, w: int, h: int, bw: int, bh: int, out=None):
        """`(canvas (rows, cols), (sw, sh), first)` of a bucketed training
        of a `w`x`h` image in a `bw`x`bh` bucket: the fixed canvas, the
        shrunk size `(sw, sh)` inside it (`out`, default
        `shrunk_dimensions` of the image), and the seed pixel's flat index
        within the canvas, `y * canvas_w + x`, for the seed
        `reference_seed_index(sw, sh)` (kmeans_tpu/api.py:1148; a streamed
        strip passes the whole image's `out`, `:2555-2559`)."""
        cap = self.train_max_size
        sw, sh = shrunk_dimensions(w, h, cap) if out is None else out
        canvas = (bh, bw) if cap is None else (min(cap, bh), min(cap, bw))
        y, x = divmod(kmeans_model.reference_seed_index(sw, sh), sw)
        return canvas, (sw, sh), y * canvas[1] + x

    def _canvas_lab(self, padded_u8, canvas, src_hs, src_ws, out_hs, out_ws, inline=True):
        """Canvas shrink of padded frames, then Lab: `([B, N, 3]` Lab, `[B,
        N]` weights, the `SeedLab` of an executable that converts and
        seeds, with `inline` where it fuses the conversion into the first
        map) (kmeans_tpu/api.py:630-633)."""
        canv, weight = resize_to_canvas(padded_u8, *canvas, src_hs, src_ws, out_hs, out_ws)
        b = padded_u8.shape[0]
        rgb = canv.reshape(b, -1, 3)
        return srgb8_to_lab(rgb), weight.reshape(b, -1), kmeans_model.seed_lab(rgb, inline=inline)

    def _train_bucketed(self, padded_u8, kp, w, h, k_active, out=None):
        """`_train_bucketed_jit` (kmeans_tpu/api.py:606) of one `[bh, bw, 3]`
        padded image whose real corner is `w`x`h`: the canvas shrink to
        `out` = `(sw, sh)` (`_bucket_train_args`), Lab, then `_fit_auto` at
        `kp` clusters with `k_active` real ones, weighted by the canvas.
        Returns the `[kp, 3]` centroids."""
        bh, bw = padded_u8.shape[0], padded_u8.shape[1]
        canvas, (sw, sh), first = self._bucket_train_args(w, h, bw, bh, out)
        work, weight, seed = self._canvas_lab(padded_u8[None], canvas, [h], [w], [sh], [sw])
        centroids, self.last_iterations = _fit_auto(
            work[0], kp, first, ColorSpace.LAB.convergence, self.restarts, None,
            self.delta_e, self.fast, weight[0], k_active, SeedLab(*(t[0] for t in seed)),
        )
        return centroids

    def _train_bucketed_frames(self, stack, kp, dims, k_active):
        """The vmapped bucketed trainers (kmeans_tpu/api.py:3201, 3346, 3134)
        as one batched Lloyd loop: frame b of the padded `[B, bh, bw, 3]`
        stack holds a `dims[b] = (w, h)` image and trains on its own
        weighted canvas at `kp` clusters, `k_active` real ones, on the plain
        `fit_restarts` protocol. Returns `[B, kp, 3]` centroids."""
        bh, bw = stack.shape[1], stack.shape[2]
        args = [self._bucket_train_args(w, h, bw, bh) for w, h in dims]
        # The reference's vmapped executables seed on their stored Lab.
        work, weight, seed = self._canvas_lab(
            stack, args[0][0], [h for _, h in dims], [w for w, _ in dims],
            [a[1][1] for a in args], [a[1][0] for a in args], inline=False)
        cents, iters = kmeans_model.fit_restarts_batched(
            work, kp, [a[2] for a in args], restarts=self.restarts,
            convergence=ColorSpace.LAB.convergence, k_actives=[k_active] * len(dims),
            metric=self.delta_e, weights=weight, seed=seed,
        )
        self.last_iterations = max(iters)
        return cents

    def _train_bucketed_heavy(self, stack, kp, dims, k_active):
        """The heavy coalesced trainers (kmeans_tpu/api.py:3443, 3536): the
        frames of the stack train one after another, each on `_fit_auto`'s
        own route, as solo requests do. The stack's padding frames are
        copies of frame 0, whose palette they take without training again
        (the same input through the same deterministic trainer). Returns
        `[B, kp, 3]` centroids."""
        cents, iters = [], []
        for b, (w, h) in enumerate(dims):
            cents.append(self._train_bucketed(stack[b], kp, w, h, k_active))
            iters.append(self.last_iterations)
        self.last_iterations = max(iters)
        return torch.stack(cents + [cents[0]] * (stack.shape[0] - len(dims)))

    # --- Entry points -------------------------------------------------------

    def palette(
        self, color_count: int, image, algo: Algorithm = Algorithm.KMEANS
    ) -> np.ndarray:
        """The `k` dominant colours as `[k, 4]` RGBA8, sorted by L*; a host
        algorithm may give fewer (its boxes or leaves deduplicated)."""
        image = _as_image(image)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            return self._cpu_palette_u8(image, color_count, algo)
        if self.bucketing:
            # kmeans_tpu/api.py:1374-1391. Under pipeline mode the strip is
            # the image: it pads to its own bucket, and the canvas shrink to
            # its own size is the identity.
            with _phase("host_prep"):
                image = self._pipeline_strip(image)
            w, h = image.dimensions
            dev = self._upload_padded([image], *bucket_shape(h, w))[0]
            with _phase("device"):
                centroids = self._train_bucketed(dev, bucket_k(color_count), w, h, color_count)
                _phase_sync(centroids)
            return _palette_readback(centroids, color_count)
        return _palette_readback(self.extract_palette_kmeans(image, color_count), color_count)

    def find(
        self, image, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> Image:
        """Recolour with a fixed palette, no training. Under bucketing the
        image pads to its bucket and the palette to `bucket_k` rows (copies
        of row 0, masked by `k_active`), and the host crops: the same bits
        as unbucketed (kmeans_tpu/api.py:1408-1415, 1601-1605)."""
        image = _as_image(image)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        mode = ReduceMode(reduce_mode).value
        if self.bucketing:
            return self._find_stack([image], palette_rgba, mode, True)[0]
        with _phase("host_prep"):
            palette_lab = _colors_to_lab(palette_rgba)
            rgb = _host_rgb(image.pixels)
        with _phase("upload"):
            dev = self._upload(rgb)
            palette_dev = self._upload(palette_lab)
            _phase_sync(dev)
        return Image(image.dimensions, self._quantize(dev, palette_dev, mode))

    def reduce(
        self,
        color_count: int,
        image,
        algo: Algorithm = Algorithm.KMEANS,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
    ) -> Image:
        """Quantize the image to `color_count` trained colours (k-means) or
        to a host algorithm's palette. Under pipeline mode an image of at
        least `PIPELINE_BAND_ROWS * PIPELINE_MIN_BANDS` rows goes by bands
        (`_reduce_banded`) in replace and dither up to `INDEXED_MAX_K`
        colours, unbucketed and with a training cap: the reference's gate
        (kmeans_tpu/api.py:1437-1447), whose fused-path condition always
        holds here."""
        image = _as_image(image)
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        if algo is not Algorithm.KMEANS:
            return Image(image.dimensions, self._reduce_cpu_palette(image, color_count, algo,
                                                                    mode))
        w, h = image.dimensions
        if (self.pipeline and not self.bucketing and mode != "meld"
                and color_count <= INDEXED_MAX_K and self.train_max_size is not None
                and h >= PIPELINE_BAND_ROWS * PIPELINE_MIN_BANDS):
            return Image(image.dimensions, self._reduce_banded(image, color_count, mode))
        dev = self._upload_image(image)
        with _phase("device"):
            out = self._reduce_device(dev, image, color_count, mode)
            _phase_sync(out[1])
        # Under bucketing (kmeans_tpu/api.py:1158) the output pass ran on
        # the padded image at `bucket_k(k)` rows (packed indices up to
        # `INDEXED_MAX_K` colours, `:651`; RGB24 words for meld, `:692`;
        # RGBA past it, `:727`) and the host crops: the crop is a view of
        # the unpacked bucket, no second copy.
        kp = bucket_k(color_count) if self.bucketing else color_count
        return Image(image.dimensions,
                     self._readback(out, dev.shape[0], dev.shape[1], kp)[:h, :w])

    def _reduce_device(self, dev: torch.Tensor, image: Image, k: int, mode: str):
        """The training and the output pass of `reduce` on the image's
        uploaded pixels `dev` (`[H, W, 3]`, or its bucket under bucketing),
        as `_output_pass` returns them: unbucketed, the shrink to the
        training size and `_fit_auto` at `k` clusters; bucketed, the
        weighted canvas at `bucket_k(k)` clusters with `k_active = k`."""
        w, h = image.dimensions
        if self.bucketing:
            centroids = self._train_bucketed(dev, bucket_k(k), w, h, k)
            return self._output_pass(dev, centroids, mode, k)
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        centroids, self.last_iterations = _train(
            dev, k, (sh, sw), kmeans_model.reference_seed_index(sw, sh),
            ColorSpace.LAB.convergence, restarts=self.restarts, train_dtype=self.train_dtype,
            metric=self.delta_e, fast=self.fast,
        )
        return self._output_pass(dev, centroids, mode)

    def _reduce_banded(self, image: Image, k: int, mode: str) -> np.ndarray:
        """Pipeline mode's `reduce` (kmeans_tpu/api.py:1540-1592) -> `[h,
        w, 4]` RGBA8. It trains on the host-shrunk strip
        (`extract_palette_kmeans`: the strip is the only upload before
        training), then sends the image through the output pass in bands of
        `PIPELINE_BAND_ROWS` rows, the last one short, each with
        `row_offset` its first row (the Bayer pattern runs on across band
        edges; the dither threshold and the unpack palette are computed
        once), and each band's words unpack into its rows of the output. So
        the pixels are the monolithic pass's on the same centroids.

        On the card the bands overlap, as `reduce_pipelined`'s images do:
        an upload thread strips each band's alpha into page-locked memory
        (`_host_rgb`) and uploads it on a side stream behind an event, up
        to `_PIPELINE_WINDOW` bands ahead, from before the training starts;
        this thread waits for a band's event on its own stream, launches
        its pass and an asynchronous readback into page-locked memory
        behind another event; a host thread waits for that event and
        unpacks. On the CPU the same steps run in order."""
        w, h = image.dimensions
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        starts = range(0, h, PIPELINE_BAND_ROWS)
        out = np.empty((h, w, 4), np.uint8)

        def upload(r0):
            """Band `r0` on the device: `(pixels, ready event, host buffer)`."""
            rows = image.pixels[r0:r0 + PIPELINE_BAND_ROWS]
            if not cuda:
                with _phase("host_prep"):
                    return self._upload(_host_rgb(rows)), None, None
            with _phase("host_prep"):
                host = torch.empty(rows.shape[:2] + (3,), dtype=torch.uint8, pin_memory=True)
                _host_rgb(rows, out=host.numpy())
            with _phase("upload"), torch.cuda.stream(side):
                dev = host.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
                _phase_sync(dev)
            return dev, ready, host

        def unpack(r0, words, palette, done, *buffers):
            """Band `r0`'s words into its rows of `out`, once `done` (its
            readback's event) has passed; `buffers` (its page-locked input)
            live until then."""
            if done is not None:
                done.synchronize()
            with _phase("unpack"):
                bh = min(PIPELINE_BAND_ROWS, h - r0)
                _unpack("indexed", words.numpy(), bh, w, k, palette.numpy(), out[r0:r0 + bh])

        with contextlib.ExitStack() as pools:
            uploader, host = ((pools.enter_context(ThreadPoolExecutor(1)),
                               pools.enter_context(ThreadPoolExecutor(1))) if cuda
                              else (None, None))
            uploads = [_submit(uploader, upload, r0) for r0 in starts[:_PIPELINE_WINDOW]]
            centroids = self.extract_palette_kmeans(image, k)
            stream = torch.cuda.current_stream(self.device) if cuda else None
            with _phase("device"):
                operands = self._pass_operands(centroids, mode)
                palette = operands[1].to("cpu", non_blocking=cuda)
                _phase_sync(centroids)
            unpacks = []
            for i, r0 in enumerate(starts):
                dev, ready, buffer = uploads[i].result()
                uploads[i] = None  # the future no longer holds the band
                if i + _PIPELINE_WINDOW < len(starts):
                    uploads.append(_submit(uploader, upload, starts[i + _PIPELINE_WINDOW]))
                done = None
                if cuda:
                    stream.wait_event(ready)
                    dev.record_stream(stream)
                with _phase("device"):
                    _, words, _ = self._output_pass(dev, centroids, mode, None, r0, operands)
                    _phase_sync(words)
                with _phase("readback"):
                    words = words.to("cpu", non_blocking=cuda)
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(stream)
                unpacks.append(_submit(host, unpack, r0, words, palette, done, buffer))
            for u in unpacks:
                u.result()
        return out

    def find_batch(
        self, images, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> list[Image]:
        """`find` over same-sized frames (GIF frames) with one output pass
        (kmeans_tpu/api.py:1653): the frames stack into one tall image and
        go through one launch. For replace and dither each frame's rows pad
        to a multiple of 4, so every frame starts at Bayer row phase 0 and
        the tall image's dither equals each frame's own
        (`_find_batch_fused_jit:3652`); meld stacks them as they are
        (`_find_batch_meld_jit:3686`). Under bucketing each frame pads to
        its bucket, the frame count to `bucket_frames` (copies of frame 0,
        dropped) and the palette to `bucket_k` rows (`:1675-1687`)."""
        frames = _as_frames(images)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        return self._find_stack(frames, palette_rgba, ReduceMode(reduce_mode).value,
                                self.bucketing)

    def _find_stack(self, frames, palette_rgba, mode: str, bucketed: bool) -> list[Image]:
        """One tall output pass over frames of one size (`find_batch`) or of
        one bucket (`find_many`, `bucketed` true: each frame pads to the
        bucket, the count to `bucket_frames`, the palette to `bucket_k`)."""
        h, w = frames[0].pixels.shape[:2]
        if bucketed:
            (bh, bw), count = bucket_shape(h, w), bucket_frames(len(frames))
        else:
            (bh, bw), count = (h, w), len(frames)
        rows = bh if mode == "meld" else -(-bh // 4) * 4
        with _phase("host_prep"):
            palette_lab = _colors_to_lab(palette_rgba)
        if bucketed:
            dev = self._upload_padded(frames, rows, bw, count)
        else:
            with _phase("host_prep"):
                stack = _stack_rgb(frames, rows)
            with _phase("upload"):
                dev = self._upload(stack)
        with _phase("upload"):
            palette_dev = self._upload(palette_lab)
            _phase_sync(dev)
        k_active = None
        if bucketed:
            palette_dev, k_active = pad_palette_k(palette_dev)
        tall = self._quantize(dev.reshape(count * rows, bw, 3), palette_dev, mode, k_active)
        outs = tall.reshape(count, rows, bw, 4)
        return [Image(f.dimensions, outs[i, :f.pixels.shape[0], :f.pixels.shape[1]])
                for i, f in enumerate(frames)]

    def reduce_images(
        self,
        images,
        color_count: int,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
    ) -> list[Image]:
        """Quantize same-sized frames at one k, each with its own trained
        palette (kmeans_tpu/api.py:1825, `_reduce_images_fused_jit:3270`):
        every frame shrinks, all train in one batched Lloyd loop
        (`models/kmeans.py::fit_restarts_batched`), and one frames launch
        writes every frame's output: packed indices up to `INDEXED_MAX_K`
        colours, RGBA words above, RGB24 words for meld. `fast` reaches
        only that output pass, as in the reference. Under bucketing the
        frames pad to their bucket and their count to `bucket_frames`
        (copies of frame 0, dropped), and each trains on its weighted
        canvas at `bucket_k(k)` clusters (`:1844-1870`,
        `_reduce_images_bucketed_fused_jit:3303`)."""
        frames = _as_frames(images)
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        w, h = frames[0].dimensions
        if self.bucketing:
            return self._reduce_stack(frames, color_count, mode)
        with _phase("host_prep"):
            stack = _stack_rgb(frames, h)
        with _phase("upload"):
            dev = self._upload(stack)
            _phase_sync(dev)
        with _phase("device"):
            cents = self._train_batched(dev, color_count, w, h)
            out = self._frames_pass(dev, cents, mode, None, self.fast)
            _phase_sync(out[1])
        outs = self._readback_frames(out, h, w, color_count)
        return [Image(frames[0].dimensions, o) for o in outs]

    def _heavy_bucket(self, frame: Image, k: int) -> bool:
        """Whether a bucket of `frame`'s trains off the plain trainer: its
        canvas is past `_plain_fit_route`'s gates (kmeans_tpu/api.py:2925-2940)."""
        h, w = frame.pixels.shape[:2]
        bh, bw = bucket_shape(h, w)
        (ch, cw), _, _ = self._bucket_train_args(w, h, bw, bh)
        return not _plain_fit_route(ch * cw, bucket_k(k))

    def _train_stack(self, frames, k: int, heavy: bool = False):
        """Bucketed training of frames of one bucket (sizes may differ): pad
        to the bucket and the count to `bucket_frames` on the device, then
        train each frame on its weighted canvas at `bucket_k(k)` clusters
        (one batched loop, or one after another when `heavy`). Returns the
        padded `[count, bh, bw, 3]` stack and its `[count, kp, 3]`
        centroids."""
        h, w = frames[0].pixels.shape[:2]
        bh, bw = bucket_shape(h, w)
        kp, count = bucket_k(k), bucket_frames(len(frames))
        dev = self._upload_padded(frames, bh, bw, count)
        dims = [f.dimensions for f in frames]
        with _phase("device"):
            if heavy:
                cents = self._train_bucketed_heavy(dev, kp, dims, k)
            else:
                cents = self._train_bucketed_frames(dev, kp, dims + [dims[0]] * (count - len(dims)),
                                                    k)
        return dev, cents

    def _reduce_stack(self, frames, k: int, mode: str, heavy: bool = False) -> list[Image]:
        """`_train_stack`, then one frames launch over the padded stack; each
        output crops to its frame."""
        dev, cents = self._train_stack(frames, k, heavy)
        bh, bw = dev.shape[1], dev.shape[2]
        with _phase("device"):
            out = self._frames_pass(dev, cents, mode, [k] * dev.shape[0], self.fast)
            _phase_sync(out[1])
        outs = self._readback_frames(out, bh, bw, bucket_k(k), len(frames))
        return [Image(f.dimensions, o[:f.pixels.shape[0], :f.pixels.shape[1]])
                for f, o in zip(frames, outs)]

    def palette_images(
        self, images, color_count: int, algo: Algorithm = Algorithm.KMEANS
    ) -> np.ndarray:
        """One palette trained jointly over same-sized frames (a global GIF
        palette; kmeans_tpu/api.py:1924, `_train_frames_jit:3618`): every
        frame shrinks, the Lab pixels concatenate in frame order (the seed
        index addresses frame 0) and train once. `[k, 4]` RGBA8, L*-sorted.
        Under bucketing each frame's canvas is weighted, and the frames that
        pad the count to `bucket_frames` weigh 0 (`frame_valid`,
        `:1947-1977`, `_train_frames_bucketed_jit:3581`). A host algorithm
        runs once over every frame's shrunk pixels (`:1942-1946`). Under
        pipeline mode the frames' host-shrunk strips stand for the frames
        (`:1950-1960, 1981-1983`): they upload, and under bucketing pad to
        their own bucket."""
        frames = _as_frames(images)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            rgb = np.concatenate([self._cpu_shrunk_rgb(f) for f in frames], axis=0)
            return _cpu_palette_from_rgb(rgb, color_count, algo)
        with _phase("host_prep"):
            frames = [self._pipeline_strip(f) for f in frames]
        w, h = frames[0].dimensions
        if self.bucketing:
            bh, bw = bucket_shape(h, w)
            count = bucket_frames(len(frames))
            canvas, (sw, sh), first = self._bucket_train_args(w, h, bw, bh)
            dev = self._upload_padded(frames, bh, bw, count)
            with _phase("device"):
                work, weight, seed = self._canvas_lab(dev, canvas, [h] * count, [w] * count,
                                                      [sh] * count, [sw] * count)
                weight[len(frames):] = 0.0
                centroids, self.last_iterations = kmeans_model.fit_restarts(
                    work.reshape(-1, 3), bucket_k(color_count), first,
                    restarts=self.restarts, convergence=ColorSpace.LAB.convergence,
                    k_active=color_count, metric=self.delta_e, weight=weight.reshape(-1),
                    seed=SeedLab(*(t.reshape(-1, 3) for t in seed)),
                )
                _phase_sync(centroids)
            return _palette_readback(centroids, color_count)
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        with _phase("host_prep"):
            stack = _stack_rgb(frames, h)
        with _phase("upload"):
            dev = self._upload(stack)
            _phase_sync(dev)
        with _phase("device"):
            shrunk = dev if (h, w) == (sh, sw) else resize_uint8(dev, sh, sw)
            rgb = shrunk.reshape(-1, 3)
            centroids, self.last_iterations = kmeans_model.fit_restarts(
                srgb8_to_lab(rgb), color_count,
                kmeans_model.reference_seed_index(sw, sh), restarts=self.restarts,
                convergence=ColorSpace.LAB.convergence, metric=self.delta_e,
                seed=kmeans_model.seed_lab(rgb),
            )
            _phase_sync(centroids)
        return _palette_readback(centroids, color_count)

    def reduce_batch(
        self, image, color_counts, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> list[Image]:
        """Quantize one image at several k (kmeans_tpu/api.py:2823,
        `_reduce_batch_jit:3752`): every k trains in one batched Lloyd loop
        on a palette padded to the largest k, the rows past each k masked
        (its `k_active`); then one frames launch with the image as every
        frame (stride 0) writes each k's output. As in the reference, the
        output pass is exact whatever `fast` says. Under bucketing the
        image pads to its bucket and trains on its weighted canvas, the
        largest k pads up the ladder (`next_bucket`) and the list of k to
        `bucket_frames` entries (copies of the first, dropped)
        (`:2841-2864`, `_reduce_batch_bucketed_jit:3711`)."""
        image = _as_image(image)
        ks = [int(k) for k in color_counts]
        if not ks:
            raise ValueError("need at least one color count")
        for k in ks:
            _validate_k(k)
        kmax = max(ks)
        mode = ReduceMode(reduce_mode).value
        w, h = image.dimensions
        if self.bucketing:
            kmax = next_bucket(kmax)
            ks_padded = ks + [ks[0]] * (bucket_frames(len(ks)) - len(ks))
            bh, bw = bucket_shape(h, w)
            canvas, (sw, sh), first = self._bucket_train_args(w, h, bw, bh)
            dev = self._upload_padded([image], bh, bw)[0]
            with _phase("device"):
                work, weight, seed = self._canvas_lab(dev[None], canvas, [h], [w], [sh], [sw])
                cents, iters = kmeans_model.fit_restarts_batched(
                    work[0], kmax, first, restarts=self.restarts,
                    convergence=ColorSpace.LAB.convergence, k_actives=ks_padded,
                    metric=self.delta_e, weights=weight[0], seed=SeedLab(*(t[0] for t in seed)),
                )
                self.last_iterations = max(iters)
                frames = dev[None].expand(len(ks_padded), bh, bw, 3)
                out = self._frames_pass(frames, cents, mode, ks_padded, fast=False)
                _phase_sync(out[1])
            return [Image(image.dimensions, o[:h, :w])
                    for o in self._readback_frames(out, bh, bw, kmax, len(ks))]
        with _phase("host_prep"):
            rgb = _host_rgb(image.pixels)
        with _phase("upload"):
            dev = self._upload(rgb)
            _phase_sync(dev)
        with _phase("device"):
            cents = self._train_batched(dev, kmax, w, h, ks)
            frames = dev[None].expand(len(ks), h, w, 3)
            out = self._frames_pass(frames, cents, mode, ks, fast=False)
            _phase_sync(out[1])
        return [Image(image.dimensions, o)
                for o in self._readback_frames(out, h, w, kmax)]

    # --- The coalescers (kmeans_tpu/api.py:1740, 2882, 3026) -----------------

    @staticmethod
    def _bucket_groups(frames, dims_of) -> dict:
        """Frame indices by `bucket_shape` of `dims_of(frame)` = (h, w), in
        first-seen order."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i, f in enumerate(frames):
            groups.setdefault(bucket_shape(*dims_of(f)), []).append(i)
        return groups

    def find_many(
        self, images, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> list[Image]:
        """Recolour images that may differ in size with one palette
        (kmeans_tpu/api.py:1740): under bucketing the images of one bucket
        (two or more) go through one tall output pass, as `find_batch`'s
        bucketed branch, with the bits of solo `find`. Without bucketing,
        past `INDEXED_MAX_K` colours, or for an image alone in its bucket,
        each image runs `find`."""
        frames = [_as_image(im) for im in images]
        if not frames:
            raise ValueError("need at least one image")
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        if not self.bucketing or palette_rgba.shape[0] > INDEXED_MAX_K:
            return [self.find(f, palette_rgba, reduce_mode) for f in frames]
        mode = ReduceMode(reduce_mode).value
        results: list[Image | None] = [None] * len(frames)
        for idxs in self._bucket_groups(frames, lambda f: f.pixels.shape[:2]).values():
            if len(idxs) == 1:
                results[idxs[0]] = self.find(frames[idxs[0]], palette_rgba, reduce_mode)
                continue
            outs = self._find_stack([frames[i] for i in idxs], palette_rgba, mode, True)
            for i, out in zip(idxs, outs):
                results[i] = out
        return results

    def reduce_many(
        self,
        images,
        color_count: int,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
    ) -> list[Image]:
        """Quantize images that may differ in size, each with its own trained
        palette, coalescing each bucket's images (kmeans_tpu/api.py:2882):
        the images of one bucket (two or more) upload as one padded stack,
        train in one batched Lloyd loop on their weighted canvases
        (per-image sizes and seed indices) and go through one frames
        launch. A bucket whose canvas `_fit_auto` sends off the plain
        trainer (`_plain_fit_route` false: the accumulator or the row-chunked
        trainer) trains its images one after another on that route, then
        takes the same one launch (`_reduce_many_bucketed_heavy_jit:3443`).
        An image alone in its bucket runs `reduce`; so does every image
        without bucketing or under `fast` (`:2906`: a fast processor keeps
        per-image results)."""
        frames = [_as_image(im) for im in images]
        if not frames:
            raise ValueError("need at least one image")
        _validate_k(color_count)
        if not self.bucketing or self.fast:
            return [self.reduce(color_count, f, Algorithm.KMEANS, reduce_mode) for f in frames]
        mode = ReduceMode(reduce_mode).value
        results: list[Image | None] = [None] * len(frames)
        iters = []
        for idxs in self._bucket_groups(frames, lambda f: f.pixels.shape[:2]).values():
            if len(idxs) == 1:
                results[idxs[0]] = self.reduce(color_count, frames[idxs[0]], Algorithm.KMEANS,
                                               reduce_mode)
            else:
                group = [frames[i] for i in idxs]
                outs = self._reduce_stack(group, color_count, mode,
                                          self._heavy_bucket(group[0], color_count))
                for i, out in zip(idxs, outs):
                    results[i] = out
            iters.append(self.last_iterations)
        self.last_iterations = max(iters)
        return results

    def palette_many(
        self, images, color_count: int, algo: Algorithm = Algorithm.KMEANS
    ) -> list[np.ndarray]:
        """Per-image palettes of images that may differ in size, each `[k,
        4]` RGBA8 L*-sorted as solo `palette` gives it, coalescing each
        bucket's images into one batched training (or, for a heavy bucket,
        one after another) (kmeans_tpu/api.py:3026). Without bucketing,
        under `fast`, with a host algorithm (one run per image, `:3052`),
        or for an image alone in its bucket, each image runs `palette`.
        Under pipeline mode each image's host-shrunk strip stands for it,
        so images group by their strips' buckets (`:3055-3092`), the
        buckets solo `palette` trains in."""
        frames = [_as_image(im) for im in images]
        if not frames:
            raise ValueError("need at least one image")
        _validate_k(color_count)
        if not self.bucketing or self.fast or algo is not Algorithm.KMEANS:
            return [self.palette(color_count, f, algo) for f in frames]
        with _phase("host_prep"):
            frames = [self._pipeline_strip(f) for f in frames]
        results: list[np.ndarray | None] = [None] * len(frames)
        iters = []
        for idxs in self._bucket_groups(frames, lambda f: f.pixels.shape[:2]).values():
            if len(idxs) == 1:
                results[idxs[0]] = self.palette(color_count, frames[idxs[0]], algo)
                iters.append(self.last_iterations)
                continue
            group = [frames[i] for i in idxs]
            _, cents = self._train_stack(group, color_count,
                                         self._heavy_bucket(group[0], color_count))
            with _phase("device"):
                _phase_sync(cents)
            iters.append(self.last_iterations)
            with _phase("readback"):
                rgba, lightness = _host_fetch(*_lab_palette_to_u8(cents))
            with _phase("host_sort"):
                for j, i in enumerate(idxs):
                    order = np.argsort(lightness[j, :color_count], kind="stable")
                    results[i] = rgba[j, :color_count][order]
        self.last_iterations = max(iters)
        return results

    def warmup(
        self,
        sizes,
        color_counts,
        modes=(ReduceMode.REPLACE,),
        palette: bool = True,
        find_palette_sizes=(),
        gif_frame_counts=(),
        batch_sizes=(),
    ) -> int:
        """Prepare a serving processor before its first request
        (kmeans_tpu/api.py:1197), with the reference's arguments and
        return value: the number of dummy requests issued, one per key the
        reference compiles an executable for. `sizes` are `(width,
        height)` pairs, each standing for its bucket. For every bucket it
        issues `reduce` per (k bucket, mode), `palette` per k bucket unless
        `palette=False`, and `find` per (palette-size bucket, mode) for the
        sizes in `find_palette_sizes`; with `gif_frame_counts`, per
        frame-count bucket, `palette_images`, `reduce_images` and
        `reduce_many` per (k bucket, mode) and `find_batch`; with
        `batch_sizes`, `reduce_many`, `palette_many` (unless
        `palette=False`) and, with `find_palette_sizes`, `find_many`.

        The port compiles nothing per shape. On the card the first call
        builds the CUDA library (`ops/_build.py`, nvcc, or the cached
        build), and the dummy requests launch every kernel instance those
        keys reach, so a real request pays neither. Under pipeline mode a
        palette trains on the strip's bucket, which follows the image's
        aspect ratio: the palette dummies are images of the real size, keyed
        by their strips' buckets (`:1245-1257`). Requires `bucketing=True`;
        raises `ValueError` otherwise, as the reference does."""
        if not self.bucketing:
            raise ValueError("warmup requires ImageProcessor(bucketing=True)")
        if self.device.type == "cuda":
            from kmeans_tpu_torch.ops._build import load_library

            load_library()
        rng = np.random.default_rng(0)
        seen = set()

        def dummy_image(bh, bw):
            dummy = rng.integers(0, 256, (bh, bw, 4), dtype=np.uint8)
            dummy[..., 3] = 255
            return Image((bw, bh), dummy)

        def dummy_colors(n):
            colors = rng.integers(0, 256, (n, 4), dtype=np.uint8)
            colors[:, 3] = 255
            return colors

        def once(key, fn):
            if key not in seen:
                seen.add(key)
                fn()

        def palette_key(w, h, bh, bw):
            """A palette warm's key prefix: its bucket, or under pipeline
            mode its strip's."""
            if not self.pipeline:
                return bh, bw
            sw, sh = self._pipeline_strip_dims(w, h)
            return (*bucket_shape(sh, sw), "strip")

        def palette_frames(w, h, frames):
            """A palette warm's dummies: under pipeline mode of the real size."""
            return [dummy_image(h, w) for _ in frames] if self.pipeline else frames

        modes = [ReduceMode(m) for m in modes]
        for w, h in ((int(w), int(h)) for w, h in sizes):
            bh, bw = bucket_shape(h, w)
            img = dummy_image(bh, bw)
            for k in map(int, color_counts):
                for mode in modes:
                    once((bh, bw, bucket_k(k), mode.value),
                         lambda: self.reduce(k, img, reduce_mode=mode))
                if palette:
                    once(palette_key(w, h, bh, bw) + (bucket_k(k), "palette"),
                         lambda: self.palette(k, palette_frames(w, h, [img])[0]))
            for kf in map(int, find_palette_sizes):
                colors = dummy_colors(kf)
                for mode in modes:
                    once((bh, bw, bucket_k(kf), mode.value, "find"),
                         lambda: self.find(img, colors, mode))
            for fc in gif_frame_counts:
                fb = bucket_frames(int(fc))
                frames = [dummy_image(bh, bw) for _ in range(fb)]
                for k in map(int, color_counts):
                    once(palette_key(w, h, bh, bw) + (fb, bucket_k(k), "pimg"),
                         lambda: self.palette_images(palette_frames(w, h, frames), k))
                    for mode in modes:
                        once((bh, bw, fb, bucket_k(k), mode.value, "rimg"),
                             lambda: self.reduce_images(frames, k, mode))
                        once((bh, bw, fb, bucket_k(k), mode.value, "rmany"),
                             lambda: self.reduce_many(frames, k, mode))
                for kf in map(int, find_palette_sizes):
                    colors = dummy_colors(kf)
                    for mode in modes:
                        once((bh, bw, fb, bucket_k(kf), mode.value, "fbatch"),
                             lambda: self.find_batch(frames, colors, mode))
            for bs in batch_sizes:
                fb = bucket_frames(int(bs))
                frames = [dummy_image(bh, bw) for _ in range(fb)]
                for k in map(int, color_counts):
                    for mode in modes:
                        once((bh, bw, fb, bucket_k(k), mode.value, "rmany"),
                             lambda: self.reduce_many(frames, k, mode))
                    if palette:
                        once(palette_key(w, h, bh, bw) + (fb, bucket_k(k), "pmany"),
                             lambda: self.palette_many(palette_frames(w, h, frames), k))
                for kf in map(int, find_palette_sizes):
                    colors = dummy_colors(kf)
                    for mode in modes:
                        # find_batch's bucketed tall stack: one key.
                        once((bh, bw, fb, bucket_k(kf), mode.value, "fbatch"),
                             lambda: self.find_many(frames, colors, mode))
        return len(seen)

    # --- Streaming in row bands (kmeans_tpu/api.py:2468-2823) ---------------

    def reduce_streamed(
        self,
        color_count: int,
        image,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
        band_rows: int = 4096,
    ) -> Image:
        """`reduce` of an image streamed through the device in bands of
        `band_rows` rows (at least 4), so device memory holds one band, not
        the image (kmeans_tpu/api.py:2468): pass 1 trains on a strip the
        bands shrink into (`_train_streamed`), pass 2 recolours band by band
        (`_quantize_bands`), the dither pattern continuous across band
        edges. As in the reference, the two-stage shrink rounds to uint8
        between its stages, so past the training cap the palette may differ
        from `reduce`'s by a u8 step; an image within the cap trains on its
        own pixels, and the output equals a bucketed processor's `reduce`."""
        image = _as_image(image)
        _validate_k(color_count)
        band_rows = max(int(band_rows), 4)
        centroids = self._train_streamed(image, color_count, band_rows)
        return Image(image.dimensions, self._quantize_bands(
            image, centroids, color_count, ReduceMode(reduce_mode).value, band_rows))

    def palette_streamed(self, color_count: int, image, band_rows: int = 4096) -> np.ndarray:
        """`palette` trained as `reduce_streamed` trains: `[k, 4]` RGBA8
        sorted by L* (kmeans_tpu/api.py:2566)."""
        image = _as_image(image)
        _validate_k(color_count)
        centroids = self._train_streamed(image, color_count, max(int(band_rows), 4))
        return _palette_readback(centroids, color_count)

    def find_streamed(
        self,
        image,
        colors,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
        band_rows: int = 4096,
    ) -> Image:
        """`find` streamed band by band (kmeans_tpu/api.py:2648), no
        training. The palette always pads to `bucket_k` rows (masked by
        `k_active`), so the output equals a bucketed processor's `find` bit
        for bit: every pass is per pixel."""
        image = _as_image(image)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        with _phase("upload"):
            palette_lab, k_active = pad_palette_k(self._upload(_colors_to_lab(palette_rgba)))
        return Image(image.dimensions, self._quantize_bands(
            image, palette_lab, k_active, ReduceMode(reduce_mode).value, max(int(band_rows), 4)))

    def _upload_band(self, image: Image, r0: int, band_rows: int) -> torch.Tensor:
        """Rows `[r0, r0 + band_rows)` of the image on the device as RGB,
        padded to their bucket (`pad_to_bucket`, kmeans_tpu/api.py:2546,
        2600) by `_upload_padded`: the band's RGBA rows upload as they are
        and lose alpha on the device."""
        band = image.pixels[r0:r0 + band_rows]
        bh, w = band.shape[0], band.shape[1]
        return self._upload_padded([Image((w, bh), band)], *bucket_shape(bh, w))[0]

    def _train_streamed(self, image: Image, k: int, band_rows: int) -> torch.Tensor:
        """Pass 1 of the streamed paths (kmeans_tpu/api.py:2508). Each band
        shrinks along its columns to the training width (`shrink_columns`)
        into an `[h, sw]` strip held on the device, padded to its bucket;
        the strip then trains as a bucketed image (`_train_bucketed`),
        whose canvas shrink does the rows: its real corner is the strip,
        its output size `(sw, sh)` and its seed those of the whole image. An
        image within the cap is its own strip. Returns `[bucket_k(k), 3]`
        Lab centroids with `k` active rows."""
        cap = self.train_max_size
        if cap is None:
            raise ValueError(
                "streamed training requires a finite train_max_size (the "
                "training strip is assembled at that width)"
            )
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, cap)
        if (sw, sh) == (w, h):
            strip = self._upload_padded([image], *bucket_shape(h, w))[0]
        else:
            strip = torch.zeros(bucket_shape(h, sw) + (3,), dtype=torch.uint8,
                                device=self.device)
            for r0 in range(0, h, band_rows):
                band = self._upload_band(image, r0, band_rows)
                bh = min(band_rows, h - r0)
                with _phase("shrink"):
                    strip[r0:r0 + bh, :sw] = shrink_columns(band, bh, w, sw)
                    _phase_sync(strip)
                del band  # freed before the next band uploads: the card holds one
        with _phase("train"):
            centroids = self._train_bucketed(strip, bucket_k(k), sw, h, k, (sw, sh))
            _phase_sync(centroids)
        return centroids

    def _quantize_bands(self, image: Image, palette_lab: torch.Tensor, k_active: int,
                        mode: str, band_rows: int) -> np.ndarray:
        """Pass 2 of the streamed paths (kmeans_tpu/api.py:2579): each band,
        padded to its bucket, through the output pass with `row_offset` its
        first row (the Bayer pattern runs on across band edges); its words
        come back and unpack into its rows of one `[h, w, 4]` host array
        (`_readback`). The dither threshold and the unpack palette serve
        every band and are computed once."""
        w, h = image.dimensions
        kp = palette_lab.shape[0]
        operands = None
        if mode != "meld":
            with _phase("output_pass"):
                operands = self._pass_operands(palette_lab, mode, k_active)
        out = np.empty((h, w, 4), np.uint8)
        for r0 in range(0, h, band_rows):
            band = self._upload_band(image, r0, band_rows)
            bh = min(band_rows, h - r0)
            with _phase("output_pass"):
                result = self._output_pass(band, palette_lab, mode, k_active, r0, operands)
                _phase_sync(result[1])
            if band.shape[1] == w:
                # The band's bucket adds rows only: its first bh rows unpack
                # straight into theirs of the output.
                self._readback(result, bh, w, kp, dest=out[r0:r0 + bh])
            else:
                out[r0:r0 + bh] = self._readback(result, band.shape[0], band.shape[1], kp)[:bh, :w]
            del band, result  # freed before the next band uploads: the card holds one
        return out

    def reduce_pipelined(
        self,
        images,
        color_count: int,
        reduce_mode: ReduceMode = ReduceMode.REPLACE,
    ) -> list[Image]:
        """`reduce` of each image in order, images of any size, with up to
        `_PIPELINE_WINDOW` images uploaded ahead (kmeans_tpu/api.py:2675).
        Each output is this processor's `reduce` of the image, bit for bit:
        the same upload, `_reduce_device` and unpack, in three threads. An
        upload thread copies the next images into page-locked host memory
        and uploads them on a side stream, each with an event; this thread
        waits for an image's event on its own stream, trains it and
        launches its output pass, whose result copies back asynchronously
        behind another event; a host thread waits for that event and
        unpacks. So on the card one image's upload and another's unpack
        overlap this one's training, whose host syncs wait for this
        thread's stream alone. As in the reference, pipeline mode's banded
        path is not taken here: each image takes the monolithic pass."""
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        frames = [_as_image(im) for im in images]
        kp = bucket_k(color_count) if self.bucketing else color_count
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def upload(image):
            if not cuda:
                return self._upload_image(image), None
            with torch.cuda.stream(side):
                dev = self._upload_image(image, pinned=True)
                ready = torch.cuda.Event()
                ready.record(side)
            return dev, ready

        def unpack(image, kind, fetched, rows, cols, done):
            if done is not None:
                done.synchronize()
            w, h = image.dimensions
            palette = fetched[1].numpy() if len(fetched) > 1 else None
            out = _unpack(kind, fetched[0].numpy(), rows, cols, kp, palette)
            return Image(image.dimensions, out[:h, :w])

        results = []
        with ThreadPoolExecutor(1) as uploader, ThreadPoolExecutor(1) as host:
            uploads = [_submit(uploader, upload, f) for f in frames[:_PIPELINE_WINDOW]]
            for i, image in enumerate(frames):
                dev, ready = uploads[i].result()
                uploads[i] = None  # the future no longer holds the image on the card
                if i + _PIPELINE_WINDOW < len(frames):
                    uploads.append(_submit(uploader, upload, frames[i + _PIPELINE_WINDOW]))
                done = None
                if cuda:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    dev.record_stream(stream)
                kind, output, palette = self._reduce_device(dev, image, color_count, mode)
                fetched = [t.to("cpu", non_blocking=cuda) for t in (output, palette)
                           if t is not None]
                if cuda:
                    done = torch.cuda.Event()
                    done.record(stream)
                results.append(_submit(host, unpack, image, kind, fetched, dev.shape[0],
                                       dev.shape[1], done))
            return [r.result() for r in results]

    # --- Shared passes ------------------------------------------------------

    def _train_batched(self, pixels_u8, k, w, h, k_actives=None):
        """Shrink -> Lab -> `fit_restarts_batched` on the pixels' device:
        `[B, H, W, 3]` frames train one palette each at `k`; one `[H, W, 3]`
        image with `k_actives` trains one palette per value. Returns
        `[B, k, 3]` centroids."""
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        shrunk = pixels_u8 if (h, w) == (sh, sw) else resize_uint8(pixels_u8, sh, sw)
        rgb = shrunk.reshape(*shrunk.shape[:-3], -1, 3)
        # The reference's vmapped frames executable seeds on its stored Lab;
        # the one over k values fuses the shared image's Lab into the first
        # map as a solo training does.
        seed = kmeans_model.seed_lab(rgb, inline=k_actives is not None)
        centroids, iterations = kmeans_model.fit_restarts_batched(
            srgb8_to_lab(rgb), k, kmeans_model.reference_seed_index(sw, sh),
            restarts=self.restarts, convergence=ColorSpace.LAB.convergence,
            k_actives=k_actives, metric=self.delta_e, seed=seed,
        )
        self.last_iterations = max(iterations)
        return centroids

    def _output_pass(self, pixels_u8: torch.Tensor, palette_lab: torch.Tensor, mode: str,
                     k_active: int | None = None, row_offset: int = 0, operands=None):
        """The full-resolution pass on the pixels' device, as `(kind,
        output, palette)`: `("meld", RGB24 words, None)`; for replace and
        dither `("indexed", packed indices, [k, 4] RGBA8 palette)` up to
        `INDEXED_MAX_K` colours, `("rgba", [H, W, 4] RGBA8, None)` above
        (kmeans_tpu/api.py:360-369, 557). `k_active` masks the palette's
        trailing rows (a bucketed palette's padding). `row_offset` is the
        absolute row of the pixels' first row (a band's, for the dither
        pattern; meld has no row phase). `operands` are
        `_pass_operands(palette_lab, mode, k_active)`, when the caller
        computed them once for several passes."""
        if mode == "meld":
            return "meld", meld_packed(pixels_u8, palette_lab, k_active, metric=self.delta_e,
                                       fast=self.fast), None
        threshold, palette_rgba = (self._pass_operands(palette_lab, mode, k_active)
                                   if operands is None else operands)
        if palette_rgba is None:
            return "rgba", quantize_rgba(pixels_u8, palette_lab, threshold, k_active, mode=mode,
                                         row_offset=row_offset, metric=self.delta_e,
                                         fast=self.fast), None
        words = assign_packed(pixels_u8, palette_lab, threshold, k_active, mode=mode,
                              row_offset=row_offset, metric=self.delta_e, fast=self.fast)
        return "indexed", words, palette_rgba

    def _pass_operands(self, palette_lab: torch.Tensor, mode: str, k_active: int | None = None):
        """`(threshold, palette)` of a replace or dither output pass: the
        dither threshold (0.0 for replace) and, up to `INDEXED_MAX_K`
        colours, the `[k, 4]` RGBA8 palette that unpacks its indices (None
        past it: the pass writes RGBA)."""
        threshold = (
            dither_threshold(palette_lab, k_active, metric=self.delta_e) if mode == "dither"
            else 0.0
        )
        indexed = palette_lab.shape[0] <= INDEXED_MAX_K
        return threshold, _lab_palette_to_u8(palette_lab)[0] if indexed else None

    def _frames_pass(self, frames_u8, palettes_lab, mode: str, k_actives, fast: bool):
        """`_output_pass` of B frames, frame b against `palettes_lab[b]`,
        in one frames launch (kmeans_tpu/api.py:3237
        `_frames_quantize_tail`); the palette of `("indexed", ...)` is
        `[B, k, 4]`."""
        if mode == "meld":
            return "meld", meld_frames_packed(frames_u8, palettes_lab, k_actives,
                                              self.delta_e, fast), None
        thresholds = (dither_thresholds(palettes_lab, k_actives, self.delta_e)
                      if mode == "dither" else 0.0)
        if palettes_lab.shape[1] > INDEXED_MAX_K:
            return "rgba", quantize_frames(frames_u8, palettes_lab, thresholds, k_actives,
                                           mode, self.delta_e, fast), None
        words = assign_frames_packed(frames_u8, palettes_lab, thresholds, k_actives, mode,
                                     self.delta_e, fast)
        return "indexed", words, _lab_palette_to_u8(palettes_lab)[0]

    def _readback(self, out, h: int, w: int, kp: int, dest=None) -> np.ndarray:
        """Host copy and unpack of `_output_pass`'s result -> `[h, w, 4]`
        RGBA8 numpy (into `dest`, when given: see `_unpack`)."""
        kind, output, palette = out
        return self._readback_frames(
            (kind, output[None], None if palette is None else palette[None]), h, w, kp,
            dest=dest)[0]

    def _readback_frames(self, out, h: int, w: int, kp: int, n: int | None = None,
                         dest=None) -> list:
        """`_readback` of `_frames_pass`'s result: one `[h, w, 4]` RGBA8
        array for each of the first `n` frames (default all), each unpacked
        with its own palette (`dest`: one frame's output array)."""
        kind, output, palettes = out
        with _phase("readback"):
            fetched = _host_fetch(output, *([] if palettes is None else [palettes]))
        n = fetched[0].shape[0] if n is None else n
        with _phase("unpack"):
            return [_unpack(kind, fetched[0][i], h, w, kp, fetched[-1][i], dest)
                    for i in range(n)]

    def _quantize(self, pixels_u8: torch.Tensor, palette_lab: torch.Tensor, mode: str,
                  k_active: int | None = None):
        """Output pass of `[H, W, 3]` pixels with a fixed Lab palette ->
        `[H, W, 4]` RGBA8 numpy (kmeans_tpu/api.py:1597)."""
        with _phase("device"):
            out = self._output_pass(pixels_u8, palette_lab, mode, k_active)
            _phase_sync(out[1])
        return self._readback(out, pixels_u8.shape[0], pixels_u8.shape[1],
                              palette_lab.shape[0])

    # --- Multi-device sharding (kmeans_tpu/api.py:1996-2468) -----------------

    def _mesh(self, mesh) -> Mesh:
        """`mesh`, or for None (kmeans_tpu/api.py:2016) every visible CUDA
        device on the pixel axis for a CUDA processor, the CPU alone for a
        CPU one. A mesh of the other device type raises: nothing moves to
        the CPU quietly."""
        if mesh is None:
            mesh = make_mesh(None if self.device.type == "cuda" else [self.device])
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh's devices are {mesh.device_type} and this processor "
                             f"runs on {self.device}")
        return mesh

    def _mesh_upload(self, mesh: Mesh, image: Image) -> torch.Tensor:
        """The image's RGB on the mesh's first device."""
        with _phase("host_prep"):
            rgb = _host_rgb(image.pixels)
        with _phase("upload"):
            dev = torch.from_numpy(rgb).to(mesh.root)
            _phase_sync(dev)
        return dev

    def _sharded_output(self, mesh: Mesh, rgb, palette_lab: torch.Tensor, mode: str,
                        k_active: int | None = None) -> np.ndarray:
        """The row-sharded output pass of `[H, W, 3]` RGB (host or device)
        -> `[H, W, 4]` RGBA8 (kmeans_tpu/api.py:2024-2034): meld by
        `_meld_sharded`, replace and dither up to `INDEXED_MAX_K` colours by
        `_quantize_indexed_sharded`, past it by `quantize_image_sharded`."""
        if mode == "meld":
            return self._meld_sharded(mesh, rgb, palette_lab, k_active)
        if palette_lab.shape[0] <= INDEXED_MAX_K:
            return self._quantize_indexed_sharded(mesh, rgb, palette_lab, mode, k_active)
        with _phase("device"):
            return quantize_image_sharded(mesh, rgb, palette_lab, mode, k_active,
                                          self.delta_e, self.fast)

    def _quantize_indexed_sharded(self, mesh: Mesh, rgb, palette_lab: torch.Tensor, mode: str,
                                  k_active: int | None = None) -> np.ndarray:
        """Replace or dither, row-sharded (kmeans_tpu/api.py:2037): one
        `assign_packed` launch a shard with its `row_offset`, the threshold
        once on the whole palette; the shards' words and the `[k, 4]`
        palette come back and unpack, gathered, into their rows of the
        output (`unpack_fused_sharded`)."""
        with _phase("upload"):
            blocks, h, local_h = _row_sharded(mesh, rgb)
        with _phase("device"):
            words = _assign_words(blocks, local_h, palette_lab, mode, k_active, self.delta_e,
                                  self.fast)
            _phase_sync(*words)
        with _phase("readback"):
            words = _fetch(words)
            (palette_rgba,) = _host_fetch(_lab_palette_to_u8(palette_lab)[0])
        with _phase("unpack"):
            return unpack_fused_sharded(words, h, blocks[0].shape[1], palette_lab.shape[0],
                                        len(blocks), palette_rgba)

    def _meld_sharded(self, mesh: Mesh, rgb, palette_lab: torch.Tensor,
                      k_active: int | None = None) -> np.ndarray:
        """Meld, row-sharded (kmeans_tpu/api.py:2082): one `meld_packed`
        launch a shard (any k), its RGB24 words unpacked into its rows
        (`unpack_meld_sharded`)."""
        with _phase("upload"):
            blocks, h, _ = _row_sharded(mesh, rgb)
        with _phase("device"):
            words = _meld_words(blocks, palette_lab, k_active, self.delta_e, self.fast)
            _phase_sync(*words)
        with _phase("readback"):
            words = _fetch(words)
        with _phase("unpack"):
            return unpack_meld_sharded(words, h, blocks[0].shape[1], palette_lab.shape[0],
                                       len(blocks))

    def _sharded_fit_kwargs(self, n_px: int, kp: int) -> dict:
        """Trainer and opt-ins of a sharded fit (kmeans_tpu/api.py:2120):
        `_sharded_trainer_route` of the real pixel count; `fast` and
        `train_dtype` reach the accumulator route, as they reach
        `fit_large`."""
        trainer = _sharded_trainer_route(n_px, kp)
        return {"trainer": trainer, "fast": self.fast,
                "plane_dtype": self.train_dtype if trainer == "pallas" else None}

    def _fit_sharded_work(self, work, weight, k: int, first: int, mesh: Mesh, n: int,
                          k_active: int | None = None) -> torch.Tensor:
        """`fit_sharded` of an assembled, shard-padded store routed by its
        real pixel count `n` (kmeans_tpu/api.py:2136); centroids on the
        mesh's first device."""
        with _phase("device"):
            centroids, self.last_iterations = fit_sharded(
                mesh, work, weight, k, first, convergence=ColorSpace.LAB.convergence,
                k_active=k_active, metric=self.delta_e, restarts=self.restarts,
                **self._sharded_fit_kwargs(n, k))
            _phase_sync(centroids)
        return centroids

    def _fit_sharded_centroids(self, image: Image, k: int, mesh: Mesh,
                               dev: torch.Tensor) -> torch.Tensor:
        """Shrink the uploaded image `dev` as `_train` does, Lab, pad to the
        mesh's device count with 0-weight rows, then the pixel-sharded fit
        (kmeans_tpu/api.py:2153)."""
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        n = sh * sw
        with _phase("device"):
            work, weight = _sharded_work(dev[None], sh, sw, shard_rows(n, mesh.devices.size)
                                         * mesh.devices.size)
        return self._fit_sharded_work(work, weight, k, kmeans_model.reference_seed_index(sw, sh),
                                      mesh, n)

    def find_sharded(self, image, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE,
                     mesh=None) -> Image:
        """`find` with the image's rows split over the mesh's pixel axis
        (kmeans_tpu/api.py:1996): the same pixels as `find`, bit for bit
        (the pass is per pixel and the dither phase is the whole image's)."""
        image = _as_image(image)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        mesh = self._mesh(mesh)
        with _phase("host_prep"):
            palette_lab = _colors_to_lab(palette_rgba)
            rgb = _host_rgb(image.pixels)
        palette = torch.from_numpy(palette_lab).to(mesh.root)
        return Image(image.dimensions,
                     self._sharded_output(mesh, rgb, palette, ReduceMode(reduce_mode).value))

    def palette_sharded(self, color_count: int, image, mesh=None) -> np.ndarray:
        """`palette` trained over the mesh's pixel axis
        (kmeans_tpu/api.py:2169): `[k, 4]` RGBA8 sorted by L*."""
        image = _as_image(image)
        _validate_k(color_count)
        mesh = self._mesh(mesh)
        centroids = self._fit_sharded_centroids(image, color_count, mesh,
                                                self._mesh_upload(mesh, image))
        return _palette_readback(centroids, color_count)

    def reduce_sharded(self, color_count: int, image,
                       reduce_mode: ReduceMode = ReduceMode.REPLACE, mesh=None) -> Image:
        """`reduce` with the training's pixels split over the mesh's pixel
        axis and the output pass's rows likewise (kmeans_tpu/api.py:2182).
        The shards' partial sums add in another order than one device's, so
        palettes may move by float rounding; a one-shard mesh gives
        `reduce`'s pixels. Under bucketing the image pads to its bucket and
        trains on its weighted canvas at `bucket_k(k)` clusters with `k`
        active, and the output pass runs on the padded rows
        (`:2204-2240`)."""
        image = _as_image(image)
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        mesh = self._mesh(mesh)
        w, h = image.dimensions
        if not self.bucketing:
            dev = self._mesh_upload(mesh, image)
            centroids = self._fit_sharded_centroids(image, color_count, mesh, dev)
            return Image(image.dimensions, self._sharded_output(mesh, dev, centroids, mode))
        bh, bw = bucket_shape(h, w)
        dev = self._upload_padded([image], bh, bw, device=mesh.root)[0]
        canvas, (sw, sh), first = self._bucket_train_args(w, h, bw, bh)
        with _phase("device"):
            work, weight, _ = self._canvas_lab(dev[None], canvas, [h], [w], [sh], [sw])
            n, d = work.shape[1], mesh.devices.size
            work, weight = _pad_store(work[0], weight[0], shard_rows(n, d) * d)
        centroids = self._fit_sharded_work(work, weight, bucket_k(color_count), first, mesh, n,
                                           k_active=color_count)
        out = self._sharded_output(mesh, dev, centroids, mode, color_count)
        return Image(image.dimensions, out[:h, :w])

    def reduce_images_sharded(self, images, color_count: int,
                              reduce_mode: ReduceMode = ReduceMode.REPLACE,
                              mesh=None) -> list[Image]:
        """`reduce_images` over the mesh (kmeans_tpu/api.py:2264): frames
        split over the data axis, each frame's training pixels over its
        data row's pixel axis (`fit_sharded_batch`), then each frame's
        row-sharded output pass on its row. The batch pads to a multiple of
        the data axis by repeating frame 0, whose outputs are dropped
        (`:2299-2302`); under bucketing frames pad to their bucket and k to
        `bucket_k(k)`, as `reduce_sharded` does."""
        frames = _as_frames(images)
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        mesh = self._mesh(mesh)
        w, h = frames[0].dimensions
        data = mesh.shape[DATA_AXIS]
        count = shard_rows(len(frames), data) * data
        per_row = count // data
        rows = [Mesh(mesh.devices[r:r + 1]) for r in range(data)]
        padded = frames + [frames[0]] * (count - len(frames))
        if self.bucketing:
            (bh, bw), kp = bucket_shape(h, w), bucket_k(color_count)
            canvas, (sw, sh), first = self._bucket_train_args(w, h, bw, bh)
        else:
            sw, sh = shrunk_dimensions(w, h, self.train_max_size)
            kp, first = color_count, kmeans_model.reference_seed_index(sw, sh)
        devs, works, weights = [], [], []
        for i, frame in enumerate(padded):
            root = rows[i // per_row].root
            if self.bucketing:
                dev = self._upload_padded([frame], bh, bw, device=root)[0]
                with _phase("device"):
                    work, weight, _ = self._canvas_lab(dev[None], canvas, [h], [w], [sh], [sw])
                work, weight = work[0], weight[0]
            else:
                dev = self._mesh_upload(rows[i // per_row], frame)
                with _phase("device"):
                    work, weight = _sharded_work(dev[None], sh, sw, sh * sw)
            devs.append(dev)
            works.append(work)
            weights.append(weight)
        n, p = works[0].shape[0], mesh.devices.shape[1]
        with _phase("device"):
            stores = [_pad_store(wk, wt, shard_rows(n, p) * p) for wk, wt in zip(works, weights)]
            cents, iters = fit_frames(
                mesh, [s[0] for s in stores], [s[1] for s in stores], kp, first,
                [color_count] * count, convergence=ColorSpace.LAB.convergence,
                metric=self.delta_e, restarts=self.restarts, **self._sharded_fit_kwargs(n, kp))
        self.last_iterations = max(iters)
        k_active = color_count if self.bucketing else None
        return [Image(frames[0].dimensions,
                      self._sharded_output(rows[i // per_row], devs[i], cents[i], mode,
                                           k_active)[:h, :w])
                for i in range(len(frames))]

    def palette_images_sharded(self, images, color_count: int,
                               algo: Algorithm = Algorithm.KMEANS, mesh=None) -> np.ndarray:
        """`palette_images` with the frames' concatenated training pixels
        split over the mesh's pixel axis (kmeans_tpu/api.py:2365): one
        joint fit, routed by the concatenated pixel count; `[k, 4]` RGBA8
        sorted by L*. A host algorithm runs `palette_images` (`:2391`)."""
        frames = _as_frames(images)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            return self.palette_images(frames, color_count, algo)
        mesh = self._mesh(mesh)
        w, h = frames[0].dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        n, d = len(frames) * sh * sw, mesh.devices.size
        with _phase("host_prep"):
            stack = _stack_rgb(frames, h)
        with _phase("upload"):
            dev = torch.from_numpy(stack).to(mesh.root)
        with _phase("device"):
            work, weight = _sharded_work(dev, sh, sw, shard_rows(n, d) * d)
        centroids = self._fit_sharded_work(work, weight, color_count,
                                           kmeans_model.reference_seed_index(sw, sh), mesh, n)
        return _palette_readback(centroids, color_count)

    def find_batch_sharded(self, images, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE,
                           mesh=None) -> list[Image]:
        """`find_batch` over the mesh (kmeans_tpu/api.py:2409): the frames,
        each padded to a multiple of 4 rows so it keeps `find`'s Bayer phase
        (`:2444-2449`), stack into one tall image whose rows split over the
        mesh's pixel axis; one launch a shard for the whole batch. Each
        frame equals its `find` bit for bit."""
        frames = _as_frames(images)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        mesh = self._mesh(mesh)
        h = frames[0].pixels.shape[0]
        h4 = -(-h // 4) * 4
        with _phase("host_prep"):
            palette_lab = _colors_to_lab(palette_rgba)
            stack = _stack_rgb(frames, h4)
        tall = stack.reshape(-1, *stack.shape[2:])
        out = self._sharded_output(mesh, tall, torch.from_numpy(palette_lab).to(mesh.root),
                                   ReduceMode(reduce_mode).value)
        outs = out.reshape(len(frames), h4, *out.shape[1:])
        return [Image(f.dimensions, outs[i, :h]) for i, f in enumerate(frames)]
