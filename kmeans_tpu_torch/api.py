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
unpacks them. `find` runs the same output passes with the caller's
palette. The frame batches train every frame in one batched Lloyd loop
(`fit_restarts_batched`) and recolour all frames in one launch of the
kernels' frames mode, each frame with its own palette. `delta_e="2000"`
puts CIEDE2000 in place of CIE94 in training, dithering and the output
passes. `fast=True` puts the fast tiers of `ops/kernels.py` (the
factorized CIE94 score, the pruned CIEDE2000 tier) under the accumulator
route's training and under the output passes (not under `reduce_batch`'s,
as in the reference); they act at 16 < k <= 512 only, and outside that
range the results equal `fast=False` bit for bit. The shrunk, batched and
row-chunked trainings never see `fast`, as in the reference.

The device is explicit: `ImageProcessor(device=None)` means CUDA and
raises when there is none. The plain-PyTorch CPU path runs only when the
caller names `device="cpu"`. Modes and options of the reference that this
package does not port yet raise `NotImplementedError` naming their
`ROADMAP.md` item; none of them falls back to another path.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.models import kmeans as kmeans_model
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
from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions
from kmeans_tpu_torch.utils.packing import (
    pack_bits,
    unpack_rgb24_tile_words,
    unpack_tile_words_gather,
)
from kmeans_tpu_torch.utils.profiling import phase as _phase
from kmeans_tpu_torch.utils.profiling import phase_sync as _phase_sync

# Training-image shrink cap (kmeans_tpu/api.py:80).
MAX_IMAGE_DIMENSION = 256
# Above this many training pixels (k <= 64) the one-hot update's [N, K]
# intermediate dominates memory and training moves to the tile
# accumulator (kmeans_tpu/api.py:160).
_LARGE_TRAIN_PIXELS = 1 << 20
# For k > 64, the element budget past which the plain trainer's [N, K]
# intermediates leave it (~768 MB each in float32): the tile accumulator
# takes k <= ACCUM_MAX_K, the row-chunked trainer the rest
# (kmeans_tpu/api.py:167).
_CHUNKED_TRAIN_ELEMS = 192 * (1 << 20)


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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})"
    )


def _host_rgb(pixels: np.ndarray) -> np.ndarray:
    """Contiguous `[..., :3]` copy: alpha is ignored by the whole pipeline,
    so only RGB is uploaded (kmeans_tpu/api.py:184)."""
    return np.ascontiguousarray(np.asarray(pixels)[..., :3])


def _fit_auto(work, k, first_index, convergence, restarts=1, plane_dtype=None,
              metric="cie94", fast=False):
    """Pick the trainer as the reference does (kmeans_tpu/api.py:205), with
    its `pallas_ok` read as "the accumulator route": the CUDA kernel on the
    card, its plain twin on the CPU, so both devices run one algorithm.
    Both metrics take that route, as both are in the reference's
    `PALLAS_METRICS`. `plane_dtype` and `fast` reach only the accumulator
    route."""
    def fit_accumulated():
        return kmeans_model.fit_large_restarts(
            work, k, first_index, restarts=restarts, convergence=convergence,
            metric=metric, plane_dtype=plane_dtype, fast=fast,
        )

    if k > 64 and work.shape[0] * k > _CHUNKED_TRAIN_ELEMS:
        if k <= ACCUM_MAX_K:
            return fit_accumulated()
        return kmeans_model.fit_chunked(
            work, k, first_index, restarts=restarts, convergence=convergence,
            metric=metric,
        )
    if k <= 64 and work.shape[0] > _LARGE_TRAIN_PIXELS:
        return fit_accumulated()
    return kmeans_model.fit_restarts(
        work, k, first_index, restarts=restarts, convergence=convergence,
        metric=metric,
    )


def _train(pixels_u8, k, train_shape, first_index, convergence, lab=True,
           restarts=1, train_dtype=None, metric="cie94", fast=False):
    """Shrink -> colour space -> seed -> Lloyd, on the pixels' device
    (kmeans_tpu/api.py::_train_jit). Returns `(centroids, iterations)`."""
    sh, sw = train_shape
    if (pixels_u8.shape[0], pixels_u8.shape[1]) != (sh, sw):
        pixels_u8 = resize_uint8(pixels_u8, sh, sw)
    rgb = pixels_u8[..., :3].reshape(-1, 3)
    work = srgb8_to_lab(rgb) if lab else div(rgb.to(torch.float32), 255.0)
    return _fit_auto(work, k, first_index, convergence, restarts, train_dtype, metric, fast)


def _lab_palette_to_u8(centroids: torch.Tensor):
    """Lab palette(s) `[..., k, 3]` -> `([..., k, 4]` RGBA8, `[..., k]` L*
    of the u8 colours) (kmeans_tpu/api.py:792)."""
    rgb8 = lab_to_srgb8(centroids)
    lightness = srgb8_to_lab(rgb8)[..., 0]
    alpha = torch.full(rgb8.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb8.device)
    return torch.cat([rgb8, alpha], dim=-1), lightness


def _host_fetch(*tensors) -> tuple:
    return tuple(t.cpu().numpy() for t in tensors)


def _unpack_gather(words, h, w, kp, palette_rgba) -> np.ndarray:
    """`palette_rgba[indices]` from the packed words (kmeans_tpu/api.py:505)."""
    return unpack_tile_words_gather(
        words, h, w, pack_bits(kp), palette_rgba, tile_rows=quant_tile_rows(kp)
    )


def _unpack_meld(words, h, w, kp) -> np.ndarray:
    """`[h, w, 4]` RGBA from the meld pass's RGB24 words
    (kmeans_tpu/api.py:494)."""
    return unpack_rgb24_tile_words(words, h, w, tile_rows=quant_tile_rows(kp))


def _palette_readback(centroids: torch.Tensor, k: int) -> np.ndarray:
    """Centroids -> `[k, 4]` RGBA8 sorted by L* ascending
    (kmeans_tpu/api.py:820)."""
    with _phase("readback"):
        rgba, lightness = _host_fetch(*_lab_palette_to_u8(centroids))
    with _phase("host_sort"):
        rgba, lightness = rgba[:k], lightness[:k]
        return rgba[np.argsort(lightness, kind="stable")]


def _unpack(kind: str, out: np.ndarray, h: int, w: int, kp: int, palette_rgba) -> np.ndarray:
    """`[h, w, 4]` RGBA8 from one image's host copy of an output pass:
    packed indices and their palette, RGB24 words, or RGBA as it is."""
    if kind == "indexed":
        return _unpack_gather(out, h, w, kp, palette_rgba)
    if kind == "meld":
        return _unpack_meld(out, h, w, kp)
    return out


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


def _as_frames(images) -> list:
    """Images of one size, as `Image`s; raises on none or mixed sizes."""
    frames = [_as_image(im) for im in images]
    if not frames:
        raise ValueError("need at least one frame")
    if any(f.dimensions != frames[0].dimensions for f in frames):
        raise ValueError("all frames must share dimensions")
    return frames


def _stack_rgb(frames, rows: int) -> np.ndarray:
    """`[B, rows, W, 3]` RGB of the frames in one host copy; rows past a
    frame's height are zero (kmeans_tpu/api.py:3669-3673)."""
    h, w = frames[0].pixels.shape[:2]
    stack = np.empty((len(frames), rows, w, 3), np.uint8)
    for i, f in enumerate(frames):
        stack[i, :h] = np.asarray(f.pixels)[..., :3]
    stack[:, h:] = 0
    return stack


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
    PyTorch path. The other arguments mirror `kmeans_tpu.ImageProcessor`;
    values this package does not port yet raise `NotImplementedError`.
    `delta_e` is `"94"` (CIE94) or `"2000"` (CIEDE2000), as in the
    reference. `train_max_size=None` trains on every pixel; past the
    reference's size gates that runs on the tile accumulator. `restarts` and
    `train_dtype="bfloat16"` (accumulator planes only) act as in the
    reference. `fast=True` opts into the fast tiers (module docstring):
    not bit-equal to exact at 16 < k <= 512, equal outside.
    `last_iterations` holds the Lloyd iteration count of the
    latest training (of a batch: its longest member's)."""

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
        if bucketing:
            raise _not_ported("bucketing=True", "A.9")
        if pipeline:
            raise _not_ported("pipeline=True (banded transfer overlap)", "A.13")
        if train_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"train_dtype must be 'bfloat16', 'float32' or None, got {train_dtype!r}"
            )
        self.device = _resolve_device(device)
        self.delta_e = aliases[str(delta_e)]
        self.train_max_size = None if train_max_size is None else int(train_max_size)
        self.restarts = int(restarts)
        self.fast = bool(fast)
        self.train_dtype = None if train_dtype == "float32" else train_dtype
        self.last_iterations: int | None = None

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def extract_palette_kmeans(
        self, image: Image, k: int, color_space: ColorSpace = ColorSpace.LAB
    ) -> torch.Tensor:
        """Train `k` centroids on the shrunk image; returns `[k, 3]` in the
        working space, on the processor's device (kmeans_tpu/api.py:1035)."""
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        first = kmeans_model.reference_seed_index(sw, sh)
        with _phase("host_prep"):
            rgb = _host_rgb(image.pixels)
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

    def palette(
        self, color_count: int, image, algo: Algorithm = Algorithm.KMEANS
    ) -> np.ndarray:
        """The `k` dominant colours as `[k, 4]` RGBA8, sorted by L*."""
        image = _as_image(image)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            raise _not_ported(f"{algo}", "A.8")
        return _palette_readback(self.extract_palette_kmeans(image, color_count), color_count)

    def find(
        self, image, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> Image:
        """Recolour with a fixed palette, no training."""
        image = _as_image(image)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        mode = ReduceMode(reduce_mode).value
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
        """Quantize the image to `color_count` trained colours."""
        image = _as_image(image)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            raise _not_ported(f"{algo}", "A.8")
        mode = ReduceMode(reduce_mode).value
        w, h = image.dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        first = kmeans_model.reference_seed_index(sw, sh)
        with _phase("host_prep"):
            rgb = _host_rgb(image.pixels)
        with _phase("upload"):
            dev = self._upload(rgb)
            _phase_sync(dev)
        with _phase("device"):
            centroids, self.last_iterations = _train(
                dev, color_count, (sh, sw), first, ColorSpace.LAB.convergence,
                restarts=self.restarts, train_dtype=self.train_dtype,
                metric=self.delta_e, fast=self.fast,
            )
            out = self._output_pass(dev, centroids, mode)
            _phase_sync(out[1])
        return Image(image.dimensions, self._readback(out, h, w, color_count))

    def find_batch(
        self, images, colors, reduce_mode: ReduceMode = ReduceMode.REPLACE
    ) -> list[Image]:
        """`find` over same-sized frames (GIF frames) with one output pass
        (kmeans_tpu/api.py:1653): the frames stack into one tall image and
        go through one launch. For replace and dither each frame's rows pad
        to a multiple of 4, so every frame starts at Bayer row phase 0 and
        the tall image's dither equals each frame's own
        (`_find_batch_fused_jit:3652`); meld stacks them as they are
        (`_find_batch_meld_jit:3686`)."""
        frames = _as_frames(images)
        palette_rgba = _colors_rgba(colors)
        if palette_rgba.shape[0] == 0:
            raise ValueError("palette must contain at least one color")
        mode = ReduceMode(reduce_mode).value
        w, h = frames[0].dimensions
        rows = h if mode == "meld" else -(-h // 4) * 4
        with _phase("host_prep"):
            palette_lab = _colors_to_lab(palette_rgba)
            stack = _stack_rgb(frames, rows)
        with _phase("upload"):
            dev = self._upload(stack)
            palette_dev = self._upload(palette_lab)
            _phase_sync(dev)
        tall = self._quantize(dev.reshape(len(frames) * rows, w, 3), palette_dev, mode)
        outs = tall.reshape(len(frames), rows, w, 4)[:, :h]
        return [Image(frames[0].dimensions, outs[i]) for i in range(len(frames))]

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
        only that output pass, as in the reference."""
        frames = _as_frames(images)
        _validate_k(color_count)
        mode = ReduceMode(reduce_mode).value
        w, h = frames[0].dimensions
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

    def palette_images(
        self, images, color_count: int, algo: Algorithm = Algorithm.KMEANS
    ) -> np.ndarray:
        """One palette trained jointly over same-sized frames (a global GIF
        palette; kmeans_tpu/api.py:1924, `_train_frames_jit:3618`): every
        frame shrinks, the Lab pixels concatenate in frame order (the seed
        index addresses frame 0) and train once. `[k, 4]` RGBA8, L*-sorted."""
        frames = _as_frames(images)
        _validate_k(color_count)
        if algo is not Algorithm.KMEANS:
            raise _not_ported(f"{algo}", "A.8")
        w, h = frames[0].dimensions
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        with _phase("host_prep"):
            stack = _stack_rgb(frames, h)
        with _phase("upload"):
            dev = self._upload(stack)
            _phase_sync(dev)
        with _phase("device"):
            shrunk = dev if (h, w) == (sh, sw) else resize_uint8(dev, sh, sw)
            centroids, self.last_iterations = kmeans_model.fit_restarts(
                srgb8_to_lab(shrunk.reshape(-1, 3)), color_count,
                kmeans_model.reference_seed_index(sw, sh), restarts=self.restarts,
                convergence=ColorSpace.LAB.convergence, metric=self.delta_e,
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
        output pass is exact whatever `fast` says."""
        image = _as_image(image)
        ks = [int(k) for k in color_counts]
        if not ks:
            raise ValueError("need at least one color count")
        for k in ks:
            _validate_k(k)
        kmax = max(ks)
        mode = ReduceMode(reduce_mode).value
        w, h = image.dimensions
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

    def reduce_many(self, images, color_count: int, reduce_mode=ReduceMode.REPLACE):
        """Not ported yet: mixed-size batches coalesced by shape bucket."""
        raise _not_ported("reduce_many (bucketed mixed-size batches)", "A.9")

    def find_many(self, images, colors, reduce_mode=ReduceMode.REPLACE):
        """Not ported yet: mixed-size batches coalesced by shape bucket."""
        raise _not_ported("find_many (bucketed mixed-size batches)", "A.9")

    def palette_many(self, images, color_count: int):
        """Not ported yet: mixed-size batches coalesced by shape bucket."""
        raise _not_ported("palette_many (bucketed mixed-size batches)", "A.9")

    def warmup(self, *args, **kwargs):
        """Not ported yet: it compiles the bucketed executables."""
        raise _not_ported("warmup (bucketing)", "A.9")

    def _train_batched(self, pixels_u8, k, w, h, k_actives=None):
        """Shrink -> Lab -> `fit_restarts_batched` on the pixels' device:
        `[B, H, W, 3]` frames train one palette each at `k`; one `[H, W, 3]`
        image with `k_actives` trains one palette per value. Returns
        `[B, k, 3]` centroids."""
        sw, sh = shrunk_dimensions(w, h, self.train_max_size)
        shrunk = pixels_u8 if (h, w) == (sh, sw) else resize_uint8(pixels_u8, sh, sw)
        work = srgb8_to_lab(shrunk.reshape(*shrunk.shape[:-3], -1, 3))
        centroids, iterations = kmeans_model.fit_restarts_batched(
            work, k, kmeans_model.reference_seed_index(sw, sh), restarts=self.restarts,
            convergence=ColorSpace.LAB.convergence, k_actives=k_actives,
            metric=self.delta_e,
        )
        self.last_iterations = max(iterations)
        return centroids

    def _output_pass(self, pixels_u8: torch.Tensor, palette_lab: torch.Tensor, mode: str):
        """The full-resolution pass on the pixels' device, as `(kind,
        output, palette)`: `("meld", RGB24 words, None)`; for replace and
        dither `("indexed", packed indices, [k, 4] RGBA8 palette)` up to
        `INDEXED_MAX_K` colours, `("rgba", [H, W, 4] RGBA8, None)` above
        (kmeans_tpu/api.py:360-369, 557)."""
        if mode == "meld":
            return "meld", meld_packed(pixels_u8, palette_lab, metric=self.delta_e,
                                       fast=self.fast), None
        threshold = (
            dither_threshold(palette_lab, metric=self.delta_e) if mode == "dither" else 0.0
        )
        if palette_lab.shape[0] > INDEXED_MAX_K:
            return "rgba", quantize_rgba(pixels_u8, palette_lab, threshold, mode=mode,
                                         metric=self.delta_e, fast=self.fast), None
        words = assign_packed(pixels_u8, palette_lab, threshold, mode=mode,
                              metric=self.delta_e, fast=self.fast)
        return "indexed", words, _lab_palette_to_u8(palette_lab)[0]

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

    def _readback(self, out, h: int, w: int, kp: int) -> np.ndarray:
        """Host copy and unpack of `_output_pass`'s result -> `[h, w, 4]`
        RGBA8 numpy."""
        kind, output, palette = out
        return self._readback_frames(
            (kind, output[None], None if palette is None else palette[None]), h, w, kp)[0]

    def _readback_frames(self, out, h: int, w: int, kp: int) -> list:
        """`_readback` of `_frames_pass`'s result: one `[h, w, 4]` RGBA8
        array per frame, each unpacked with its own palette."""
        kind, output, palettes = out
        with _phase("readback"):
            fetched = _host_fetch(output, *([] if palettes is None else [palettes]))
        with _phase("unpack"):
            return [_unpack(kind, fetched[0][i], h, w, kp, fetched[-1][i])
                    for i in range(fetched[0].shape[0])]

    def _quantize(self, pixels_u8: torch.Tensor, palette_lab: torch.Tensor, mode: str):
        """Output pass of `[H, W, 3]` pixels with a fixed Lab palette ->
        `[H, W, 4]` RGBA8 numpy (kmeans_tpu/api.py:1597)."""
        with _phase("device"):
            out = self._output_pass(pixels_u8, palette_lab, mode)
            _phase_sync(out[1])
        return self._readback(out, pixels_u8.shape[0], pixels_u8.shape[1],
                              palette_lab.shape[0])
