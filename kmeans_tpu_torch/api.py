"""Public API: `ImageProcessor` with `palette` / `find` / `reduce`, in PyTorch.

Port of the k-means path of `kmeans_tpu/api.py`. The entry points keep
the reference's signatures and results:

- `palette(k, image)` -> `[k, 4]` RGBA8 colours sorted by Lab L* ascending;
- `find(image, colors, mode)` -> the image recoloured with a fixed palette;
- `reduce(k, image, algo, mode)` -> the image recoloured with a trained
  palette.

`reduce` runs the reference's indexed route (`api.py:1419-1471`): the
host strips alpha and uploads RGB; on the device the image is shrunk to
the training size (<= 256 px, or full resolution with
`train_max_size=None`), converted to Lab and clustered by the trainer
that `_fit_auto` picks (`models/kmeans.py`; past the reference's size
gates, the tile accumulator `ops/kernels.py::lloyd_accumulate`, a CUDA
kernel on the card); the assign pass (`ops/kernels.py::assign_packed`, a
CUDA kernel on the card) writes bit-packed palette indices; the host
reads back the words and the palette and unpacks them into RGBA.

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
    assign_packed,
    quant_tile_rows,
)
from kmeans_tpu_torch.ops.quantize import dither_threshold
from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words_gather
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


def _indexed_mode(reduce_mode, k: int) -> str:
    """The mode string of the indexed route, or raise for what it lacks."""
    reduce_mode = ReduceMode(reduce_mode)
    if reduce_mode is ReduceMode.MELD:
        raise _not_ported("ReduceMode.MELD", "B3")
    if k > INDEXED_MAX_K:
        raise _not_ported(f"a {k}-colour palette (> {INDEXED_MAX_K})", "B2, B8")
    return reduce_mode.value


def _fit_auto(work, k, first_index, convergence, restarts=1, plane_dtype=None):
    """Pick the trainer as the reference does (kmeans_tpu/api.py:205), with
    its `pallas_ok` read as "the accumulator route": the CUDA kernel on the
    card, its plain twin on the CPU, so both devices run one algorithm.
    `plane_dtype` reaches only the accumulator's planes."""
    def fit_accumulated():
        return kmeans_model.fit_large_restarts(
            work, k, first_index, restarts=restarts, convergence=convergence,
            plane_dtype=plane_dtype,
        )

    if k > 64 and work.shape[0] * k > _CHUNKED_TRAIN_ELEMS:
        if k <= ACCUM_MAX_K:
            return fit_accumulated()
        return kmeans_model.fit_chunked(
            work, k, first_index, restarts=restarts, convergence=convergence
        )
    if k <= 64 and work.shape[0] > _LARGE_TRAIN_PIXELS:
        return fit_accumulated()
    return kmeans_model.fit_restarts(
        work, k, first_index, restarts=restarts, convergence=convergence
    )


def _train(pixels_u8, k, train_shape, first_index, convergence, lab=True,
           restarts=1, train_dtype=None):
    """Shrink -> colour space -> seed -> Lloyd, on the pixels' device
    (kmeans_tpu/api.py::_train_jit). Returns `(centroids, iterations)`."""
    sh, sw = train_shape
    if (pixels_u8.shape[0], pixels_u8.shape[1]) != (sh, sw):
        pixels_u8 = resize_uint8(pixels_u8, sh, sw)
    rgb = pixels_u8[..., :3].reshape(-1, 3)
    work = srgb8_to_lab(rgb) if lab else div(rgb.to(torch.float32), 255.0)
    return _fit_auto(work, k, first_index, convergence, restarts, train_dtype)


def _lab_palette_to_u8(centroids: torch.Tensor):
    """Lab palette -> `([k, 4]` RGBA8, `[k]` L* of the u8 colours)
    (kmeans_tpu/api.py:792)."""
    rgb8 = lab_to_srgb8(centroids)
    lightness = srgb8_to_lab(rgb8)[:, 0]
    alpha = torch.full((rgb8.shape[0], 1), 255, dtype=torch.uint8, device=rgb8.device)
    return torch.cat([rgb8, alpha], dim=1), lightness


def _host_fetch(*tensors) -> tuple:
    return tuple(t.cpu().numpy() for t in tensors)


def _unpack_gather(words, h, w, kp, palette_rgba) -> np.ndarray:
    """`palette_rgba[indices]` from the packed words (kmeans_tpu/api.py:505)."""
    return unpack_tile_words_gather(
        words, h, w, pack_bits(kp), palette_rgba, tile_rows=quant_tile_rows(kp)
    )


def _palette_readback(centroids: torch.Tensor, k: int) -> np.ndarray:
    """Centroids -> `[k, 4]` RGBA8 sorted by L* ascending
    (kmeans_tpu/api.py:820)."""
    with _phase("readback"):
        rgba, lightness = _host_fetch(*_lab_palette_to_u8(centroids))
    with _phase("host_sort"):
        rgba, lightness = rgba[:k], lightness[:k]
        return rgba[np.argsort(lightness, kind="stable")]


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
    `train_max_size=None` trains on every pixel; past the reference's size
    gates that runs on the tile accumulator. `restarts` and
    `train_dtype="bfloat16"` (accumulator planes only) act as in the
    reference. `last_iterations` holds the Lloyd iteration count of the
    latest training."""

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
        if aliases[str(delta_e)] == "cie2000":
            raise _not_ported("delta_e='2000' (CIEDE2000)", "B4")
        if int(restarts) < 1:
            raise ValueError("restarts must be >= 1")
        if bucketing:
            raise _not_ported("bucketing=True", "A.9")
        if fast:
            raise _not_ported("fast=True", "B5")
        if pipeline:
            raise _not_ported("pipeline=True (banded transfer overlap)", "A.13")
        if train_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"train_dtype must be 'bfloat16', 'float32' or None, got {train_dtype!r}"
            )
        self.device = _resolve_device(device)
        self.train_max_size = None if train_max_size is None else int(train_max_size)
        self.restarts = int(restarts)
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
                train_dtype=self.train_dtype,
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
        mode = _indexed_mode(reduce_mode, palette_rgba.shape[0])
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
        mode = _indexed_mode(reduce_mode, color_count)
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
            )
            threshold = dither_threshold(centroids) if mode == "dither" else 0.0
            words = assign_packed(dev, centroids, threshold, mode=mode)
            palette_rgba, _ = _lab_palette_to_u8(centroids)
            _phase_sync(words)
        with _phase("readback"):
            words_np, pal_np = _host_fetch(words, palette_rgba)
        with _phase("unpack"):
            out = _unpack_gather(words_np, h, w, color_count, pal_np)
        return Image(image.dimensions, out)

    def _quantize(self, pixels_u8: torch.Tensor, palette_lab: torch.Tensor, mode: str):
        """Indexed assignment of `[H, W, 3]` pixels to a fixed Lab palette
        -> `[H, W, 4]` RGBA8 numpy (kmeans_tpu/api.py:1597)."""
        with _phase("device"):
            threshold = dither_threshold(palette_lab) if mode == "dither" else 0.0
            words = assign_packed(pixels_u8, palette_lab, threshold, mode=mode)
            palette_rgba, _ = _lab_palette_to_u8(palette_lab)
            _phase_sync(words)
        with _phase("readback"):
            words_np, pal_np = _host_fetch(words, palette_rgba)
        with _phase("unpack"):
            return _unpack_gather(
                words_np, pixels_u8.shape[0], pixels_u8.shape[1],
                palette_lab.shape[0], pal_np,
            )
