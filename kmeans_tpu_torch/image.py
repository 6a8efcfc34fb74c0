"""Image container: dimensions + RGBA8 pixel buffer.

Re-implementation of `kmeans_tpu/image.py::Image` (numpy only); the port
cannot import it, because `kmeans_tpu` imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Image:
    """An RGBA8 image: `dimensions=(width, height)` and `pixels[H, W, 4]` uint8."""

    dimensions: tuple[int, int]
    pixels: np.ndarray  # [H, W, 4] uint8

    def __post_init__(self) -> None:
        w, h = self.dimensions
        px = np.asarray(self.pixels, dtype=np.uint8)
        if px.ndim == 1 or (px.ndim == 2 and px.shape[-1] == 4):
            px = px.reshape(h, w, 4)
        if px.shape != (h, w, 4):
            raise ValueError(
                f"pixel buffer shape {px.shape} does not match dimensions {(h, w, 4)}"
            )
        self.pixels = px

    @classmethod
    def new(cls, dimensions: tuple[int, int], pixels: np.ndarray) -> "Image":
        return cls(dimensions, pixels)

    @property
    def width(self) -> int:
        return self.dimensions[0]

    @property
    def height(self) -> int:
        return self.dimensions[1]

    def into_raw_pixels(self) -> np.ndarray:
        """Flat uint8 RGBA byte buffer."""
        return self.pixels.reshape(-1)


def copied_pixel(dimensions: tuple[int, int], rgba: np.ndarray) -> Image:
    """An `Image` owning a copy of `rgba` (kmeans_tpu/image.py:55)."""
    return Image(dimensions, np.array(rgba, dtype=np.uint8, copy=True))


def borrowed_pixel(dimensions: tuple[int, int], rgba: np.ndarray) -> Image:
    """An `Image` over `rgba` without a copy when it is already uint8
    (kmeans_tpu/image.py:60)."""
    return Image(dimensions, np.asarray(rgba, dtype=np.uint8))
