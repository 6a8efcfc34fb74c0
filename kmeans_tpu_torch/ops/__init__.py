"""Colour science, distances, resize, output modes and the CUDA kernels.

The names of `kmeans_tpu/ops/__init__.py`, from their ports here.
"""

from kmeans_tpu_torch.ops.colorspace import (
    lab_to_srgb,
    lab_to_srgb8,
    linear_to_srgb,
    srgb8_to_lab,
    srgb_to_lab,
    srgb_to_linear,
)
from kmeans_tpu_torch.ops.delta_e import distance_cie94, distance_cie94_sq, distance_cie2000
from kmeans_tpu_torch.ops.resize import resize_bilinear, resize_uint8, shrunk_dimensions

__all__ = [
    "srgb_to_lab",
    "lab_to_srgb",
    "srgb8_to_lab",
    "lab_to_srgb8",
    "srgb_to_linear",
    "linear_to_srgb",
    "distance_cie94",
    "distance_cie94_sq",
    "distance_cie2000",
    "resize_bilinear",
    "resize_uint8",
    "shrunk_dimensions",
]
