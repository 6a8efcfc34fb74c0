"""State carried from the JAX package into the port.

The JAX package hands out numpy arrays: Lab centroids (`[k, 3]` float32)
and RGBA8 palettes (`[k, 4]` uint8). These helpers turn them into the
port's tensors on a chosen device, so the same state can be fed to both
implementations. They import nothing of the JAX package: the caller passes
the arrays. A palette the reference padded for bucketing
(`kmeans_tpu/utils/bucketing.py::pad_palette_k`) is `[kp, 3]` Lab
centroids, which `centroids_from_reference` carries, and an int
`k_active`, which the port's kernels and trainers take as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def centroids_from_reference(centroids, device="cpu") -> torch.Tensor:
    """`[k, 3]` Lab centroids -> contiguous float32 tensor on `device`."""
    arr = np.ascontiguousarray(np.asarray(centroids, dtype=np.float32))
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"expected [k, 3] Lab centroids, got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def palette_from_reference(palette_rgba, device="cpu") -> torch.Tensor:
    """`[k, 4]` (or `[k, 3]`) RGBA8 palette -> `[k, 4]` uint8 tensor on
    `device`, alpha 255 where it was missing."""
    arr = np.asarray(palette_rgba, dtype=np.uint8)
    if arr.ndim != 2 or arr.shape[1] not in (3, 4):
        raise ValueError(f"expected a [k, 3|4] uint8 palette, got {arr.shape}")
    if arr.shape[1] == 3:
        arr = np.concatenate([arr, np.full((arr.shape[0], 1), 255, np.uint8)], 1)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)
