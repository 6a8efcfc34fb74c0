"""Shape bucketing for serving.

Port of `kmeans_tpu/utils/bucketing.py` (the reference's package imports
jax, so the code is copied here with a citation of each function; the pad
of `pad_to_bucket` runs on the device, in `ImageProcessor._upload_padded`).
Each image dimension rounds up to a rung of the geometric ladder
{4, 5, 6, 7} * 2^k; the image is padded bottom and right, which keeps every
real pixel's (x, y), so ordered dithering is unchanged after the crop. The
cluster axis rounds up to a power of two (`bucket_k`), its trailing rows
masked by `k_active`, and frame counts past 3 round up the ladder
(`bucket_frames`).

In the JAX package a bucket bounds the number of XLA executables. Eager
PyTorch compiles nothing per shape; here a bucket is what groups
requests of different sizes into one batched training loop and one frames
launch (`ImageProcessor.reduce_many`, `find_many`, `palette_many`), and
the key `warmup` issues one dummy request for.
"""

from __future__ import annotations

import torch

_MANTISSAS = (4, 5, 6, 7)


def next_bucket(n: int) -> int:
    """Smallest ladder value m * 2^k (m in {4, 5, 6, 7}, k >= 0) that is
    >= n (kmeans_tpu/utils/bucketing.py:29)."""
    n = int(n)
    if n <= _MANTISSAS[0]:
        return _MANTISSAS[0]
    k = 0
    while (_MANTISSAS[0] << k) < n:
        k += 1
    # The candidates sit at exponent k (4 * 2^k >= n) and k - 1, where the
    # larger mantissas may already reach n.
    return min(m << kk for kk in (k - 1, k) if kk >= 0 for m in _MANTISSAS if m << kk >= n)


def bucket_shape(height: int, width: int) -> tuple[int, int]:
    """Bucketed `(height, width)` of an image (bucketing.py:50)."""
    return next_bucket(height), next_bucket(width)


def bucket_frames(n: int) -> int:
    """Bucketed frame count of a batch (bucketing.py:70): 1-3 are their
    own buckets, larger counts take the ladder."""
    n = int(n)
    return n if n < 4 else next_bucket(n)


def bucket_k(k: int) -> int:
    """Padded cluster-axis size: the next power of two >= k, at least 4
    (bucketing.py:79)."""
    k = int(k)
    b = 4
    while b < k:
        b <<= 1
    return b


def pad_palette_k(palette_lab: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad a `[K, 3]` Lab palette's rows to `bucket_k(K)` with copies of row
    0, masked downstream by `k_active` (bucketing.py:93). Returns
    `(padded, K)`."""
    k = palette_lab.shape[0]
    kp = bucket_k(k)
    if kp != k:
        palette_lab = torch.cat([palette_lab, palette_lab[:1].expand(kp - k, 3)])
    return palette_lab, k
