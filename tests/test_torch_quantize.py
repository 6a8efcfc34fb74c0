"""PyTorch port vs the JAX package: replace and dither (plain versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import quantize as ref_q
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu_torch.interop import centroids_from_reference
from kmeans_tpu_torch.ops import quantize as q

torch.set_num_threads(2)


def _palette(k, seed):
    rng = np.random.default_rng(seed)
    return np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))


@pytest.mark.parametrize("k", [1, 2, 3, 8, 17, 64])
def test_dither_threshold_matches(k):
    pal = _palette(k, seed=k)
    want = float(ref_q.dither_threshold(jnp.asarray(pal)))
    got = q.dither_threshold(centroids_from_reference(pal))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_dither_threshold_k_active():
    pal = _palette(12, seed=5)
    want = float(ref_q.dither_threshold(jnp.asarray(pal), k_active=7))
    got = float(q.dither_threshold(centroids_from_reference(pal), k_active=7))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("row_offset", [0, 3])
def test_bayer_values_equal(row_offset):
    want = np.asarray(ref_q.bayer_values(9, 11, row_offset))
    np.testing.assert_array_equal(q.bayer_values(9, 11, row_offset).numpy(), want)


@pytest.mark.parametrize("mode", ["replace", "dither"])
@pytest.mark.parametrize("k", [2, 8, 17])
def test_quantize_image_matches(mode, k):
    """The XLA output pass against the port's plain one on a seeded image.
    Any differing pixel is counted; at most 1e-4 of them may differ (a
    near-tie decided by an ulp of the Lab conversion)."""
    rng = np.random.default_rng(10 + k)
    img = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    pal = _palette(k, seed=20 + k)
    want = np.asarray(ref_q.quantize_image(jnp.asarray(img), jnp.asarray(pal), mode=mode))
    got = q.quantize_image(torch.from_numpy(img), centroids_from_reference(pal), mode).numpy()
    differ = int((got != want).any(-1).sum())
    print(f"quantize_image k={k} {mode}: {differ} of {64 * 96} pixels differ")
    assert differ <= 64 * 96 // 10000


def test_assign_index_and_nearest_color():
    rng = np.random.default_rng(4)
    lab = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8))))
    pal = _palette(6, seed=9)
    idx = q.assign_index(torch.from_numpy(lab), centroids_from_reference(pal), "dither")
    want = np.asarray(ref_q.assign_index(jnp.asarray(lab), jnp.asarray(pal), "dither"))
    np.testing.assert_array_equal(idx.numpy(), want)
    col = q.nearest_color(torch.from_numpy(lab), centroids_from_reference(pal))
    want = np.asarray(ref_q.nearest_color(jnp.asarray(lab), jnp.asarray(pal)))
    np.testing.assert_array_equal(col.numpy(), want)
    with pytest.raises(ValueError, match="replace/dither only"):
        q.assign_index(torch.from_numpy(lab), centroids_from_reference(pal), "meld")
