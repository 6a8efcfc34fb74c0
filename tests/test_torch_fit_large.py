"""PyTorch port vs the JAX package: full-resolution training.

The port's trainers on the tile accumulator (`fit_large`,
`fit_large_restarts`), the row-chunked trainer (`fit_chunked`) and
`fit_restarts` with several seedings are held against the reference's on
the same Lab pixels; the reference's accumulator runs its Pallas kernel in
interpret mode. Tolerance: equal iteration counts (the 128/8 stop rule)
and centroids within 1e-3, as for `fit`: the per-cluster sums are taken
in another order than the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.api import _palette_readback as ref_palette_readback
from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.quantize import quantize_image as ref_quantize_image
from kmeans_tpu_torch import api
from kmeans_tpu_torch.models import kmeans as km

torch.set_num_threads(2)

H, W = 96, 120


def _image(h=H, w=W, seed=0):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def _training_lab(seed=0):
    """The reference's Lab of `_image(seed)` as `[H * W, 3]` float32."""
    return np.array(ref_lab(jnp.asarray(_image(seed=seed)[..., :3].reshape(-1, 3))))


def _assert_fit(got, want):
    got_c, got_i = got
    want_c, want_i = want
    assert got_i == int(want_i)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-3)


@pytest.mark.parametrize(
    "n,first,restarts", [(11520, 4321, 4), (8294400, 5000000, 3), (7, 6, 5), (100, 0, 1)]
)
def test_derive_restart_seeds_equal(n, first, restarts):
    got = km.derive_restart_seeds(n, first, restarts)
    want = np.asarray(ref_km.derive_restart_seeds(n, first, restarts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,plane_dtype", [(8, None), (8, "bfloat16")])
def test_fit_large_matches_reference(k, plane_dtype):
    lab = _training_lab(seed=k)
    first = ref_km.reference_seed_index(W, H)
    want = ref_km.fit_large(jnp.asarray(lab), k, first, interpret=True,
                            plane_dtype=plane_dtype)
    got = km.fit_large(torch.from_numpy(lab), k, first, plane_dtype=plane_dtype)
    _assert_fit(got, want)


def test_fit_large_restarts_matches_reference():
    lab = _training_lab(seed=11)
    want = ref_km.fit_large_restarts(jnp.asarray(lab), 6, 17, restarts=2, interpret=True)
    got = km.fit_large_restarts(torch.from_numpy(lab), 6, 17, restarts=2)
    _assert_fit(got, want)


def test_fit_restarts_matches_reference():
    lab = _training_lab(seed=12)
    want = ref_km.fit_restarts(jnp.asarray(lab), 5, 99, restarts=3)
    got = km.fit_restarts(torch.from_numpy(lab), 5, 99, restarts=3)
    _assert_fit(got, want)


@pytest.mark.parametrize("k,restarts", [(65, 1), (8, 2)])
def test_fit_chunked_matches_reference(monkeypatch, k, restarts):
    """Both trainers cut the pixels into 4096-row chunks here, so several
    chunks are summed (the real chunk, 1 << 18 rows, exceeds the input)."""
    monkeypatch.setattr(ref_km, "_CHUNK_PIXELS", 4096)
    monkeypatch.setattr(km, "_CHUNK_PIXELS", 4096)
    lab = _training_lab(seed=13)[:10000]
    want = ref_km.fit_chunked(jnp.asarray(lab), k, 3, restarts=restarts)
    got = km.fit_chunked(torch.from_numpy(lab), k, 3, restarts=restarts)
    _assert_fit(got, want)


def test_full_resolution_api_matches_reference(monkeypatch):
    """`train_max_size=None` with the 1M-pixel gate lowered, so the
    accumulator route engages on a 96x120 image: the palette equals the
    reference's accumulator trainer's, each training runs one accumulator
    pass per iteration, and the reduce is within 1 of 10000 pixels of the
    reference's quantization with its centroids. (`restarts=2` through the
    API is driven on the card by `chip_smoke.py`; its trainer is held to
    the reference above.)"""
    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 1000)
    calls = []
    twin = km.lloyd_accumulate
    monkeypatch.setattr(km, "lloyd_accumulate",
                        lambda *a, **kw: calls.append(1) or twin(*a, **kw))
    img = _image(seed=21)
    first = ref_km.reference_seed_index(W, H)
    lab = ref_lab(jnp.asarray(img[..., :3].reshape(-1, 3)))
    cents, iters = ref_km.fit_large(lab, 8, first, interpret=True)
    want_palette = ref_palette_readback(cents, 8)
    want_reduce = np.asarray(ref_quantize_image(jnp.asarray(img), cents, mode="replace"))

    port = kt.ImageProcessor(device="cpu", train_max_size=None)
    np.testing.assert_array_equal(port.palette(8, img), want_palette)
    assert port.last_iterations == int(iters) == len(calls)
    got = port.reduce(8, img).pixels
    assert len(calls) == 2 * int(iters)
    differ = int((got != want_reduce).any(-1).sum())
    assert differ <= H * W // 10000, differ


def test_reference_processor_agrees_on_the_shrunk_route():
    """Below the gates both packages keep the plain trainer: the port's
    `train_max_size=None` palette equals the reference processor's."""
    img = _image(48, 64, seed=22)
    want = kmeans_tpu.ImageProcessor(train_max_size=None).palette(4, img)
    got = kt.ImageProcessor(device="cpu", train_max_size=None).palette(4, img)
    np.testing.assert_array_equal(got, want)
