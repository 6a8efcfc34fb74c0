"""PyTorch port vs the JAX package: the host palette algorithms (octree,
median cut, Wu) and their routes through the entry points.

First the algorithms themselves (`kmeans_tpu_torch/models/`), on the
inputs of the reference's `tests/test_octree.py`, `tests/test_wu.py` and
the median-cut cases of `tests/test_api.py`: equal palettes. Then the
shrink they train on, the reference's eager `resize_uint8`
(`ops/resize.py::resize_uint8_eager`), at 0 differing bytes at five
sizes. Then `palette`, `reduce` (replace, dither, meld), `palette_images`
and `palette_many` with each algorithm, bucketed and not, on the CPU
against the reference (`kmeans_tpu.ImageProcessor` on the JAX CPU
backend): palettes equal in u8, replace and dither pixels equal, meld
within 1 u8 step on at most 1e-3 of the pixels. The images are larger
than the 128-px cap, so the shrink runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.models import mediancut as ref_mediancut
from kmeans_tpu.models import octree as ref_octree
from kmeans_tpu.models import wu as ref_wu
from kmeans_tpu.ops.resize import resize_uint8 as ref_resize_uint8
from kmeans_tpu_torch import api
from kmeans_tpu_torch.models import mediancut, octree, wu
from kmeans_tpu_torch.ops.resize import resize_uint8_eager, shrunk_dimensions

torch.set_num_threads(2)

# The reference's octree fixture (tests/test_octree.py): 46 distinct colours.
FIXTURE = np.asarray([
    [9, 10, 20], [16, 20, 31], [21, 29, 40], [23, 32, 56], [25, 51, 45],
    [30, 29, 57], [32, 46, 55], [36, 21, 39], [37, 58, 94], [37, 86, 46],
    [52, 28, 39], [57, 74, 80], [60, 94, 139], [64, 39, 81], [65, 29, 49],
    [70, 130, 50], [77, 43, 50], [79, 143, 186], [87, 114, 119], [96, 44, 44],
    [115, 190, 211], [117, 36, 56], [117, 167, 67], [122, 54, 123],
    [122, 72, 65], [129, 151, 150], [136, 75, 43], [162, 62, 140],
    [164, 221, 219], [165, 48, 48], [168, 181, 178], [168, 202, 88],
    [173, 119, 87], [190, 119, 43], [192, 148, 115], [198, 81, 151],
    [199, 207, 204], [207, 87, 60], [208, 218, 145], [215, 181, 148],
    [218, 134, 62], [222, 158, 65], [223, 132, 165], [231, 213, 179],
    [232, 193, 112], [235, 237, 233],
], np.uint8)


def _blobs(base, n, spread, seed):
    """`n` pixels per base colour, each moved by at most `spread`."""
    rng = np.random.default_rng(seed)
    base = np.asarray(base, np.int32)
    return np.concatenate([np.clip(b + rng.integers(-spread, spread + 1, (n, 3)), 0, 255)
                           for b in base]).astype(np.uint8)


def _blobs_image_pixels():
    """The pixels of `tests/test_api.py`'s `blobs_image` (96x128, 4 blobs)."""
    rng = np.random.default_rng(11)
    base = np.array([[220, 40, 40], [40, 200, 60], [50, 60, 210], [235, 225, 80]], np.int32)
    idx = rng.integers(0, 4, size=(96, 128))
    return np.clip(base[idx] + rng.integers(-12, 13, idx.shape + (3,)), 0, 255).astype(
        np.uint8).reshape(-1, 3)


# (name, pixels, k): the reference tests' inputs.
ALGO_INPUTS = {
    "fixture_k8": (FIXTURE, 8),
    "two_colours_k8": (np.asarray([[10, 20, 30], [200, 100, 50]] * 7, np.uint8), 8),
    "zero_k": (FIXTURE, 0),
    "near_greys_k1": (np.asarray([[100, 100, 100]] * 3 + [[101, 101, 101]], np.uint8), 1),
    "random500_k6": (np.random.default_rng(8).integers(0, 256, (500, 3), dtype=np.uint8), 6),
    "heavy_ties_k2": (np.random.default_rng(13).integers(0, 5, (300, 3), dtype=np.uint8) * 50,
                      2),
    "heavy_ties_k9": (np.random.default_rng(14).integers(0, 5, (300, 3), dtype=np.uint8) * 50,
                      9),
    "clusters_k4": (_blobs([[20, 30, 40], [220, 40, 60], [60, 200, 90], [90, 110, 230]],
                           500, 6, 1), 4),
    "single_colour_k5": (np.full((50, 3), 123, np.uint8), 5),
    "empty_k8": (np.zeros((0, 3), np.uint8), 8),
    "random4096_k8": (np.random.default_rng(2).integers(0, 256, (4096, 3), dtype=np.uint8), 8),
    "blobs_image_k4": (_blobs_image_pixels(), 4),
    "two_greys_k8": (np.asarray([[10, 10, 10], [200, 200, 200]] * 5, np.uint8), 8),
}
ALGOS = {
    "octree": (octree.extract_palette_octree, ref_octree.extract_palette_octree),
    "mediancut": (mediancut.extract_palette_mediancut,
                  ref_mediancut.extract_palette_mediancut),
    "wu": (wu.extract_palette_wu, ref_wu.extract_palette_wu),
}


@pytest.mark.parametrize("case", sorted(ALGO_INPUTS))
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_algorithm_matches_reference(algo, case):
    pixels, k = ALGO_INPUTS[case]
    port, ref = ALGOS[algo]
    got = port(pixels, k)
    assert got == ref(pixels, k)
    assert len(got) <= max(k, 0)


def test_octree_tree_matches_reference_per_pixel():
    """`ColorTree.add_color` one pixel at a time (the reference's scan)
    reduces to the aggregated `add_pixels` result, in both packages."""
    pixels = np.random.default_rng(8).integers(0, 256, (500, 3), dtype=np.uint8)
    trees = [octree.ColorTree(), ref_octree.ColorTree()]
    for r, g, b in pixels.tolist():
        for tree in trees:
            tree.add_color(r, g, b)
    want = ref_octree.extract_palette_octree(pixels, 6)
    assert [tree.reduce(6) for tree in trees] == [want, want]


def test_wu_moments_match_reference():
    rgb = np.random.default_rng(0).integers(0, 256, (1000, 3), dtype=np.uint8)
    for got, want in zip(wu._moments(rgb), ref_wu._moments(rgb)):
        np.testing.assert_array_equal(got, want)
    full = wu._Box(0, 32, 0, 32, 0, 32)
    assert wu._vol(full, wu._moments(rgb)[0]) == 1000


@pytest.mark.parametrize("w,h", [(1920, 1080), (3840, 2160), (1080, 1350), (420, 300),
                                 (800, 600)])
def test_eager_shrink_matches_reference(w, h):
    """The host algorithms' shrink to the 128-px cap against the reference's
    eager `resize_uint8` (its `_shrunk_pixels`): 0 differing bytes."""
    img = np.random.default_rng(w * h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    sw, sh = shrunk_dimensions(w, h, api.OCTREE_MAX_SIZE)
    want = np.asarray(ref_resize_uint8(jnp.asarray(img), sh, sw))
    got = resize_uint8_eager(torch.from_numpy(img), sh, sw).numpy()
    assert got.shape == want.shape == (sh, sw, 3)
    assert int((got != want).sum()) == 0


def _image(h, w, seed):
    """Gradient plus noise, RGBA8 (alpha 255)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // (w - 1), y * 255 // (h - 1), (x + y) * 255 // (h + w - 2)], -1)
    rgb = np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


# 150x210 shrinks to 91x128 under the cap, and pads to the 160x224 bucket.
H, W = 150, 210
K = 8


@pytest.fixture(scope="module")
def image():
    return _image(H, W, 5)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "bucketed"])
def procs(request):
    return (kmeans_tpu.ImageProcessor(bucketing=request.param),
            kt.ImageProcessor(device="cpu", bucketing=request.param))


def _check_pixels(got, want, mode):
    step = np.abs(got.astype(np.int64) - want).max(-1)
    flips = int((step > 0).sum())
    if mode == "MELD":
        assert step.max() <= 1 and flips <= step.size // 1000, flips
    else:
        assert flips == 0, f"{flips} of {step.size} pixels differ"


@pytest.mark.parametrize("algo", ["OCTREE", "MEDIANCUT", "WU"])
def test_palette_and_reduce_match_reference(procs, image, algo):
    ref, port = procs
    want_pal = ref.palette(K, image, kmeans_tpu.Algorithm[algo])
    got_pal = port.palette(K, image, kt.Algorithm[algo])
    np.testing.assert_array_equal(got_pal, want_pal)
    assert 1 <= got_pal.shape[0] <= K
    for mode in ("REPLACE", "DITHER", "MELD"):
        want = ref.reduce(K, image, kmeans_tpu.Algorithm[algo], kmeans_tpu.ReduceMode[mode])
        got = port.reduce(K, image, kt.Algorithm[algo], kt.ReduceMode[mode])
        assert got.dimensions == (W, H)
        _check_pixels(got.pixels, want.pixels, mode)
        if mode != "MELD":
            colours = np.unique(got.pixels.reshape(-1, 4), axis=0)
            assert set(map(tuple, colours)) <= set(map(tuple, got_pal))


@pytest.mark.parametrize("algo", ["OCTREE", "MEDIANCUT", "WU"])
def test_palette_images_and_many_match_reference(procs, image, algo):
    """`palette_images` runs the algorithm once over both frames' shrunk
    pixels; `palette_many` once per image (sizes below and above the cap,
    and two in one bucket)."""
    ref, port = procs
    frames = [image, image[::-1].copy()]
    np.testing.assert_array_equal(
        port.palette_images(frames, K, kt.Algorithm[algo]),
        ref.palette_images(frames, K, kmeans_tpu.Algorithm[algo]))
    many = [image, image[:96, :128].copy(), image[1:97, 3:131].copy()]
    got = port.palette_many(many, K, kt.Algorithm[algo])
    want = ref.palette_many(many, K, kmeans_tpu.Algorithm[algo])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_no_algorithm_refusal_left():
    """No entry point refuses a host algorithm any more, and the shrink
    runs only where the image exceeds the cap."""
    proc = kt.ImageProcessor(device="cpu")
    small = _image(40, 60, 9)
    for algo in (kt.Algorithm.OCTREE, kt.Algorithm.MEDIANCUT, kt.Algorithm.WU):
        assert proc.palette(3, small, algo).shape[1] == 4
        assert proc.reduce(3, small, algo).pixels.shape == (40, 60, 4)
        assert proc.palette_images([small, small], 3, algo).shape[1] == 4
    rgb = proc._shrunk_pixels(kt.Image((60, 40), small), api.OCTREE_MAX_SIZE)
    np.testing.assert_array_equal(rgb, small[..., :3])
