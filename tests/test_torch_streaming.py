"""PyTorch port vs the JAX package: streaming in row bands.

The same numpy-seeded images go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU), at the reference's own test
sizes (tests/test_bucketing.py, tests/test_api.py). Bars:

- `find_streamed` equals the reference's `find_streamed` and the port's
  bucketed `find` bit for bit, in every mode at several band splits, and
  past 1024 colours (the RGBA route, dither rows offset per band);
- `reduce_streamed` of an image within the training cap equals the
  reference's and the port's bucketed `reduce` bit for bit; past the cap
  (the two-stage shrink: each band along its columns, then the strip)
  its u8 palette equals the reference's and at least 99.99% of its pixels
  do; `palette_streamed` equals the reference's;
- the band shrink (`resize_to_canvas` with `src_h = out_h`, and
  `shrink_columns`, chunked) gives the reference's `_canvas_shrink_jit`
  bytes, 0 differing, a canvas wider than the padded band included;
- `reduce_pipelined` equals the port's `reduce` of each image, bucketed
  and not, past its window of 4;
- the reference's `ValueError`s, and `band_rows` below 4 clamped to 4.

Each entry point reuses one image shape, so each reference function
compiles few shapes.
"""

import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.api import _canvas_shrink_jit as ref_canvas_shrink
from kmeans_tpu.image import Image as RefImage
from kmeans_tpu_torch.ops import resize
from kmeans_tpu_torch.utils.bucketing import bucket_shape

torch.set_num_threads(2)

MODES = ("REPLACE", "DITHER", "MELD")


def _gradient(h, w, seed):
    """Gradient plus noise, RGBA8 (alpha 255)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1)
    rgb = np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def _blocks(h, w, seed, base, block):
    """The reference tests' blocky images: `base` colours in `block`-pixel
    squares, with the noise of tests/test_bucketing.py:478 when `block` is 1."""
    rng = np.random.default_rng(seed)
    base = np.array(base, np.int32)
    idx = rng.integers(0, len(base), (h // block, w // block))
    rgb = np.kron(base[idx], np.ones((block, block, 1), np.int32))
    if block == 1:
        rgb = np.clip(rgb + rng.integers(-10, 11, (h, w, 3)), 0, 255)
    return np.concatenate([rgb.astype(np.uint8), np.full((h, w, 1), 255, np.uint8)], -1)


def _ref_image(rgba):
    return RefImage((rgba.shape[1], rgba.shape[0]), rgba)


@pytest.fixture(scope="module")
def procs():
    return {
        "ref": kmeans_tpu.ImageProcessor(),
        "port": kt.ImageProcessor(device="cpu"),
        "bucketed": kt.ImageProcessor(device="cpu", bucketing=True),
    }


# The reference's find_streamed case (tests/test_bucketing.py:486): a 70x53
# noise image and 5 colours (k bucket 8).
FIND_RNG = np.random.default_rng(41)
FIND_IMAGE = FIND_RNG.integers(0, 256, (53, 70, 4), dtype=np.uint8)
FIND_COLORS = FIND_RNG.integers(0, 256, (5, 4), dtype=np.uint8)
FIND_COLORS[:, 3] = 255


@pytest.mark.parametrize("band", [8, 17, 64])
@pytest.mark.parametrize("mode", MODES)
def test_find_streamed_matches_reference_and_bucketed_find(procs, mode, band):
    got = procs["port"].find_streamed(FIND_IMAGE, FIND_COLORS, kt.ReduceMode[mode],
                                      band_rows=band).pixels
    want = procs["ref"].find_streamed(_ref_image(FIND_IMAGE), FIND_COLORS,
                                      kmeans_tpu.ReduceMode[mode], band_rows=band).pixels
    whole = procs["bucketed"].find(FIND_IMAGE, FIND_COLORS, kt.ReduceMode[mode]).pixels
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, whole)


def test_find_streamed_past_1024_colours(procs):
    """Past `INDEXED_MAX_K` each band is one RGBA pass (`quantize_rgba`),
    its dither rows offset by the band's first row: a band of 9 rows starts
    off the Bayer period."""
    colors = np.random.default_rng(3).integers(0, 256, (1100, 4), dtype=np.uint8)
    colors[:, 3] = 255
    got = procs["port"].find_streamed(FIND_IMAGE, colors, kt.ReduceMode.DITHER,
                                      band_rows=9).pixels
    np.testing.assert_array_equal(
        got, procs["bucketed"].find(FIND_IMAGE, colors, kt.ReduceMode.DITHER).pixels)
    want = procs["ref"].find_streamed(_ref_image(FIND_IMAGE), colors,
                                      kmeans_tpu.ReduceMode.DITHER, band_rows=9).pixels
    np.testing.assert_array_equal(got, want)


# tests/test_bucketing.py:342: 60x37, no training shrink.
SMALL = _gradient(37, 60, 5)


@pytest.mark.parametrize("mode", MODES)
def test_reduce_streamed_without_shrink_matches_reference(procs, mode):
    """Within the cap the strip is the image: the streamed output equals
    the bucketed `reduce` (dither included: the band offsets) and the
    reference's, bit for bit."""
    got = procs["port"].reduce_streamed(3, SMALL, kt.ReduceMode[mode], band_rows=8).pixels
    want = procs["ref"].reduce_streamed(3, _ref_image(SMALL), kmeans_tpu.ReduceMode[mode],
                                        band_rows=8).pixels
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, procs["bucketed"].reduce(3, SMALL, reduce_mode=kt.ReduceMode[mode]).pixels)


# Images past the 256-px cap: the reference's 300x150 blocks
# (tests/test_bucketing.py:356), a gradient of that size, and a tall
# 100x300 gradient (w < cap: the band's canvas is wider than the band).
SHRUNK = {
    "blocks": _blocks(150, 300, 12, [[215, 45, 45], [45, 195, 65], [55, 65, 215]], 10),
    "gradient": _gradient(150, 300, 13),
    "tall": _gradient(300, 100, 14),
}


@pytest.mark.parametrize("name", sorted(SHRUNK))
def test_reduce_streamed_with_shrink_matches_reference(procs, name):
    img = SHRUNK[name]
    got = procs["port"].reduce_streamed(3, img, band_rows=64).pixels
    want = procs["ref"].reduce_streamed(3, _ref_image(img), band_rows=64).pixels
    palette = np.unique(got.reshape(-1, 4), axis=0)
    np.testing.assert_array_equal(palette, np.unique(want.reshape(-1, 4), axis=0))
    assert len(palette) <= 3
    assert (got == want).all(-1).mean() >= 0.9999


def test_palette_streamed_matches_reference(procs):
    """tests/test_bucketing.py:512 (no shrink, bands of 16), and the
    shrunk gradient in bands of 64."""
    img = _blocks(60, 80, 47, [[230, 40, 40], [40, 220, 60], [60, 60, 230],
                               [230, 220, 70]], 1)
    got = procs["port"].palette_streamed(4, img, band_rows=16)
    np.testing.assert_array_equal(got, procs["ref"].palette_streamed(4, _ref_image(img),
                                                                     band_rows=16))
    np.testing.assert_array_equal(got, procs["bucketed"].palette(4, img))
    img = SHRUNK["gradient"]
    np.testing.assert_array_equal(
        procs["port"].palette_streamed(3, img, band_rows=64),
        procs["ref"].palette_streamed(3, _ref_image(img), band_rows=64))


@pytest.mark.parametrize("h,w,sw", [(64, 300, 256), (22, 300, 256), (64, 100, 85)])
def test_band_shrink_identical_bytes(h, w, sw, monkeypatch):
    """One band of `SHRUNK`'s shapes (its training width `sw`), padded to
    its bucket, shrunk along its columns only: the port's
    `resize_to_canvas` with the reference's canvas `(bucket rows, 256)`
    gives all of its bytes, and `shrink_columns` (in chunks of a few rows
    here) its `[h, sw]` crop. At w = 100 the canvas is wider than the
    padded band (112 columns)."""
    cap = 256
    band = _gradient(h, w, 20 + h)[..., :3]
    bh, bw = bucket_shape(h, w)
    padded = np.zeros((bh, bw, 3), np.uint8)
    padded[:h, :w] = band
    want = np.asarray(ref_canvas_shrink(padded, (bh, cap), h, w, h, sw))
    canvas, _ = resize.resize_to_canvas(torch.from_numpy(padded), bh, cap, h, w, h, sw)
    assert int((canvas.numpy() != want).sum()) == 0
    monkeypatch.setattr(resize, "_COLUMN_CHUNK_PIXELS", 7 * w)
    got = resize.shrink_columns(torch.from_numpy(padded), h, w, sw)
    assert got.shape == (h, sw, 3)
    assert int((got.numpy() != want[:h, :sw]).sum()) == 0


@pytest.mark.parametrize("bucketing", [False, True])
def test_reduce_pipelined_matches_reduce(bucketing):
    """Six images of three sizes, past the window of 4: each output is the
    processor's own `reduce` of the image (tests/test_api.py:140, :190)."""
    port = kt.ImageProcessor(device="cpu", bucketing=bucketing)
    frames = [_gradient(40, 50, 1), _gradient(33, 21, 2), _gradient(48, 64, 3)] * 2
    for mode in (kt.ReduceMode.REPLACE, kt.ReduceMode.DITHER):
        outs = port.reduce_pipelined(frames, 3, mode)
        assert len(outs) == len(frames)
        for out, frame in zip(outs, frames):
            assert out.dimensions == (frame.shape[1], frame.shape[0])
            np.testing.assert_array_equal(out.pixels,
                                          port.reduce(3, frame, reduce_mode=mode).pixels)
    assert port.reduce_pipelined([], 3) == []


@pytest.mark.parametrize("method", ["reduce_streamed", "palette_streamed"])
def test_streamed_training_needs_a_cap(method):
    """tests/test_bucketing.py:383: the strip is assembled at the training
    width, so `train_max_size=None` raises, in both packages."""
    img = _gradient(20, 20, 0)
    for proc, image in ((kt.ImageProcessor(device="cpu", train_max_size=None), img),
                        (kmeans_tpu.ImageProcessor(bucketing=True, train_max_size=None),
                         _ref_image(img))):
        with pytest.raises(ValueError, match="train_max_size"):
            getattr(proc, method)(3, image)


def test_find_streamed_empty_palette_raises(procs):
    img = np.zeros((4, 4, 4), np.uint8)
    for proc, image in ((procs["port"], img), (procs["ref"], _ref_image(img))):
        with pytest.raises(ValueError, match="at least one color"):
            proc.find_streamed(image, np.zeros((0, 4), np.uint8))


@pytest.mark.parametrize("band", [1, 3])
def test_band_rows_below_4_clamped(procs, band):
    got = procs["port"].find_streamed(FIND_IMAGE, FIND_COLORS, kt.ReduceMode.DITHER,
                                      band_rows=band).pixels
    np.testing.assert_array_equal(
        got, procs["port"].find_streamed(FIND_IMAGE, FIND_COLORS, kt.ReduceMode.DITHER,
                                         band_rows=4).pixels)
    np.testing.assert_array_equal(
        got, procs["ref"].find_streamed(_ref_image(FIND_IMAGE), FIND_COLORS,
                                        kmeans_tpu.ReduceMode.DITHER, band_rows=band).pixels)
    with pytest.raises(ValueError):
        procs["port"].reduce_streamed(0, SMALL)
