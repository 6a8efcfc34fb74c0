"""PyTorch port vs the JAX package: the native readback unpacks and the
alpha strip.

The cases of the reference's `tests/test_packing.py` against the port's
runtime (`kmeans_tpu_torch/runtime/`): `unpack_rgb24_tile_words` and
`unpack_tile_words_gather` (the native one-pass walks) give the bytes of
the port's numpy twins (`_unpack_rgb24_np`, `_unpack_tile_words_gather_np`)
and of the reference's numpy functions, at 2, 4, 8 and 16 bits, with
`tile_rows` from `quant_tile_rows` and ragged `h * w`; an index past the
palette and words that do not tile raise; the outputs are writable and
land in the caller's array when one is given; `api._host_rgb`'s native
strip equals the numpy slice and leaves other input to it, and the frame
batches' stack (`_stack_rgb`) strips each frame into its slot. Then `reduce` in
three modes, `reduce_streamed` (each band unpacking straight into its rows
of the output, or cropped from its bucket) and `reduce_pipelined` give
equal pixels with the native paths and with the numpy twins in their
place.
"""

import numpy as np
import pytest
import torch

import kmeans_tpu_torch as kt
from kmeans_tpu.utils import packing as ref_packing
from kmeans_tpu_torch import api, runtime
from kmeans_tpu_torch.ops.kernels import quant_tile_rows
from kmeans_tpu_torch.utils import packing

torch.set_num_threads(2)

LANES = 128


def _rgb24_words(h, w, tile_rows, seed):
    rng = np.random.default_rng(seed)
    n_tiles = -(-(h * w) // (tile_rows * LANES))
    return rng.integers(-(2**31), 2**31, (n_tiles * 3 * (tile_rows // 4), LANES),
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize(
    "h,w,k", [(16, 24, 8), (33, 77, 17), (100, 130, 4), (128, 128, 300), (1, 1, 1)]
)
def test_unpack_rgb24_native_matches_numpy(h, w, k):
    tile_rows = quant_tile_rows(k)
    words = _rgb24_words(h, w, tile_rows, h * 1000 + w)
    want = packing._unpack_rgb24_np(words, h, w, tile_rows)
    np.testing.assert_array_equal(want, ref_packing._unpack_rgb24_np(words, h, w, tile_rows))
    got = packing.unpack_rgb24_tile_words(words, h, w, tile_rows)
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,k", [(2, 4), (4, 16), (8, 256), (16, 512), (8, 17), (16, 300)])
@pytest.mark.parametrize("h,w", [(45, 61), (128, 130)])
def test_unpack_gather_native_matches_numpy(bits, k, h, w):
    """`k` below `2**bits` takes the native walk's checked path, `k` at
    `2**bits` its unchecked one."""
    rng = np.random.default_rng(bits * 100 + h + k)
    tile_rows = quant_tile_rows(k)
    ppw = 32 // bits
    blk = tile_rows // ppw
    n_tiles = -(-(h * w) // (tile_rows * LANES))
    acc = np.zeros((n_tiles * blk, LANES), np.uint32)
    for s in range(ppw):
        acc |= rng.integers(0, k, (n_tiles * blk, LANES), dtype=np.uint32) << np.uint32(bits * s)
    words = acc.view(np.int32)
    pal = rng.integers(0, 256, (k, 4), dtype=np.uint8)
    want = packing._unpack_tile_words_gather_np(words, h, w, bits, pal, tile_rows)
    ref_idx = ref_packing.unpack_tile_words(words, h, w, bits, tile_rows=tile_rows)
    np.testing.assert_array_equal(want, pal[ref_idx])
    got = packing.unpack_tile_words_gather(words, h, w, bits, pal, tile_rows)
    np.testing.assert_array_equal(got, want)


def test_unpack_gather_rejects_out_of_range_index():
    """An index past the palette raises (numpy's twin: IndexError)."""
    tile_rows, bits = 256, 8
    blk = tile_rows // (32 // bits)
    words = np.full((blk, LANES), 0x05050505, np.int32)  # index 5 everywhere
    pal = np.zeros((4, 4), np.uint8)
    with pytest.raises(ValueError, match="index 5 out of range for 4-color palette"):
        packing.unpack_tile_words_gather(words, 10, 10, bits, pal, tile_rows)
    with pytest.raises(IndexError):
        packing._unpack_tile_words_gather_np(words, 10, 10, bits, pal, tile_rows)
    with pytest.raises(ValueError, match="bits must be"):
        runtime.unpack_indices_gather(words, 10, 10, 3, tile_rows, LANES, pal)


def test_unpack_rejects_bad_lengths():
    with pytest.raises(ValueError, match="does not tile"):
        packing.unpack_rgb24_tile_words(np.zeros((7, LANES), np.int32), 10, 10, 256)
    with pytest.raises(ValueError, match="too short"):
        packing.unpack_rgb24_tile_words(np.zeros((192, LANES), np.int32), 300, 300, 256)
    with pytest.raises(ValueError, match="too short"):
        packing.unpack_tile_words_gather(np.zeros((64, LANES), np.int32), 300, 300, 8,
                                         np.zeros((4, 4), np.uint8), 256)
    with pytest.raises(ValueError, match="4 \\* n"):
        runtime.strip_alpha(np.zeros(7, np.uint8))
    with pytest.raises(ValueError, match="out holds"):
        packing.unpack_rgb24_tile_words(np.zeros((192, LANES), np.int32), 10, 10, 256,
                                        out=np.empty((5, 10, 4), np.uint8))


def test_native_unpack_results_are_writable_and_fill_out():
    tile_rows = 256
    words = _rgb24_words(10, 10, tile_rows, 3)
    out = packing.unpack_rgb24_tile_words(words, 10, 10, tile_rows)
    assert out.flags.writeable
    out[..., 3] = 128  # must not raise
    blk = tile_rows // 4
    pal = np.arange(16, dtype=np.uint8).reshape(4, 4)
    got = packing.unpack_tile_words_gather(np.zeros((blk, LANES), np.int32), 10, 10, 8, pal,
                                           tile_rows)
    assert got.flags.writeable
    got[..., 3] = 128
    # `out=`: the rows of a larger array, written in place.
    dest = np.zeros((12, 10, 4), np.uint8)
    res = packing.unpack_rgb24_tile_words(words, 6, 10, tile_rows, out=dest[3:9])
    assert np.shares_memory(res, dest)
    np.testing.assert_array_equal(dest[3:9], packing._unpack_rgb24_np(words, 6, 10, tile_rows))
    assert not dest[:3].any() and not dest[9:].any()
    with pytest.raises(ValueError, match="writable C-contiguous"):
        packing.unpack_rgb24_tile_words(words, 6, 10, tile_rows, out=dest[:, :5])


def test_strip_alpha_native_matches_numpy():
    """`api._host_rgb` is byte-equal to the numpy slice (and to the
    reference's `_host_rgb`, its numpy path here) on contiguous RGBA8 input,
    and takes the numpy path for other input."""
    from kmeans_tpu.api import _host_rgb as ref_host_rgb

    rng = np.random.default_rng(7)
    for shape in [(33, 17, 4), (4, 5, 6, 4), (1, 1, 4), (128, 128, 4)]:
        rgba = rng.integers(0, 256, shape, np.uint8)
        want = np.ascontiguousarray(rgba[..., :3])
        got = api._host_rgb(rgba)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_host_rgb(rgba))
        np.testing.assert_array_equal(runtime.strip_alpha(rgba), want)
        got[(0,) * (got.ndim - 1) + (0,)] = 9  # writable
    rgba = rng.integers(0, 256, (40, 30, 4), np.uint8)
    sub = rgba[3:29, 5:21]
    np.testing.assert_array_equal(api._host_rgb(sub), np.ascontiguousarray(sub[..., :3]))
    rgb = np.ascontiguousarray(rgba[..., :3])
    np.testing.assert_array_equal(api._host_rgb(rgb), rgb)
    # Frames stack through the strip, each into its slot; rows past the
    # height are zero; a non-contiguous frame takes the numpy path.
    frames = [kt.Image((30, 40), rng.integers(0, 256, (40, 30, 4), np.uint8)),
              kt.Image((30, 40), rgba[:, ::-1])]
    stack = api._stack_rgb(frames, 44)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(stack[i, :40], f.pixels[..., :3])
    assert not stack[:, 40:].any()


def _numpy_twins(mp):
    """Put the numpy twins in the native paths' places."""
    mp.setattr(api, "unpack_tile_words_gather",
               lambda words, h, w, bits, pal, tile_rows, out=None: _into(
                   packing._unpack_tile_words_gather_np(words, h, w, bits, pal, tile_rows), out))
    mp.setattr(api, "unpack_rgb24_tile_words",
               lambda words, h, w, tile_rows, out=None: _into(
                   packing._unpack_rgb24_np(words, h, w, tile_rows), out))
    mp.setattr(api, "_host_rgb", lambda px: np.ascontiguousarray(np.asarray(px)[..., :3]))


def _into(arr, out):
    if out is None:
        return arr
    out[...] = arr
    return out


def test_entry_points_equal_with_native_on_and_off(monkeypatch):
    """`reduce` (replace, dither, meld), `find` past 16 colours, the
    streamed `reduce` and `reduce_pipelined` give the same pixels through
    the native strip and unpacks as through the numpy twins."""
    rng = np.random.default_rng(11)
    img = kt.Image((70, 45), rng.integers(0, 256, (45, 70, 4), dtype=np.uint8))
    img.pixels[..., 3] = 255
    # 320 wide is its own width bucket: each band unpacks straight into its
    # rows of the output; 300 pads to 320 and crops.
    big = kt.Image((320, 150), rng.integers(0, 256, (150, 320, 4), dtype=np.uint8))
    ragged = kt.Image((300, 150), big.pixels[:, :300].copy())
    colors = rng.integers(0, 256, (20, 4), dtype=np.uint8)

    def run():
        proc = kt.ImageProcessor(device="cpu")
        outs = [proc.reduce(5, img, reduce_mode=kt.ReduceMode(m)).pixels
                for m in ("replace", "dither", "meld")]
        outs.append(proc.find(img, colors, kt.ReduceMode.DITHER).pixels)
        outs += [proc.reduce_streamed(6, big, kt.ReduceMode(m), band_rows=64).pixels
                 for m in ("dither", "meld")]
        outs.append(proc.reduce_streamed(6, ragged, band_rows=64).pixels)
        outs += [o.pixels for o in proc.reduce_pipelined([img, big], 4)]
        return outs

    native = run()
    with monkeypatch.context() as mp:
        _numpy_twins(mp)
        twins = run()
    assert len(native) == len(twins) == 9
    for a, b in zip(native, twins):
        np.testing.assert_array_equal(a, b)
