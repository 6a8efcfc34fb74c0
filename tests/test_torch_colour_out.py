"""PyTorch port vs the JAX package: the colour-out and u8-index modes of
the assign pass, and `reduce` / `find` past 1024 colours.

The same numpy-seeded inputs go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU). Bars:

- `packed_palette` against the reference's `_packed_palette`: equal words.
- `quantize_rgba_reference` against `fused_quantize(..., interpret=True)`
  and `assign_u8_reference` against `fused_assign(..., interpret=True)`,
  ragged 24x37 images: equal words, flips counted (none expected: the
  twins are the packed-index twin's argmin, held to the reference in
  tests/test_torch_kernels.py, followed by a gather).
- Past 1024 colours, where the reference splits its kernel into halves
  (`fused_quantize_halves`) and its CPU route is the XLA
  `quantize_image`: the port's single pass against `quantize_image` on
  16x16 images, equal pixels; `ImageProcessor.find` against the
  reference processor: equal pixels; `reduce`: see its test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.ops import kernels as ref_k
from kmeans_tpu.ops import quantize as ref_q
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.quantize import dither_threshold as ref_threshold
from kmeans_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _case(h, w, k, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))
    return rgb, pal


def _rgba(rgb):
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def _threshold(pal, mode, metric):
    return float(ref_threshold(jnp.asarray(pal), None, metric)) if mode == "dither" else 0.0


def test_packed_palette_matches_reference():
    _, pal = _case(1, 1, 300, seed=1)
    want = np.asarray(ref_k._packed_palette(jnp.asarray(pal)))
    got = kernels.packed_palette(torch.from_numpy(pal)).numpy()
    assert got.dtype == np.int32 and got.shape == (300,)
    np.testing.assert_array_equal(got, want)
    # [B, kp, 3] palettes give [B, kp] words, each row its palette's.
    both = kernels.packed_palette(torch.from_numpy(np.stack([pal, pal[::-1].copy()]))).numpy()
    np.testing.assert_array_equal(both, np.stack([want, want[::-1]]))


@pytest.mark.parametrize(
    "k,mode,metric",
    [(1, "replace", "cie94"), (8, "dither", "cie94"), (17, "dither", "cie2000"),
     (257, "replace", "cie94")],
)
def test_colour_out_twin_matches_pallas_kernel(k, mode, metric):
    rgb, pal = _case(24, 37, k, seed=10 + k)
    thr = _threshold(pal, mode, metric)
    want = np.asarray(ref_k.fused_quantize(
        jnp.asarray(_rgba(rgb)), jnp.asarray(pal), thr, k_active=k, mode=mode, row_offset=2,
        metric=metric, interpret=True))
    got = kernels.quantize_rgba_reference(
        torch.from_numpy(rgb), torch.from_numpy(pal), thr, mode=mode, row_offset=2,
        metric=metric).numpy()
    assert got.shape == want.shape == (24, 37, 4) and got.dtype == np.uint8
    differ = int((got != want).any(-1).sum())
    print(f"colour out k={k} {mode} {metric}: {differ} of {24 * 37} pixels differ")
    assert differ == 0


@pytest.mark.parametrize("k,mode,metric,k_active",
                         [(8, "dither", "cie94", 5), (17, "replace", "cie2000", None)])
def test_u8_index_twin_matches_pallas_kernel(k, mode, metric, k_active):
    rgb, pal = _case(24, 37, k, seed=20 + k)
    thr = (float(ref_threshold(jnp.asarray(pal), k_active, metric)) if mode == "dither"
           else 0.0)
    want = np.asarray(ref_k.fused_assign(
        jnp.asarray(_rgba(rgb)), jnp.asarray(pal), thr,
        k_active=k if k_active is None else k_active, mode=mode, metric=metric,
        interpret=True))
    got = kernels.assign_u8_reference(torch.from_numpy(rgb), torch.from_numpy(pal), thr,
                                      k_active, mode, metric=metric).numpy()
    assert got.shape == want.shape == (24, 37) and got.dtype == np.uint8
    flips = int((got != want).sum())
    print(f"u8 index k={k} {mode} {metric}: {flips} flipped of {24 * 37}")
    assert flips == 0


@pytest.mark.parametrize("k,mode,metric",
                         [(1025, "replace", "cie94"), (1025, "dither", "cie94"),
                          (2048, "dither", "cie94")])
def test_colour_out_past_1024_matches_reference(k, mode, metric):
    """One pass at any k against the reference's CPU route (its kernel
    route splits the palette into 1024-entry halves and merges). CIE94
    only: the XLA compile of the reference's CIEDE2000 pass at k = 1025
    costs 15 s here, and the metric is the one the k <= 257 cases above
    and the card tests (past one chunk of staged centroids) cover."""
    rgb, pal = _case(16, 16, k, seed=30 + k)
    thr = _threshold(pal, mode, metric)
    want = np.asarray(ref_q.quantize_image(jnp.asarray(_rgba(rgb)), jnp.asarray(pal),
                                           mode=mode, metric=metric))
    got = kernels.quantize_rgba(torch.from_numpy(rgb), torch.from_numpy(pal), thr, mode=mode,
                                metric=metric).numpy()
    differ = int((got != want).any(-1).sum())
    print(f"quantize_rgba k={k} {mode} {metric}: {differ} of 256 pixels differ")
    assert differ == 0


def _image(h, w, seed):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER"])
def test_reduce_past_1024_colours_matches_reference(mode):
    """`reduce(1025)` trains on every pixel of a 40x40 image (1,600 pixels,
    no shrink) and recolours through the colour-out pass, whose output is
    the port's plain `quantize_image` on the trained centroids, pixel for
    pixel. Against the reference: the training is the shrunk trainer of
    `reduce(8)` at a k near the pixel count, where the farthest-point
    seeding meets near-ties and an ulp moves a pick, so palette rows and
    pixels that differ are counted (3 of 1025 rows, 2 of 1,600 pixels
    here) and each held under 1%."""
    from kmeans_tpu_torch.ops.quantize import quantize_image

    ref, port = kmeans_tpu.ImageProcessor(), kt.ImageProcessor(device="cpu")
    img = _image(40, 40, seed=40)
    got = port.reduce(1025, img, reduce_mode=getattr(kt.ReduceMode, mode)).pixels
    cents = port.extract_palette_kmeans(kt.Image((40, 40), img), 1025)
    plain = quantize_image(torch.from_numpy(img), cents, mode.lower()).numpy()
    assert got.shape == (40, 40, 4) and (got[..., 3] == 255).all()
    np.testing.assert_array_equal(got, plain)
    want = ref.reduce(1025, img, reduce_mode=getattr(kmeans_tpu.ReduceMode, mode)).pixels
    differ = int((got != want).any(-1).sum())
    ref_cents = ref.extract_palette_kmeans(kmeans_tpu.Image((40, 40), img), 1025)
    rows = int((kt.api._lab_palette_to_u8(cents)[0].numpy()
                != np.asarray(kmeans_tpu.api._lab_palette_to_u8(ref_cents)[0])).any(-1).sum())
    print(f"reduce(1025) {mode}: {rows} of 1025 palette rows and {differ} of 1600 pixels "
          "differ from the reference's")
    assert rows <= 1025 // 100 and differ <= 1600 // 100


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER"])
def test_find_past_1024_colours_matches_reference(mode):
    ref, port = kmeans_tpu.ImageProcessor(), kt.ImageProcessor(device="cpu")
    img = _image(16, 16, seed=41)
    colors = np.random.default_rng(42).integers(0, 256, (2048, 3), dtype=np.uint8)
    want = ref.find(img, colors, getattr(kmeans_tpu.ReduceMode, mode)).pixels
    got = port.find(img, colors, getattr(kt.ReduceMode, mode)).pixels
    np.testing.assert_array_equal(got, want)


def test_wrapper_rules():
    rgb, pal = _case(8, 8, 300, seed=50)
    t_rgb, cents = torch.from_numpy(rgb), torch.from_numpy(pal)
    kernels.LAUNCHES_BY_MODE.clear()
    assert torch.equal(kernels.quantize_rgba(t_rgb, cents, 0.0, 200),
                       kernels.quantize_rgba_reference(t_rgb, cents, 0.0, 200))
    assert kernels.launches("quantize_rgba") == kernels.launches("assign_u8") == 0
    with pytest.raises(ValueError, match="k <= 256"):
        kernels.assign_u8(t_rgb, cents, 0.0)
    with pytest.raises(ValueError, match="meld"):
        kernels.quantize_rgba(t_rgb, cents, 0.0, mode="meld")
    with pytest.raises(ValueError, match="k_active"):
        kernels.quantize_rgba(t_rgb, cents, 0.0, k_active=301)
