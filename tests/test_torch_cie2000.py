"""PyTorch port vs the JAX package: CIEDE2000 (`delta_e="2000"`).

The same numpy-seeded inputs go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU). Tolerances:

- `distance_cie2000_sq` against the reference's XLA form: relative
  difference <= 1e-5 (the two libraries' `atan2`, `sin`, `cos` and `exp`
  differ by an ulp here and there); the bit-equal pairs are counted.
- The assign twin against the Pallas kernel in interpret mode, which takes
  its hue from a polynomial atan2 (max error 1.4e-7 rad): flipped indices
  are counted, at most 1e-3 of the pixels, and each must be a near-tie,
  the two reference distances within 1e-5 of each other (relative).
- The accumulator twin against the Pallas kernel: counts equal except for
  pixels whose two nearest centroids are near-ties; sums within
  `1e-5 * (|want| + 128 * count)` plus 128 per moved pixel.
- The API against the reference processor: palettes within 1 u8 per
  channel (the differing entries are counted); replace and dither pixels
  at least 99.99% equal once the palettes are equal, else within 1 u8;
  meld pixels within 1 u8 on at least 99.9% of the pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.ops import delta_e as ref_de
from kmeans_tpu.ops import kernels as ref_k
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.quantize import BAYER_4X4
from kmeans_tpu.ops.quantize import dither_threshold as ref_threshold
from kmeans_tpu_torch import api
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops import delta_e as de
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.quantize import dither_threshold
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words

torch.set_num_threads(2)


def _polar(rng, n, hue_deg, chroma):
    l = rng.uniform(0, 100, n)
    h = np.deg2rad(hue_deg)
    return np.stack([l, chroma * np.cos(h), chroma * np.sin(h)], -1).astype(np.float32)


def _pairs():
    """10,000 random Lab pairs, grey pairs (a = b = 0: the hue guard), and
    hue-wrap pairs (hues across 0/360 degrees and |dh| > 180)."""
    rng = np.random.default_rng(0)
    x = rng.uniform([0, -110, -110], [100, 110, 110], (10000, 3)).astype(np.float32)
    y = rng.uniform([0, -110, -110], [100, 110, 110], (10000, 3)).astype(np.float32)
    grey = rng.uniform([0, 0, 0], [100, 0, 0], (200, 3)).astype(np.float32)
    hues = rng.uniform(0, 360, 500)
    xs = [x, grey, grey,
          _polar(rng, 500, rng.uniform(-10, 10, 500), rng.uniform(1, 80, 500)),
          _polar(rng, 500, hues, rng.uniform(1, 80, 500))]
    ys = [y, grey[::-1], y[:200],
          _polar(rng, 500, rng.uniform(-10, 10, 500), rng.uniform(1, 80, 500)),
          _polar(rng, 500, hues + 180 + rng.uniform(-20, 20, 500), rng.uniform(1, 80, 500))]
    return np.concatenate(xs), np.concatenate(ys)


def test_distance_cie2000_matches_reference():
    x, y = _pairs()
    want = np.asarray(ref_de.distance_cie2000_sq(jnp.asarray(x), jnp.asarray(y)))
    got = de.distance_cie2000_sq(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    equal = int((got == want).sum())
    print(f"distance_cie2000_sq: {equal} of {len(x)} pairs bit-equal")
    assert (np.abs(got - want) <= 1e-5 * np.abs(want)).all()
    # The square root of the squared form, and broadcasting to a matrix.
    d = de.distance_cie2000(torch.from_numpy(x[:50, None]), torch.from_numpy(y[None, :7]))
    assert d.shape == (50, 7)
    flat = de.distance_cie2000(torch.from_numpy(np.repeat(x[:50], 7, 0)),
                               torch.from_numpy(np.tile(y[:7], (50, 1))))
    assert torch.equal(d.reshape(-1), flat)
    np.testing.assert_allclose(d[:, 0].numpy() ** 2, de.distance_cie2000_sq(
        torch.from_numpy(x[:50]), torch.from_numpy(y[:1])).numpy(), rtol=1e-5)


def test_cie2000_golden():
    """The reference's golden scalars (tests/test_delta_e.py): Sharma's
    pair 2.0424595 and d(lab(255, 0, 0), lab(255, 128, 0)) = 21.164806,
    within 1e-3 (the reference's test allows 1e-2); the JAX package's
    values on random pairs are held in the test above."""
    sharma = de.distance_cie2000(torch.tensor([50.0, 2.6772, -79.7751]),
                                 torch.tensor([50.0, 0.0, -82.7485]))
    lab = srgb8_to_lab(torch.tensor([[255, 0, 0], [255, 128, 0]], dtype=torch.uint8))
    assert abs(float(sharma) - 2.0424595) < 1e-3
    assert abs(float(de.distance_cie2000(lab[0], lab[1])) - 21.164806) < 1e-3
    assert float(de.distance_cie2000(lab[0], lab[0])) == 0.0


def _case(h, w, k, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))
    return rgb, pal


def _near_tie(lab, pal, i, j):
    """Whether the reference's CIEDE2000 distances from `lab` to palette
    entries `i` and `j` are within 1e-5 of each other (relative)."""
    di = np.asarray(ref_de.distance_cie2000_sq(jnp.asarray(lab), jnp.asarray(pal[i])))
    dj = np.asarray(ref_de.distance_cie2000_sq(jnp.asarray(lab), jnp.asarray(pal[j])))
    return np.abs(di - dj) <= 1e-5 * np.maximum(di, dj)


@pytest.mark.parametrize(
    "h,w,k,mode,k_active",
    [(61, 97, 5, "replace", None), (37, 53, 17, "dither", 11)],
)
def test_assign_twin_matches_pallas_kernel(h, w, k, mode, k_active):
    rgb, pal = _case(h, w, k, seed=50 + k)
    rgba = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    thr = (float(ref_threshold(jnp.asarray(pal), k_active, "cie2000"))
           if mode == "dither" else 0.0)
    want = np.asarray(ref_k.fused_assign_packed(
        jnp.asarray(rgba), jnp.asarray(pal), thr, k_active=k_active, mode=mode,
        metric="cie2000", interpret=True,
    ))
    got = kernels.assign_packed_reference(
        torch.from_numpy(rgb), torch.from_numpy(pal.copy()), thr, k_active, mode,
        metric="cie2000",
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    n_pad = want.size * (32 // bits)
    gi = unpack_tile_words(got, 1, n_pad, bits, rows).reshape(-1)
    wi = unpack_tile_words(want, 1, n_pad, bits, rows).reshape(-1)
    flips = np.flatnonzero(gi != wi)
    print(f"{h}x{w} k={k} {mode} cie2000: {len(flips)} flipped of {n_pad} indices")
    assert len(flips) <= int(1e-3 * h * w)
    if len(flips):
        flat = np.zeros((n_pad, 3), np.uint8)
        flat[: h * w] = rgb.reshape(-1, 3)
        lab = np.asarray(ref_lab(jnp.asarray(flat)))
        if mode == "dither":
            p = np.arange(n_pad)
            m = np.asarray(BAYER_4X4, np.float32) / np.float32(16.0) - np.float32(0.5)
            lab = lab + (np.float32(thr) * m[(p // w) % 4, p % w % 4])[:, None]
        assert _near_tie(lab[flips], pal, gi[flips], wi[flips]).all()


def test_accumulator_twin_matches_pallas_kernel():
    """One interpret-mode launch (the Pallas CIEDE2000 accumulator is
    unrolled over k, which makes it slow here): 5000 pixels, kp = 5 with
    k_active = 4, the inertia column and a duplicate centroid."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (5000, 3), dtype=np.uint8)
    lab = np.array(ref_lab(jnp.asarray(rgb)))
    cents = lab[rng.choice(5000, 5, replace=False)].copy()
    cents[3] = cents[0]
    ref_planes, n = ref_k.pack_lab_planes(jnp.asarray(lab))
    want = np.asarray(ref_k.lloyd_accumulate(
        ref_planes, jnp.asarray(cents), n, k_active=4, metric="cie2000",
        emit_inertia=True, interpret=True,
    ), np.float64)
    planes, n_port = kernels.pack_lab_planes(torch.from_numpy(lab))
    got = kernels.lloyd_accumulate_reference(
        planes, torch.from_numpy(cents), n_port, k_active=4, metric="cie2000",
        emit_inertia=True,
    ).numpy().astype(np.float64)
    assert got.shape == want.shape == (5, 5) and not got[3:].any()
    # Pixels whose two nearest distinct centroids are near-ties may flip
    # (the duplicate loses every exact tie in both, to the first index).
    d = de.distance_cie2000_sq(torch.from_numpy(lab)[:, None], torch.from_numpy(cents[:3])).numpy()
    d.sort(axis=-1)
    near = int((d[:, 1] - d[:, 0] <= 1e-5 * d[:, 1]).sum())
    moved = np.abs(got[:, 3] - want[:, 3]).sum()
    print(f"accumulator cie2000: {moved / 2} pixels moved, {near} near-ties")
    assert moved <= 2 * near
    bound = 1e-5 * (np.abs(want) + 128.0 * want[:, 3:4]) + 128.0 * moved
    assert (np.abs(got - want) <= bound).all()


def test_cpu_wrappers_run_the_twins():
    kernels.LAUNCHES_BY_MODE.clear()
    rgb, pal = _case(16, 16, 5, seed=3)
    cents = torch.from_numpy(pal.copy())
    thr = dither_threshold(cents, metric="cie2000")
    got = kernels.assign_packed(torch.from_numpy(rgb), cents, thr, mode="dither", metric="cie2000")
    want = kernels.assign_packed_reference(torch.from_numpy(rgb), cents, thr, mode="dither",
                                           metric="cie2000")
    assert torch.equal(got, want)
    planes, n = kernels.pack_lab_planes(srgb8_to_lab(torch.from_numpy(rgb.reshape(-1, 3))))
    totals = kernels.lloyd_accumulate(planes, cents, n, metric="cie2000")
    assert float(totals[:, 3].sum()) == n
    assert kernels.launches("assign_packed") == kernels.launches("lloyd_accumulate") == 0


def _image(h, w, seed):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def _palettes_close(got, want, what):
    step = np.abs(got.astype(int) - want.astype(int))
    print(f"{what}: {int((step > 0).any(-1).sum())} of {len(want)} palette entries differ")
    assert got.shape == want.shape and step.max() <= 1
    return (step == 0).all()


def _pixels_close(got, want, same_palette, what, meld=False):
    h, w = want.shape[:2]
    step = np.abs(got.astype(int) - want.astype(int)).max(-1)
    differ = int((step > 0).sum())
    print(f"{what}: {differ} of {h * w} pixels differ, max step {step.max()}")
    if meld:
        assert (step <= 1).all() and differ <= h * w // 1000
    elif same_palette:
        assert differ <= h * w // 10000
    else:
        assert (step <= 1).all()


H, W = 90, 120


@pytest.fixture(scope="module")
def processors():
    return (kmeans_tpu.ImageProcessor(delta_e="2000"),
            kt.ImageProcessor(device="cpu", delta_e="2000"))


def test_palette_and_reduce_match_reference(processors):
    """One shrunk-training palette under CIEDE2000, then replace, dither
    and meld with it, against the reference processor's."""
    ref, port = processors
    img = _image(H, W, seed=31)
    same = _palettes_close(port.palette(8, img), ref.palette(8, img), "palette k=8")
    for mode in ("REPLACE", "DITHER", "MELD"):
        want = ref.reduce(8, img, reduce_mode=getattr(kmeans_tpu.ReduceMode, mode)).pixels
        got = port.reduce(8, img, reduce_mode=getattr(kt.ReduceMode, mode)).pixels
        assert (got[..., 3] == 255).all()
        _pixels_close(got, want, same, f"reduce k=8 {mode} cie2000", meld=mode == "MELD")


def test_full_resolution_reduce_matches_reference(processors, monkeypatch):
    """`train_max_size=None` with the port's 1M-pixel gate lowered, so the
    port trains on the accumulator twin (one pass per Lloyd step) where
    the reference's CPU processor takes its one-hot trainer: the same
    algorithm with sums in another order. The image is below the 256-px
    shrink, so the reference's default processor trains on every pixel
    too."""
    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 1000)
    calls = []
    twin = km.lloyd_accumulate
    monkeypatch.setattr(km, "lloyd_accumulate",
                        lambda *a, **kw: calls.append(kw["metric"]) or twin(*a, **kw))
    img = _image(H, W, seed=31)
    port = kt.ImageProcessor(device="cpu", delta_e="2000", train_max_size=None)
    want = processors[0].reduce(8, img).pixels
    got = port.reduce(8, img).pixels
    assert len(calls) == port.last_iterations and set(calls) == {"cie2000"}
    same = _palettes_close(np.unique(got.reshape(-1, 4), axis=0),
                           np.unique(want.reshape(-1, 4), axis=0), "full-resolution palette")
    _pixels_close(got, want, same, "full-resolution reduce k=8 cie2000")
