"""PyTorch port vs the JAX package: `fast=True` through the trainers and
the API, and the fast tiers' gates.

The plain twins are held to the Pallas kernels in tests/test_torch_fast.py;
here the same numpy-seeded inputs go through the two packages' trainers
and processors. Every deviation is counted and printed. Bars:

- the gates: bit equality with the exact twin at kp <= 16 and kp > 512,
  and of the pruned tier with `k_active <= m` (equal assignments; on the
  CPU the inertia column agrees to 1e-5 only, because torch's vectorised
  `atan2`, `sin` and `cos` on a gathered centroid plane and its scalar
  ones on one centroid differ in the last bit).
- `fit_large(fast=True)` against the reference's with its Pallas
  accumulator in interpret mode: iteration counts equal, centroids within
  1e-3, as tests/test_torch_fit_large.py holds the exact trainer.
- the API at k = 24 against the reference's `ImageProcessor(fast=True)`,
  which on the CPU is its exact XLA path, and against the port's own
  `fast=False`: palettes equal (the shrunk training never sees `fast`);
  replace and dither pixels differ on at most 1e-3 of the pixels (the
  reference's bar between its tiers, tests/test_kernels.py:753, 786,
  1059), meld by more than 1 u8 step on at most 1e-3; at k = 8 bit-equal
  to `fast=False`. `find` with 24 random colours under the pruned tier:
  counted, at most 2e-2 (the screen's deviation class on a palette no
  training spread out).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu_torch import api
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops import kernels

torch.set_num_threads(2)

BAR = 1e-3  # the fast tiers' deviation bar, as a fraction of the pixels


def _case(k, seed, h=16, w=24):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))
    return rgb, pal


def _lab_pixels(n, seed):
    """`[n, 3]` float32 Lab of random sRGB pixels, a tenth of them one
    colour, so that exact ties occur."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rgb[: n // 10] = rgb[0]
    return np.array(ref_lab(jnp.asarray(rgb)))


# --- the gates --------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("kp", [16, 513])
def test_fast_outside_its_range_is_exact(kp, metric):
    rgb, pal = _case(kp, seed=400 + kp)
    rgb_t, cents = torch.from_numpy(rgb), torch.from_numpy(pal)
    assert kernels.assign_tier(True, metric, kp) == "exact"
    assert torch.equal(
        kernels.assign_packed_reference(rgb_t, cents, 2.0, None, "dither", 0, metric, fast=True),
        kernels.assign_packed_reference(rgb_t, cents, 2.0, None, "dither", 0, metric))
    if kp == 16:
        assert torch.equal(kernels.meld_packed_reference(rgb_t, cents, None, metric, fast=True),
                           kernels.meld_packed_reference(rgb_t, cents, None, metric))
    else:  # the meld tier comes from the same `assign_tier`
        planes, n = kernels.pack_lab_planes(torch.from_numpy(_lab_pixels(500, seed=4)))
        with pytest.raises(ValueError, match="k <= 512"):
            kernels.lloyd_accumulate(planes, cents, n, metric=metric, fast=True)


@pytest.mark.parametrize("kp,k_active", [(24, 8), (24, 3), (129, 16)])
def test_pruned_with_every_centroid_surviving_is_exact(kp, k_active):
    """With `k_active <= m` the screen drops nothing, so the pruned tier
    must give the exact tier's bits (the knob-free check of
    tests/test_kernels.py:1060-1075): unless two active centroids tie
    exactly, which the random palette does not."""
    rgb, pal = _case(kp, seed=410 + kp)
    rgb_t, cents = torch.from_numpy(rgb), torch.from_numpy(pal)
    assert kernels.prune_m_for(kp) >= k_active
    assert torch.equal(
        kernels.assign_packed_reference(rgb_t, cents, 0.0, k_active, metric="cie2000", fast=True),
        kernels.assign_packed_reference(rgb_t, cents, 0.0, k_active, metric="cie2000"))
    assert torch.equal(
        kernels.meld_packed_reference(rgb_t, cents, k_active, "cie2000", fast=True),
        kernels.meld_packed_reference(rgb_t, cents, k_active, "cie2000"))
    planes, n = kernels.pack_lab_planes(torch.from_numpy(_lab_pixels(2000, seed=5)))
    args = (planes, cents, n, k_active, None, "cie2000", True)
    fast = kernels.lloyd_accumulate_reference(*args, fast=True)
    exact = kernels.lloyd_accumulate_reference(*args)
    assert torch.equal(fast[:, :4], exact[:, :4])
    torch.testing.assert_close(fast[:, 4], exact[:, 4], rtol=1e-5, atol=0)


def test_pruned_tie_of_equal_scores_keeps_the_lower_index():
    """The nearest centroid twice in the palette, at indices 20 and 3:
    equal screening scores enter the candidate list lower index first
    (strict `<`), and the exact pass visits the list in that order with
    strict `<`, so the pruned tier picks index 3, as the exact tier does."""
    cents = torch.zeros((24, 3))
    cents[:, 0] = torch.linspace(0, 100, 24)
    cents[:, 1] = 40.0  # every other centroid is far from a grey pixel
    cents[20] = cents[3] = torch.tensor([53.5, 0.5, 0.0])  # L* of sRGB grey 128 is 53.6
    grey = torch.tensor([[[128, 128, 128]]], dtype=torch.uint8)
    exact = kernels.assign_packed_reference(grey, cents, 0.0, metric="cie2000")
    fast = kernels.assign_packed_reference(grey, cents, 0.0, metric="cie2000", fast=True)
    assert int(exact[0, 0]) & 0xFF == int(fast[0, 0]) & 0xFF == 3


def test_accumulator_factorized_runs_below_the_palette_gate():
    """The accumulator has no kp gate for CIE94 (tests/test_kernels.py:
    532-549): at kp = 8 `fast=True` takes the factorized tier, and the
    wrapper on a CPU tensor runs that twin and launches nothing."""
    lab = _lab_pixels(3000, seed=6)
    planes, n = kernels.pack_lab_planes(torch.from_numpy(lab))
    cents = torch.from_numpy(lab[:8].copy())
    before = kernels.launches("lloyd_accumulate")
    fast = kernels.lloyd_accumulate(planes, cents, n, fast=True)
    exact = kernels.lloyd_accumulate(planes, cents, n)
    assert kernels.launches("lloyd_accumulate") == before
    assert float(fast[:, 3].sum()) == float(exact[:, 3].sum()) == n
    assert (fast[:, 3] - exact[:, 3]).abs().sum() <= 2 * 3 * BAR * n
    # The algebraic form's inertia is a true squared distance.
    alg = kernels.lloyd_accumulate(planes, cents, n, emit_inertia=True, fast=True)
    ex5 = kernels.lloyd_accumulate(planes, cents, n, emit_inertia=True)
    np.testing.assert_allclose(alg[:, 4].sum().item(), ex5[:, 4].sum().item(), rtol=1e-4)


@pytest.mark.parametrize("metric,k,want_train,want_inertia",
                         [("cie94", 24, True, False), ("cie2000", 24, True, True),
                          ("cie94", 8, False, False)])
def test_restarts_inertia_pass_tier(monkeypatch, metric, k, want_train, want_inertia):
    """`fit_large_restarts(fast=True)`: training passes take `fast` at
    k > 16 only; the winner's inertia pass runs exact under CIE94 and
    keeps `fast` under CIEDE2000 (kmeans_tpu/models/kmeans.py:288, 534-543)."""
    calls = []
    twin = km.lloyd_accumulate

    def spy(*a, **kw):
        calls.append((kw.get("emit_inertia", False), kw.get("fast", False)))
        return twin(*a, **kw)

    monkeypatch.setattr(km, "lloyd_accumulate", spy)
    lab = torch.from_numpy(_lab_pixels(1500, seed=7))
    km.fit_large_restarts(lab, k, 11, restarts=2, max_iterations=2, metric=metric, fast=True)
    assert [f for inertia, f in calls if not inertia] == [want_train] * 4
    assert [f for inertia, f in calls if inertia] == [want_inertia] * 2


# --- training ---------------------------------------------------------------


def _image(h, w, seed):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def test_fit_large_fast_matches_reference():
    img = _image(64, 96, seed=8)
    lab = np.array(ref_lab(jnp.asarray(img[..., :3].reshape(-1, 3))))
    first = ref_km.reference_seed_index(96, 64)
    want_c, want_i = ref_km.fit_large(jnp.asarray(lab), 24, first, interpret=True, fast=True)
    got_c, got_i = km.fit_large(torch.from_numpy(lab), 24, first, fast=True)
    assert got_i == int(want_i)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-3)


# --- the slice as a whole ---------------------------------------------------


IMG_H, IMG_W = 60, 88
MODES = ("REPLACE", "DITHER", "MELD")


def _differing(got, want, what, meld, bar=BAR):
    step = np.abs(got.astype(int) - want.astype(int)).max(-1)
    differ = int((step > 0).sum())
    print(f"{what}: {differ} of {step.size} pixels differ, max step {step.max()}")
    if meld:
        assert int((step > 1).sum()) <= bar * step.size
    else:
        assert differ <= bar * step.size


@pytest.mark.parametrize("delta_e", ["94", "2000"])
def test_api_fast_matches_reference_and_exact(delta_e):
    """`ImageProcessor(device="cpu", fast=True)` at k = 24 against (a) the
    reference's `ImageProcessor(fast=True)`, which on the CPU is its exact
    XLA path, and (b) the port's own `fast=False`; at k = 8 bit-equal to
    `fast=False`."""
    img = _image(IMG_H, IMG_W, seed=31)
    ref = kmeans_tpu.ImageProcessor(delta_e=delta_e, fast=True)
    fast = kt.ImageProcessor(device="cpu", delta_e=delta_e, fast=True)
    exact = kt.ImageProcessor(device="cpu", delta_e=delta_e)
    pal_fast = fast.palette(24, img)
    np.testing.assert_array_equal(pal_fast, exact.palette(24, img))
    pal_ref = ref.palette(24, img)
    print(f"palette k=24 delta_e={delta_e}: "
          f"{int((pal_fast != pal_ref).any(-1).sum())} of 24 entries differ from the reference")
    np.testing.assert_array_equal(pal_fast, pal_ref)
    # `find` with a palette trained on another image, as a user would
    # bring one, and with 24 random colours. Among random colours CIE94
    # and CIEDE2000 rank the neighbours of a pixel differently more often,
    # so the pruned tier's top 8 loses the true nearest on more pixels:
    # counted, and held to 2e-2 (measured 6.6e-3 here).
    colors = exact.palette(24, _image(IMG_H, IMG_W, seed=34))
    random_colors = np.random.default_rng(32).integers(0, 256, (24, 3), dtype=np.uint8)
    for name in MODES:
        meld = name == "MELD"
        got = fast.reduce(24, img, reduce_mode=getattr(kt.ReduceMode, name)).pixels
        assert got.shape == (IMG_H, IMG_W, 4) and (got[..., 3] == 255).all()
        _differing(got, ref.reduce(24, img, reduce_mode=getattr(kmeans_tpu.ReduceMode, name)).pixels,
                   f"reduce k=24 {name} delta_e={delta_e} vs reference", meld)
        _differing(got, exact.reduce(24, img, reduce_mode=getattr(kt.ReduceMode, name)).pixels,
                   f"reduce k=24 {name} delta_e={delta_e} vs fast=False", meld)
        small_fast = fast.reduce(8, img, reduce_mode=getattr(kt.ReduceMode, name)).pixels
        small_exact = exact.reduce(8, img, reduce_mode=getattr(kt.ReduceMode, name)).pixels
        np.testing.assert_array_equal(small_fast, small_exact)
    got = fast.find(img, colors, kt.ReduceMode.DITHER).pixels
    _differing(got, ref.find(img, colors, kmeans_tpu.ReduceMode.DITHER).pixels,
               f"find 24 colours DITHER delta_e={delta_e} vs reference", False)
    _differing(got, exact.find(img, colors, kt.ReduceMode.DITHER).pixels,
               f"find 24 colours DITHER delta_e={delta_e} vs fast=False", False)
    _differing(fast.find(img, random_colors).pixels, exact.find(img, random_colors).pixels,
               f"find 24 random colours REPLACE delta_e={delta_e} vs fast=False", False,
               bar=2e-2)


def test_api_fast_full_resolution_training(monkeypatch):
    """`train_max_size=None` with the 1M-pixel gate lowered: `fast`
    reaches the accumulator route (every step's pass at k = 24), and the
    palette stays within 1 u8 step of the exact training's."""
    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 1000)
    calls = []
    twin = km.lloyd_accumulate
    monkeypatch.setattr(km, "lloyd_accumulate",
                        lambda *a, **kw: calls.append(kw["fast"]) or twin(*a, **kw))
    img = _image(IMG_H, IMG_W, seed=33)
    fast = kt.ImageProcessor(device="cpu", train_max_size=None, fast=True)
    got = fast.palette(24, img)
    assert calls == [True] * fast.last_iterations
    want = kt.ImageProcessor(device="cpu", train_max_size=None).palette(24, img)
    step = np.abs(got.astype(int) - want.astype(int))
    print(f"full-resolution palette k=24: {int((step > 0).any(-1).sum())} of 24 entries "
          f"differ from fast=False, max step {step.max()}")
    assert step.max() <= 1
    del calls[:]
    fast.palette(8, img)
    assert calls == [False] * fast.last_iterations
