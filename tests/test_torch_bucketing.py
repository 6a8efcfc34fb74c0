"""PyTorch port vs the JAX package: shape bucketing and per-pixel weights.

The same numpy-seeded inputs go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU). Bars:

- the bucketing helpers (`kmeans_tpu_torch/utils/bucketing.py`) equal the
  reference's on a Hypothesis sweep of sizes;
- `resize_to_canvas`, single and batched, equals the reference's jitted
  one byte for byte (each differing byte is counted, and the bar is 0);
- the weighted trainers: a pixel of weight 0 never seeds and adds exact
  zeros; weighted training equals the reference's (equal iterations,
  centroids within 1e-3 and equal in u8); the batched trainer with a
  weight vector and a seed per member equals the solo trainer bit for
  bit;
- bucketed `find`, `find_batch` and `find_many` equal the port's
  unbucketed outputs bit for bit, and the reference's bucketed outputs
  (meld within 1 u8 step on at most 1e-3 of the pixels, the known class);
- `warmup` issues as many dummy requests as the reference's for the same
  arguments, and the `ValueError`s of `train_dtype` and `warmup` without
  bucketing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.resize import resize_to_canvas as ref_canvas
from kmeans_tpu.utils import bucketing as ref_b
from kmeans_tpu_torch.interop import centroids_from_reference
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.resize import resize_to_canvas
from kmeans_tpu_torch.utils import bucketing as bk

torch.set_num_threads(2)

H, W = 37, 53  # odd: the padded rows and columns land off the Bayer period


def _image(h, w, seed):
    """Gradient plus noise, RGBA8 (alpha 255)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1)
    rgb = np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def _colors(k, seed):
    colors = np.random.default_rng(seed).integers(0, 256, (k, 4), dtype=np.uint8)
    colors[:, 3] = 255
    return colors


@pytest.fixture(scope="module")
def procs():
    return {
        "ref": kmeans_tpu.ImageProcessor(bucketing=True),
        "port": kt.ImageProcessor(device="cpu", bucketing=True),
        "plain": kt.ImageProcessor(device="cpu"),
    }


# --- The helpers ---------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=1 << 20))
def test_ladder_helpers_match_reference(n):
    assert bk.next_bucket(n) == ref_b.next_bucket(n)
    assert bk.bucket_frames(n) == ref_b.bucket_frames(n)
    assert bk.bucket_k(n) == ref_b.bucket_k(n)
    assert bk.next_bucket(n) >= n and bk.bucket_k(n) >= n


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 300), st.integers(1, 300))
def test_pad_to_bucket_matches_reference(procs, h, w):
    """The port pads on the device (`ImageProcessor._upload_padded`, alpha
    dropped): the bytes of the reference's `pad_to_bucket`, RGB."""
    assert bk.bucket_shape(h, w) == ref_b.bucket_shape(h, w)
    arr = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 4), dtype=np.uint8)
    want, rh, rw = ref_b.pad_to_bucket(arr)
    assert (rh, rw) == (h, w)
    got = procs["port"]._upload_padded([kt.Image((w, h), arr)], *bk.bucket_shape(h, w))
    assert got.shape == (1,) + want.shape[:2] + (3,)
    np.testing.assert_array_equal(got[0].numpy(), want[..., :3])


@pytest.mark.parametrize("k", [1, 3, 4, 5, 17, 64, 1025])
def test_pad_palette_k_matches_reference(k):
    pal = np.random.default_rng(k).normal(50, 30, (k, 3)).astype(np.float32)
    got, ka = bk.pad_palette_k(torch.from_numpy(pal))
    want, ra = ref_b.pad_palette_k(jnp.asarray(pal))
    assert ka == ra == k
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- The canvas shrink ---------------------------------------------------------

_ref_canvas_jit = jax.jit(ref_canvas, static_argnums=(1, 2))

CANVAS_CASES = {
    # name: (h, w, canvas cap or None for the full bucket)
    "shrink-2to1-and-5to2": (48, 60, 24),
    "shrink-odd": (37, 53, 24),
    "identity-axis": (20, 53, 24),  # rows fit the cap: identity gather
    "full-bucket": (37, 53, None),
}


def _canvas_args(h, w, cap):
    bh, bw = bk.bucket_shape(h, w)
    sw, sh = kt.api.shrunk_dimensions(w, h, cap)
    canvas = (bh, bw) if cap is None else (min(cap, bh), min(cap, bw))
    return canvas, sh, sw


@pytest.mark.parametrize("case", sorted(CANVAS_CASES))
def test_resize_to_canvas_matches_reference(case):
    """Single form: every byte of the canvas and every weight equal the
    reference's (the count of differing bytes is reported on failure)."""
    h, w, cap = CANVAS_CASES[case]
    padded, _, _ = ref_b.pad_to_bucket(_image(h, w, 3)[..., :3])
    canvas, sh, sw = _canvas_args(h, w, cap)
    want_c, want_w = _ref_canvas_jit(jnp.asarray(padded), *canvas, h, w, sh, sw)
    got_c, got_w = resize_to_canvas(torch.from_numpy(padded), *canvas, h, w, sh, sw)
    differ = int((got_c.numpy() != np.asarray(want_c)).sum())
    assert differ == 0, f"{differ} of {got_c.numel()} canvas bytes differ"
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert got_w.sum() == sh * sw


def test_batched_resize_to_canvas_matches_reference():
    """Batched form, frames of different sizes in one bucket: each frame
    equals the single form and the reference's vmapped canvas."""
    sizes = [(37, 53), (40, 50), (33, 55)]
    bh, bw = bk.bucket_shape(*sizes[0])
    frames = np.stack([ref_b.pad_to_bucket(_image(h, w, 10 + i)[..., :3])[0]
                       for i, (h, w) in enumerate(sizes)])
    assert frames.shape[1:3] == (bh, bw)
    dims = [kt.api.shrunk_dimensions(w, h, 24) for h, w in sizes]
    vec = [[h for h, _ in sizes], [w for _, w in sizes], [d[1] for d in dims], [d[0] for d in dims]]
    got_c, got_w = resize_to_canvas(torch.from_numpy(frames), 24, 24, *vec)
    want_c, want_w = jax.jit(jax.vmap(ref_canvas, in_axes=(0, None, None, 0, 0, 0, 0)),
                             static_argnums=(1, 2))(
        jnp.asarray(frames), 24, 24, *[jnp.asarray(v, jnp.int32) for v in vec])
    differ = int((got_c.numpy() != np.asarray(want_c)).sum())
    assert differ == 0, f"{differ} canvas bytes differ"
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    for i in range(len(sizes)):
        one_c, one_w = resize_to_canvas(torch.from_numpy(frames[i]), 24, 24,
                                        *[v[i] for v in vec])
        assert torch.equal(one_c, got_c[i]) and torch.equal(one_w, got_w[i])


# --- The weighted trainers -----------------------------------------------------


def _weighted_case(seed, n_real=300, n_pad=84):
    """Lab pixels whose padding is far from every real pixel (it would win
    every farthest-point pick), and the 0/1 weights."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n_real, 3), dtype=np.uint8)
    lab = np.array(ref_lab(jnp.asarray(rgb)))
    pad = np.tile(np.array([[150.0, 120.0, -120.0]], np.float32), (n_pad, 1))
    order = rng.permutation(n_real + n_pad)
    pixels = np.concatenate([lab, pad])[order].astype(np.float32)
    weight = np.concatenate([np.ones(n_real), np.zeros(n_pad)])[order].astype(np.float32)
    return pixels, weight


def test_pad_pixels_never_seed_and_add_exact_zeros():
    pixels, weight = _weighted_case(1)
    px, wt = torch.from_numpy(pixels), torch.from_numpy(weight)
    first = int(np.flatnonzero(weight)[0])
    cents = km.plusplus_init(px, 12, first, weight=wt)
    want = np.asarray(ref_km.plusplus_init(jnp.asarray(pixels), 12, first,
                                           weight=jnp.asarray(weight)))
    np.testing.assert_array_equal(cents.numpy(), want)
    assert not (cents == torch.tensor([150.0, 120.0, -120.0])).all(1).any()
    # A 0-weight row adds exact zeros: the totals equal those of the real
    # rows alone, bit for bit.
    assign = km.assign_clusters(px, cents)
    sums, counts = km._update_centroids(px, assign, 12, wt)
    real = wt > 0
    sums_real, counts_real = km._update_centroids(px[real], assign[real], 12)
    assert torch.equal(sums, sums_real) and torch.equal(counts, counts_real)


def test_restart_seeds_walk_off_pad_pixels():
    _, weight = _weighted_case(2)
    for first in (0, 5, 383):
        got = km.derive_restart_seeds(weight.shape[0], first, 5, torch.from_numpy(weight))
        want = ref_km.derive_restart_seeds(weight.shape[0], first, 5, jnp.asarray(weight))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (weight[got.numpy()[1:]] > 0).all()


@pytest.mark.parametrize("trainer,restarts,k_active",
                         [("fit_restarts", 1, None), ("fit_restarts", 3, 5),
                          ("fit_large_restarts", 1, 5), ("fit_large_restarts", 2, None),
                          ("fit_chunked", 2, 5)])
def test_weighted_trainers_match_reference(trainer, restarts, k_active):
    """Each weighted trainer against the reference's weighted `fit_restarts`
    (the plain protocol; the accumulator and the row-chunked trainer add
    in another order): equal iterations, centroids within 1e-3 and equal
    in u8."""
    pixels, weight = _weighted_case(3)
    first = int(np.flatnonzero(weight)[3])
    k = 8
    got, iters = getattr(km, trainer)(torch.from_numpy(pixels), k, first, restarts=restarts,
                                      k_active=k_active, weight=torch.from_numpy(weight))
    want, want_iters = ref_km.fit_restarts(jnp.asarray(pixels), k, first, restarts=restarts,
                                           k_active=k_active, weight=jnp.asarray(weight))
    ka = k if k_active is None else k_active
    assert int(iters) == int(want_iters)
    np.testing.assert_allclose(got.numpy()[:ka], np.asarray(want)[:ka], atol=1e-3)
    u8 = kt.api._lab_palette_to_u8(got[:ka])[0].numpy()
    want_u8 = kt.api._lab_palette_to_u8(torch.from_numpy(np.array(want)[:ka]))[0].numpy()
    np.testing.assert_array_equal(u8, want_u8)
    if ka < k:  # masked rows never move
        assert (got[ka:] == 0).all()


def test_batched_weighted_trainer_equals_solo():
    """A weight vector and a seed index per member: each member's result is
    its solo `fit_restarts`' bits, and the reference's vmapped weighted
    `fit_restarts` within 1e-3."""
    cases = [_weighted_case(s) for s in (4, 5, 6)]
    px = torch.from_numpy(np.stack([c[0] for c in cases]))
    wt = torch.from_numpy(np.stack([c[1] for c in cases]))
    firsts = [int(np.flatnonzero(c[1])[i]) for i, c in enumerate(cases)]
    for restarts in (1, 2):
        cents, iters = km.fit_restarts_batched(px, 8, firsts, restarts=restarts,
                                               k_actives=[5, 5, 5], weights=wt)
        for i in range(3):
            solo, solo_iters = km.fit_restarts(px[i], 8, firsts[i], restarts=restarts,
                                               k_active=5, weight=wt[i])
            assert torch.equal(cents[i], solo) and iters[i] == solo_iters
        want = jax.vmap(lambda p, f, w: ref_km.fit_restarts(p, 8, f, restarts=restarts,
                                                            k_active=5, weight=w)[0])(
            jnp.asarray(px.numpy()), jnp.asarray(firsts), jnp.asarray(wt.numpy()))
        np.testing.assert_allclose(cents.numpy(), np.asarray(want), atol=1e-3)


# --- find under bucketing ------------------------------------------------------


@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_bucketed_find_is_bit_equal(procs, mode, k):
    """On an odd-sized image (37x53 pads to 40x56, off the 4-row Bayer
    period): bucketed `find` equals unbucketed `find` bit for bit, so
    padding bottom and right moves no real pixel's dither position; and
    the reference's bucketed `find`."""
    img, colors = _image(H, W, 20), _colors(k, 21)
    got = procs["port"].find(img, colors, getattr(kt.ReduceMode, mode)).pixels
    plain = procs["plain"].find(img, colors, getattr(kt.ReduceMode, mode)).pixels
    want = procs["ref"].find(img, colors, getattr(kmeans_tpu.ReduceMode, mode)).pixels
    assert got.shape == (H, W, 4)
    np.testing.assert_array_equal(got, plain)
    _assert_matches_reference(got, want, mode)


def _assert_matches_reference(got, want, mode):
    step = np.abs(got.astype(np.int64) - want).max(-1)
    if mode == "MELD":  # the known meld class: 1 u8 step on <= 1e-3
        assert step.max() <= 1 and (step > 0).sum() <= max(1, step.size // 1000)
    else:
        assert (step > 0).sum() == 0


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_bucketed_find_batch_and_find_many_are_bit_equal(procs, mode):
    """`find_batch` (3 frames, a count that `bucket_frames` keeps) and
    `find_many` (mixed sizes: three in one bucket, one alone) equal the
    port's unbucketed `find` on each image, and the reference's
    bucketed calls."""
    colors = _colors(6, 22)
    frames = [_image(H, W, 30 + i) for i in range(3)]
    mixed = [_image(H, W, 40), _image(40, 50, 41), _image(21, 22, 42), _image(33, 55, 43)]
    rm, pm = getattr(kmeans_tpu.ReduceMode, mode), getattr(kt.ReduceMode, mode)
    for got, want, images in (
        (procs["port"].find_batch(frames, colors, pm),
         procs["ref"].find_batch(frames, colors, rm), frames),
        (procs["port"].find_many(mixed, colors, pm),
         procs["ref"].find_many(mixed, colors, rm), mixed),
    ):
        for g, w, im in zip(got, want, images):
            plain = procs["plain"].find(im, colors, pm).pixels
            assert g.pixels.shape == im.shape
            np.testing.assert_array_equal(g.pixels, plain)
            _assert_matches_reference(g.pixels, w.pixels, mode)


def test_find_many_groups_a_bucket_into_one_launch(procs, monkeypatch):
    """Three images of one bucket take one tall output pass; the image
    alone in its bucket takes its own."""
    calls = []
    real = kt.ImageProcessor._quantize

    def spy(self, pixels, *args):
        calls.append(tuple(pixels.shape))
        return real(self, pixels, *args)

    monkeypatch.setattr(kt.ImageProcessor, "_quantize", spy)
    mixed = [_image(H, W, 40), _image(40, 50, 41), _image(21, 22, 42), _image(33, 55, 43)]
    procs["port"].find_many(mixed, _colors(6, 22))
    assert calls == [(3 * 40, 56, 3), (24, 24, 3)]


def test_reference_padded_palette_feeds_the_port(procs):
    """A palette the reference padded with `pad_palette_k` (`[kp, 3]` plus
    its `k_active`) goes into the port through `centroids_from_reference`
    and an int: the output pass gives the port's own bucketed bits."""
    img, colors = _image(H, W, 23), _colors(5, 24)
    lab = kt.api._colors_to_lab(colors)
    ref_pal, k_active = ref_b.pad_palette_k(jnp.asarray(lab))
    rgb = torch.from_numpy(np.ascontiguousarray(img[..., :3]))
    got = kernels.assign_packed(rgb, centroids_from_reference(ref_pal), 0.0, k_active)
    own, own_k = bk.pad_palette_k(torch.from_numpy(lab))
    assert own_k == k_active
    assert torch.equal(got, kernels.assign_packed(rgb, own, 0.0, own_k))


# --- warmup and the refusals ---------------------------------------------------


def test_warmup_count_matches_reference(procs):
    """The same arguments issue as many dummy requests as the reference's,
    on one tiny size: k = 3 and 4 share the k bucket 4, k = 5 takes 8
    (reduce and palette each), and one find."""
    args = dict(sizes=[(7, 6)], color_counts=[3, 4, 5], modes=(kt.ReduceMode.REPLACE,),
                find_palette_sizes=(2,))
    ref_args = dict(args, modes=(kmeans_tpu.ReduceMode.REPLACE,))
    kernels.LAUNCHES_BY_MODE.clear()
    assert procs["port"].warmup(**args) == procs["ref"].warmup(**ref_args) == 5


def test_bucketing_refusals():
    with pytest.raises(ValueError, match="train_dtype"):
        kt.ImageProcessor(device="cpu", bucketing=True, train_dtype="bfloat16")
    with pytest.raises(ValueError, match="bucketing=True"):
        kt.ImageProcessor(device="cpu").warmup([(8, 8)], [4])
    port = kt.ImageProcessor(device="cpu", bucketing=True)
    for call in (lambda: port.reduce_many([], 4), lambda: port.palette_many([], 4),
                 lambda: port.find_many([], [[0, 0, 0]])):
        with pytest.raises(ValueError):
            call()
    # A host algorithm runs per image (no batched form), as solo `palette`.
    pair = [_image(8, 8, 1)] * 2
    for got in port.palette_many(pair, 4, kt.Algorithm.OCTREE):
        np.testing.assert_array_equal(got, port.palette(4, pair[0], kt.Algorithm.OCTREE))
