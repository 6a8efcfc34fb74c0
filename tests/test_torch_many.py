"""PyTorch port vs the JAX package: the bucketed reduce family and the
coalescers.

`kmeans_tpu.ImageProcessor(bucketing=True)` on the JAX CPU backend against
`kmeans_tpu_torch.ImageProcessor(device="cpu", bucketing=True)`, with a
training shrink capped at 24 px so that the canvas shrink samples (the
images are at most 60x48). Bars: palettes equal in u8, at least 99.99% of
the pixels equal (every flip counted; meld within 1 u8 step on at most
1e-3 of the pixels), for `reduce`, `palette`, `reduce_images`,
`palette_images`, `reduce_batch`, `reduce_many` and `palette_many`. Then:
`reduce(5)` under bucketing (k bucket 8, three masked rows) equals
unbucketed `reduce(5)` bit for bit where no shrink applies; the heavy and
plain routes of `reduce_many` / `palette_many` follow `_plain_fit_route`,
which mirrors the reference's with its accumulator route on; each
coalesced image equals its solo bucketed call; and the full-resolution
bucketed training reaches the accumulator's weight plane.
"""

import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu import api as ref_api
from kmeans_tpu_torch import api
from kmeans_tpu_torch.ops import kernels

torch.set_num_threads(2)

CAP = 24
# Three share the bucket 40x56, 21x22 is alone in 24x24.
MIXED = [(37, 53, 40), (40, 50, 41), (21, 22, 42), (33, 55, 43)]


def _image(h, w, seed):
    """Gradient plus noise, RGBA8 (alpha 255)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1)
    rgb = np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.fixture(scope="module")
def procs():
    return (kmeans_tpu.ImageProcessor(bucketing=True, train_max_size=CAP),
            kt.ImageProcessor(device="cpu", bucketing=True, train_max_size=CAP))


def _flips(got, want, mode):
    """Pixels that differ; raises past the bar."""
    step = np.abs(got.astype(np.int64) - want).max(-1)
    flips = int((step > 0).sum())
    if mode == "MELD":
        assert step.max() <= 1 and flips <= max(1, step.size // 1000), flips
    else:
        assert flips <= step.size // 10000, f"{flips} of {step.size} pixels differ"
    return flips


def _modes(mode):
    return getattr(kmeans_tpu.ReduceMode, mode), getattr(kt.ReduceMode, mode)


@pytest.mark.parametrize("k", [5, 8, 17])
@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_bucketed_reduce_and_palette_match_reference(procs, mode, k):
    ref, port = procs
    img = _image(48, 60, 7)
    rm, pm = _modes(mode)
    got = port.reduce(k, img, reduce_mode=pm).pixels
    assert got.shape == (48, 60, 4)
    _flips(got, ref.reduce(k, img, reduce_mode=rm).pixels, mode)
    if mode == "REPLACE":
        np.testing.assert_array_equal(port.palette(k, img), ref.palette(k, img))


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_bucketed_frame_batches_match_reference(procs, mode):
    """`reduce_images` and `palette_images` of 9 frames (the count pads to
    10: a copy of frame 0, dropped, or a frame of weight 0) and
    `reduce_batch` at ks (3, 6, 2, 5, 4) (padded to 5 entries, kmax 6 up
    the ladder)."""
    ref, port = procs
    rm, pm = _modes(mode)
    frames = [_image(37, 53, 30 + i) for i in range(9)]
    got = port.reduce_images(frames, 6, pm)
    assert len(got) == 9
    for g, w in zip(got, ref.reduce_images(frames, 6, rm)):
        _flips(g.pixels, w.pixels, mode)
    ks = [3, 6, 2, 5, 4]
    for g, w in zip(port.reduce_batch(frames[0], ks, pm), ref.reduce_batch(frames[0], ks, rm)):
        _flips(g.pixels, w.pixels, mode)
    if mode == "REPLACE":
        np.testing.assert_array_equal(port.palette_images(frames, 6),
                                      ref.palette_images(frames, 6))


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_reduce_many_and_palette_many_match_reference(procs, mode):
    ref, port = procs
    rm, pm = _modes(mode)
    mixed = [_image(h, w, s) for h, w, s in MIXED]
    got = port.reduce_many(mixed, 6, pm)
    for g, w, im in zip(got, ref.reduce_many(mixed, 6, rm), mixed):
        assert g.pixels.shape == im.shape
        _flips(g.pixels, w.pixels, mode)
    if mode == "REPLACE":
        for g, w in zip(port.palette_many(mixed, 6), ref.palette_many(mixed, 6)):
            np.testing.assert_array_equal(g, w)


def test_coalesced_images_equal_their_solo_calls(procs):
    """Each image of a coalesced bucket equals its solo bucketed `reduce`
    and `palette` bit for bit (a member of the batched loop keeps its solo
    state); `last_iterations` is the longest member's."""
    _, port = procs
    mixed = [_image(h, w, s) for h, w, s in MIXED]
    many = port.reduce_many(mixed, 6, kt.ReduceMode.DITHER)
    longest = port.last_iterations
    pals = port.palette_many(mixed, 6)
    iters = []
    for im, out, pal in zip(mixed, many, pals):
        np.testing.assert_array_equal(out.pixels,
                                      port.reduce(6, im, reduce_mode=kt.ReduceMode.DITHER).pixels)
        iters.append(port.last_iterations)
        np.testing.assert_array_equal(pal, port.palette(6, im))
    assert longest == max(iters)


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_masked_rows_change_nothing(mode):
    """k = 5 pads to the k bucket 8: the three masked rows never seed, win
    or move. Without a shrink (the image fits the cap) the bucketed
    `reduce(5)` equals unbucketed `reduce(5)` bit for bit."""
    img = _image(37, 53, 8)
    pm = getattr(kt.ReduceMode, mode)
    got = kt.ImageProcessor(device="cpu", bucketing=True).reduce(5, img, reduce_mode=pm)
    want = kt.ImageProcessor(device="cpu").reduce(5, img, reduce_mode=pm)
    np.testing.assert_array_equal(got.pixels, want.pixels)


def test_plain_fit_route_mirrors_reference():
    """The port's route test equals the reference's with its accumulator
    route on (`_fit_auto` reads it so on both devices), over the size
    gates."""
    for n in (1, 1 << 20, (1 << 20) + 1, 3 << 20, 200 << 20):
        for kp in (4, 8, 64, 128, 256, 512, 1024, 4096):
            assert api._plain_fit_route(n, kp) == ref_api._plain_fit_route(n, kp, True, "cie94")
            assert api._plain_fit_route(n, kp) == ref_api._plain_fit_route(n, kp, True, "cie2000")


@pytest.mark.parametrize("which", ["reduce_many", "palette_many"])
def test_heavy_and_plain_routes_follow_plain_fit_route(which, monkeypatch):
    """With the large-training gate lowered to 400 pixels, the 40x56
    bucket's full canvas (2240 pixels) leaves the plain trainer: its images
    train one after another on the accumulator, with its weight plane, and
    each equals its solo call; the 24x24 bucket's single image runs solo.
    With the gate back, the same bucket takes the batched loop."""
    port = kt.ImageProcessor(device="cpu", bucketing=True, train_max_size=None)
    mixed = [_image(h, w, s) for h, w, s in MIXED]
    routes = []
    for name in ("_train_bucketed_heavy", "_train_bucketed_frames"):
        real = getattr(kt.ImageProcessor, name)

        def spy(self, stack, *args, _real=real, _name=name):
            routes.append((_name, tuple(stack.shape[:3])))
            return _real(self, stack, *args)

        monkeypatch.setattr(kt.ImageProcessor, name, spy)
    for gate, route in ((400, "_train_bucketed_heavy"), (api._LARGE_TRAIN_PIXELS,
                                                         "_train_bucketed_frames")):
        monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", gate)
        assert api._plain_fit_route(40 * 56, 8) == (route == "_train_bucketed_frames")
        routes.clear()
        kernels.LAUNCHES_BY_MODE.clear()
        out = getattr(port, which)(mixed, 6)
        assert routes == [(route, (3, 40, 56))]
        solo = [port.reduce(6, im) if which == "reduce_many" else port.palette(6, im)
                for im in mixed]
        for g, s in zip(out, solo):
            np.testing.assert_array_equal(g.pixels if which == "reduce_many" else g,
                                          s.pixels if which == "reduce_many" else s)


def test_full_resolution_bucketed_training_weighs_the_padding(procs, monkeypatch):
    """`train_max_size=None` under bucketing trains on the whole padded
    bucket; past the (lowered) gate that is the accumulator with the
    canvas's weight plane. Its palette equals the reference's bucketed one
    (which trains there on the plain weighted trainer), and the pad
    pixels count for nothing: equal to the unbucketed port's palette."""
    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 400)
    img = _image(37, 53, 9)
    port = kt.ImageProcessor(device="cpu", bucketing=True, train_max_size=None)
    seen = []
    real = kernels.lloyd_accumulate

    def spy(planes, cents, n_valid, **kw):
        seen.append(kw.get("weight_planes") is not None)
        return real(planes, cents, n_valid, **kw)

    monkeypatch.setattr(api.kmeans_model, "lloyd_accumulate", spy)
    pal = port.palette(8, img)
    assert seen and all(seen)
    ref = kmeans_tpu.ImageProcessor(bucketing=True, train_max_size=None)
    np.testing.assert_array_equal(pal, ref.palette(8, img))
    np.testing.assert_array_equal(pal, kt.ImageProcessor(device="cpu",
                                                         train_max_size=None).palette(8, img))
