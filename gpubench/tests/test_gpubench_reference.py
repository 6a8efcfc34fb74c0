"""The plain reference on small hand-checked cases, and against the program
on the CPU at tiny sizes (where the program runs its plain twins)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import reference
from gpubench.reference import colour, kmeans, output


def rgba(rgb) -> np.ndarray:
    rgb = np.asarray(rgb, np.uint8)
    return np.concatenate([rgb, np.full(rgb.shape[:-1] + (1,), 255, np.uint8)], -1)


def test_two_colour_image_reduces_to_itself():
    img = np.zeros((8, 12, 3), np.uint8)
    img[:, :6] = (200, 30, 40)
    img[:, 6:] = (20, 60, 210)
    for mode in ("replace", "dither"):
        out = reference.reduce(rgba(img), 2, mode, None, "cpu").numpy()
        assert (out == rgba(img)).all(), mode


def test_lab_of_white_black_and_grey():
    lab = colour.srgb8_to_lab(torch.tensor([[255, 255, 255], [0, 0, 0], [119, 119, 119]],
                                           dtype=torch.uint8))
    assert abs(float(lab[0, 0]) - 100.0) < 1e-3 and float(lab[1].abs().max()) < 1e-6
    assert abs(float(lab[2, 0]) - 50.0) < 0.1 and float(lab[:, 1:].abs().max()) < 0.01
    back = colour.lab_to_srgb8(lab)
    assert back.tolist() == [[255, 255, 255], [0, 0, 0], [119, 119, 119]]


def test_bayer_pattern():
    b = output.bayer(5, 6, "cpu")
    want = (torch.tensor(output.BAYER_4X4, dtype=torch.float32) / 16 - 0.5)
    assert torch.equal(b[:4, :4], want) and torch.equal(b[4], want[0, :2].new_tensor(
        [want[0, 0], want[0, 1], want[0, 2], want[0, 3], want[0, 0], want[0, 1]]))
    assert float(b.min()) == -0.5 and float(b.max()) == 0.4375


def test_dither_threshold_by_hand():
    # L* only: the greedy walk keeps the pair (0, 100): threshold 100 / sqrt(4).
    pal = torch.tensor([[[10.0, 0, 0], [50.0, 0, 0], [0.0, 0, 0], [100.0, 0, 0]]])
    assert float(output.dither_threshold(pal)[0]) == pytest.approx(50.0)


def test_dither_moves_a_pixel_between_two_colours():
    # A grey half-way between two greys: dither gives both, replace gives one.
    pal = colour.srgb8_to_lab(torch.tensor([[100, 100, 100], [140, 140, 140]], dtype=torch.uint8))
    img = torch.full((4, 4, 3), 120, dtype=torch.uint8)
    thr = output.dither_threshold(pal[None])[0]
    assert len(torch.unique(output.indices(img, pal, "dither", thr))) == 2
    assert len(torch.unique(output.indices(img, pal, "replace", None))) == 1


def test_tiny_kmeans_known_answer():
    # Two tight groups of Lab points: the centroids are the group means.
    pts = torch.tensor([[20.0, 5, 5], [22.0, 5, 5], [21.0, 7, 5],
                        [80.0, -5, 10], [82.0, -5, 10], [81.0, -3, 10]])
    cents = kmeans.seed(pts, 2, 0, pts, None)
    assert torch.equal(cents[1], pts[4])  # the farthest point from pixel 0
    got, steps = kmeans.lloyd(pts, cents)
    want = torch.stack([pts[:3].mean(0), pts[3:].mean(0)])
    assert torch.allclose(got, want) and steps == 9  # first check after step 8 converges


def test_first_seed_index_in_range():
    for w, h in [(1, 1), (256, 144), (3840, 2160)]:
        assert 0 <= kmeans.first_seed_index(w, h) < w * h


def test_shrunk_size():
    assert colour.shrunk_size(3840, 2160, 256) == (256, 144)
    assert colour.shrunk_size(100, 50, None) == (100, 50)
    assert colour.shrunk_size(100, 50, 256) == (100, 50)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    return rgba(np.clip(rgb + rng.integers(-20, 21, (h, w, 3)), 0, 255))


@pytest.mark.parametrize("mode,tms,k", [("replace", 32, 8), ("dither", 32, 16),
                                        ("dither", None, 8), ("replace", None, 16)])
def test_reduce_equals_program_on_cpu(mode, tms, k):
    import kmeans_tpu_torch as kt

    img = _image(40, 56, k)
    got = kt.ImageProcessor(device="cpu", train_max_size=tms).reduce(k, img, reduce_mode=mode)
    assert np.array_equal(got.pixels, reference.reduce(img, k, mode, tms, "cpu").numpy())


@pytest.mark.parametrize("mode", ["replace", "dither"])
def test_reduce_images_equals_program_on_cpu(mode):
    import kmeans_tpu_torch as kt

    frames = [_image(24, 40, s) for s in range(3)]
    got = kt.ImageProcessor(device="cpu", train_max_size=16).reduce_images(frames, 8,
                                                                           reduce_mode=mode)
    want = reference.reduce_images(frames, 8, mode, 16, "cpu").numpy()
    assert all(np.array_equal(g.pixels, w) for g, w in zip(got, want))


def test_lowp_control_departs():
    img = _image(40, 56, 3)
    exact = reference.reduce(img, 8, "dither", None, "cpu").numpy()
    low = reference.reduce(img, 8, "dither", None, "cpu", lowp=True).numpy()
    assert (exact != low).any(-1).mean() > 0.05
