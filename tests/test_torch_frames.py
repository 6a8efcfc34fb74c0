"""PyTorch port vs the JAX package: frame batching.

The same numpy-seeded inputs go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU), on 3 frames of 23x37 (H
not a multiple of 4, so each frame's dither phase must restart at its own
row 0) with palettes of k <= 24. Bars:

- the frames twins (`assign_frames_packed_reference`,
  `meld_frames_packed_reference`, `quantize_frames_reference`) against the
  reference's frames kernels in interpret mode, with per-frame `k_active`
  and thresholds: equal words; meld within 1 u8 step on at most 1 of
  4,096 pixels (none on these 2,553).
- `dither_thresholds` against the reference's vmapped `dither_threshold`:
  equal bits.
- `fit_restarts_batched` against the reference's vmapped `fit_restarts`:
  equal iteration counts, centroids within 1e-3 and equal once converted
  to u8; and against the port's own `fit_restarts` run member by member:
  equal bits (its contract: each member's state is its solo state).
- `find_batch`, `reduce_images`, `palette_images` and `reduce_batch`
  against `kmeans_tpu.ImageProcessor()`: palettes equal in u8, at least
  99.99% of the pixels equal (meld: within 1 u8 step on at most 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops import kernels as ref_k
from kmeans_tpu.ops import quantize as ref_q
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.quantize import dither_thresholds
from kmeans_tpu_torch.utils.packing import unpack_rgb24_tile_words

torch.set_num_threads(2)

B, H, W = 3, 23, 37


@pytest.fixture(scope="module", autouse=True)
def _short_prune_loop():
    """The reference's pruned screen unrolls `PRUNE_CHUNK` insertions of the
    top-m list per loop trip; in interpret mode the XLA compile of that
    body dominates (30 s at m = 16), whatever the image size. One trip per
    centroid computes the same lists (the loop form changes no result,
    tests/conftest.py), in a few seconds."""
    prev = ref_k.set_loop_knobs(prune_chunk=1)
    yield
    ref_k.set_loop_knobs(prune_chunk=prev[5])


def _frames(k, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (B, k, 3), dtype=np.uint8))))
    return rgb, pal


def _rgba(rgb):
    return np.concatenate([rgb, np.full(rgb.shape[:-1] + (1,), 255, np.uint8)], -1)


FRAME_CASES = {
    # name: (form, kp, metric, fast, frame stride 0)
    "packed-k8-cie94": ("packed", 8, "cie94", False, False),
    "packed-k17-cie2000-shared": ("packed", 17, "cie2000", False, True),
    "packed-k24-cie94-fast": ("packed", 24, "cie94", True, False),
    "packed-k24-cie2000-fast": ("packed", 24, "cie2000", True, False),
    "meld-k8-cie94-shared": ("meld", 8, "cie94", False, True),
    "meld-k17-cie2000": ("meld", 17, "cie2000", False, False),
    "rgba-k8-cie94": ("rgba", 8, "cie94", False, False),
    "rgba-k17-cie2000": ("rgba", 17, "cie2000", False, False),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_twins_match_pallas_kernels(case):
    """B = 3 frames in one launch, each with its own palette, `k_active`
    and dither threshold; `shared` puts one image through the three
    palettes (the twin reads one image expanded along B: frame stride 0)."""
    form, kp, metric, fast, shared = FRAME_CASES[case]
    rgb, pal = _frames(kp, seed=100 + kp)
    if shared:
        rgb = np.broadcast_to(rgb[:1], rgb.shape).copy()
    k_actives = np.array([kp, kp // 2, 5], np.int32)
    thr = np.array(jax.vmap(lambda c, ka: ref_q.dither_threshold(c, ka, metric))(
        jnp.asarray(pal), jnp.asarray(k_actives)))
    frames = torch.from_numpy(rgb[:1]).expand(B, H, W, 3) if shared else torch.from_numpy(rgb)
    cents, kas = torch.from_numpy(pal), k_actives.tolist()
    args = (jnp.asarray(_rgba(rgb)), jnp.asarray(pal))
    if form == "meld":
        want = np.asarray(ref_k.fused_meld_frames_packed(
            *args, jnp.asarray(k_actives), fast=fast, metric=metric, interpret=True))
        got = kernels.meld_frames_packed(frames, cents, kas, metric, fast).numpy()
        assert got.shape == want.shape
        rows = kernels.quant_tile_rows(kp)
        step = np.stack([
            np.abs(unpack_rgb24_tile_words(got[f], H, W, rows).astype(int)
                   - unpack_rgb24_tile_words(want[f], H, W, rows).astype(int)).max(-1)
            for f in range(B)])
        print(f"{case}: {int((step > 0).sum())} of {B * H * W} pixels differ")
        assert step.max() <= 1 and (step > 0).sum() <= B * H * W // 4096
        return
    if form == "packed":
        want = ref_k.fused_assign_frames_packed(
            *args, jnp.asarray(thr), jnp.asarray(k_actives), mode="dither", fast=fast,
            metric=metric, interpret=True)
        got = kernels.assign_frames_packed(frames, cents, torch.from_numpy(thr), kas,
                                           "dither", metric, fast)
    else:
        want = ref_k.fused_quantize_frames(
            *args, jnp.asarray(thr), jnp.asarray(k_actives), mode="dither", fast=fast,
            metric=metric, interpret=True)
        got = kernels.quantize_frames(frames, cents, torch.from_numpy(thr), kas, "dither",
                                      metric, fast)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    differ = int((got != want).sum())
    print(f"{case}: {differ} of {want.size} words differ")
    assert differ == 0


def test_frames_twins_are_single_image_twins_stacked():
    """Frame f of a frames twin is the single-image twin of frame f; a
    frame count of one is the single image."""
    rgb, pal = _frames(9, seed=110)
    frames, cents = torch.from_numpy(rgb), torch.from_numpy(pal)
    thr = dither_thresholds(cents, [9, 4, 1])
    words = kernels.assign_frames_packed(frames, cents, thr, [9, 4, 1], "dither")
    rgba = kernels.quantize_frames(frames, cents, thr, [9, 4, 1], "dither")
    meld = kernels.meld_frames_packed(frames, cents, [9, 4, 1])
    for f, ka in enumerate([9, 4, 1]):
        assert torch.equal(words[f], kernels.assign_packed(frames[f], cents[f], thr[f], ka,
                                                           "dither"))
        assert torch.equal(rgba[f], kernels.quantize_rgba(frames[f], cents[f], thr[f], ka,
                                                          "dither"))
        assert torch.equal(meld[f], kernels.meld_packed(frames[f], cents[f], ka))
    with pytest.raises(ValueError, match="k_actives"):
        kernels.assign_frames_packed(frames, cents, 0.0, [9, 10, 1])
    with pytest.raises(ValueError, match="palettes"):
        kernels.meld_frames_packed(frames, cents[:2])


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_dither_thresholds_match_reference(metric):
    _, pal = _frames(24, seed=120)
    k_actives = np.array([24, 7, 2], np.int32)
    want = np.asarray(jax.vmap(lambda c, ka: ref_q.dither_threshold(c, ka, metric))(
        jnp.asarray(pal), jnp.asarray(k_actives)))
    got = dither_thresholds(torch.from_numpy(pal), k_actives.tolist(), metric).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _lab(n, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 255, n).astype(int)[:, None]
    rgb = np.clip(y * [1, 0, 0] + [0, 80, 160] + rng.integers(-30, 31, (n, 3)), 0, 255)
    return np.array(ref_lab(jnp.asarray(rgb.astype(np.uint8))))


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_fit_restarts_batched_matches_reference(metric):
    """3 members of 600 pixels at k = 6 with 2 restarts, and one image at
    k_actives (2, 5, 9) padded to 9: the reference vmaps its trainer."""
    px = np.stack([_lab(600, seed=130 + b) for b in range(B)])
    cases = [
        (px, 6, None, 2,
         jax.vmap(lambda p: ref_km.fit_restarts(p, 6, 11, restarts=2, metric=metric))(
             jnp.asarray(px))),
        (px[0], 9, [2, 5, 9], 1,
         jax.vmap(lambda ka: ref_km.fit_restarts(jnp.asarray(px[0]), 9, 11, k_active=ka,
                                                 metric=metric))(jnp.asarray([2, 5, 9]))),
    ]
    for pixels, k, k_actives, restarts, (want, want_iters) in cases:
        got, iters = km.fit_restarts_batched(torch.from_numpy(pixels), k, 11, restarts=restarts,
                                             k_actives=k_actives, metric=metric)
        assert got.shape == (B, k, 3)
        assert iters == np.asarray(want_iters).tolist()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(
            kt.api._lab_palette_to_u8(got)[0].numpy(),
            kt.api._lab_palette_to_u8(torch.from_numpy(np.array(want)))[0].numpy())
        for b in range(B):
            solo, solo_iters = km.fit_restarts(
                torch.from_numpy(pixels[b] if pixels.ndim == 3 else pixels), k, 11,
                restarts=restarts, k_active=None if k_actives is None else k_actives[b],
                metric=metric)
            assert iters[b] == solo_iters and torch.equal(got[b], solo)


def _image(h, w, seed):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.fixture(scope="module")
def processors():
    return kmeans_tpu.ImageProcessor(), kt.ImageProcessor(device="cpu")


def _assert_close(got, want, mode, what):
    assert len(got) == len(want)
    n = sum(w.pixels.shape[0] * w.pixels.shape[1] for w in want)
    step = np.concatenate([
        np.abs(g.pixels.astype(int) - w.pixels.astype(int)).max(-1).reshape(-1)
        for g, w in zip(got, want)])
    assert all(g.dimensions == w.dimensions for g, w in zip(got, want))
    differ = int((step > 0).sum())
    print(f"{what} {mode}: {differ} of {n} pixels differ, max step {step.max()}")
    if mode == "MELD":
        assert step.max() <= 1 and differ <= n // 1000
    else:
        assert differ <= n // 10000


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_batch_entry_points_match_reference(processors, mode):
    """`reduce_images` at k = 6, `find_batch` with 12 colours and
    `reduce_batch` at ks (2, 5, 9) on 3 frames of 24x37 against the
    reference processor (its CPU routes: the vmapped trainer and XLA
    quantizer)."""
    ref, port = processors
    frames = [_image(24, 37, seed=140 + f) for f in range(B)]
    colors = np.random.default_rng(150).integers(0, 256, (12, 3), dtype=np.uint8)
    ref_mode, port_mode = getattr(kmeans_tpu.ReduceMode, mode), getattr(kt.ReduceMode, mode)
    _assert_close(port.reduce_images(frames, 6, port_mode),
                  ref.reduce_images(frames, 6, ref_mode), mode, "reduce_images k=6")
    _assert_close(port.find_batch(frames, colors, port_mode),
                  ref.find_batch(frames, colors, ref_mode), mode, "find_batch 12 colours")
    _assert_close(port.reduce_batch(frames[0], [2, 5, 9], port_mode),
                  ref.reduce_batch(frames[0], [2, 5, 9], ref_mode), mode,
                  "reduce_batch ks (2, 5, 9)")


def test_palette_images_matches_reference(processors):
    ref, port = processors
    frames = [_image(24, 37, seed=160 + f) for f in range(B)]
    got = port.palette_images(frames, 7)
    assert got.shape == (7, 4) and (got[:, 3] == 255).all()
    np.testing.assert_array_equal(got, ref.palette_images(frames, 7))
    # A host algorithm runs once over every frame's pixels, as the reference's.
    np.testing.assert_array_equal(port.palette_images(frames, 7, kt.Algorithm.WU),
                                  ref.palette_images(frames, 7, kmeans_tpu.Algorithm.WU))


def test_batches_reach_past_1024_colours(processors):
    """`reduce_images` and `find_batch` past 1024 colours take the
    colour-out frames mode and the colour-out pass on 2 frames of 16x16;
    `find_batch` equals the reference's, `reduce_images` each frame's
    `reduce` (a batch member's training is its solo training)."""
    ref, port = processors
    frames = [_image(16, 16, seed=170 + f) for f in range(2)]
    colors = np.random.default_rng(171).integers(0, 256, (1025, 3), dtype=np.uint8)
    _assert_close(port.find_batch(frames, colors, kt.ReduceMode.DITHER),
                  ref.find_batch(frames, colors, kmeans_tpu.ReduceMode.DITHER), "DITHER",
                  "find_batch 1025 colours")
    got = port.reduce_images(frames, 1025)
    for f in range(2):
        np.testing.assert_array_equal(got[f].pixels, port.reduce(1025, frames[f]).pixels)


def test_batch_entry_points_refuse_what_they_do_not_take(processors):
    _, port = processors
    with pytest.raises(ValueError, match="share dimensions"):
        port.reduce_images([_image(8, 8, 1), _image(8, 9, 1)], 4)
    with pytest.raises(ValueError, match="at least one"):
        port.find_batch([], [[0, 0, 0]])
    with pytest.raises(ValueError, match="color count"):
        port.reduce_batch(_image(8, 8, 1), [])
    with pytest.raises(ValueError):
        port.reduce_batch(_image(8, 8, 1), [4, 0])
