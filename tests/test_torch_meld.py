"""PyTorch port vs the JAX package: meld (`ReduceMode.MELD`).

The same numpy-seeded inputs go through `kmeans_tpu` (JAX on the CPU) and
`kmeans_tpu_torch` (plain PyTorch on the CPU). Tolerance everywhere: every
channel within 1 u8 step, and at most 1e-3 of the pixels differing at all
(the differing ones are counted). Differences come from near-ties and
blend factors decided by an ulp: the reference's jitted XLA chain may
contract float ops into FMAs, the port's cube root is torch's `pow`, and
under CIEDE2000 the reference's Pallas kernel takes its hue from a
polynomial atan2. Two palette entries of one colour make the blend NaN
for the pixels nearest to them; the reference writes those black, and so
must the port.
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
from kmeans_tpu.utils.packing import _unpack_rgb24_np as ref_unpack_rgb24
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops import quantize as q
from kmeans_tpu_torch.utils.packing import unpack_rgb24_tile_words

torch.set_num_threads(2)


def _case(h, w, k, seed, repeat=False):
    """Random RGBA and a Lab palette of `k` random colours; with `repeat`
    the last colour repeats the first."""
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    colors = rng.integers(0, 256, (k, 3), dtype=np.uint8)
    if repeat:
        colors[-1] = colors[0]
    return rgba, np.array(ref_lab(jnp.asarray(colors)))


def _assert_close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8
    step = np.abs(got.astype(int) - want.astype(int)).max(-1)
    differ = int((step > 0).sum())
    print(f"{what}: {differ} of {step.size} pixels differ, max step {step.max()}")
    assert step.max() <= 1 and differ <= step.size // 1000


QUANTIZE_CASES = [
    # (k, k_active, metric[, repeat]). k = 1 is the single colour under
    # either metric; k_active < kp and a repeated colour ride on k = 8.
    (1, None, "cie94"), (2, None, "cie94"), (8, 6, "cie94"), (65, None, "cie94"),
    (2, None, "cie2000"), (8, None, "cie2000", True), (65, None, "cie2000"),
]


def _ref_quantize_meld(rgba, pal, k_active=None, metric="cie94"):
    """The reference's `quantize_image(mode="meld")`. Above 64 colours an
    `[H, W, 4]` image takes its row-chunked meld, which pads every call to
    a 2^26-element chunk (about 10 s on one CPU core), so those pixels go
    in flattened to `[N, 4]`: the same per-pixel function without chunks."""
    flat = rgba.reshape(-1, 4) if pal.shape[0] > 64 else rgba
    out = ref_q.quantize_image(jnp.asarray(flat), jnp.asarray(pal), mode="meld",
                               k_active=k_active, metric=metric)
    return np.asarray(out).reshape(rgba.shape)


@pytest.mark.parametrize("case", QUANTIZE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_quantize_image_meld_matches_reference(case, monkeypatch):
    """The plain meld output pass (`ops/quantize.py`) against the
    reference's XLA one. k = 65 runs the port's row-chunked `_meld_chunked`
    over several chunks (its chunk budget lowered by monkeypatch)."""
    monkeypatch.setattr(q, "_MELD_CHUNK_ELEMS", 64 * 65 * 10)
    k, k_active, metric = case[:3]
    rgba, pal = _case(64, 64, k, seed=k + 3, repeat=len(case) > 3)
    want = _ref_quantize_meld(rgba, pal, k_active, metric)
    got = q.quantize_image(torch.from_numpy(rgba), torch.from_numpy(pal), "meld",
                           k_active, metric=metric).numpy()
    _assert_close(got, want, f"quantize_image meld k={k} k_active={k_active} {metric}")


@pytest.mark.parametrize(
    "h,w,k,metric,repeat",
    [(37, 53, 1, "cie94", False), (61, 97, 8, "cie94", True),
     (29, 41, 17, "cie2000", True)],
)
def test_twin_matches_pallas_kernel(h, w, k, metric, repeat):
    """`meld_packed_reference` against `fused_meld_packed(interpret=True)`:
    the same word layout, compared after unpacking (k = 17 takes the
    128-row tiles)."""
    rgba, pal = _case(h, w, k, seed=10 * k + h, repeat=repeat)
    want = np.asarray(ref_k.fused_meld_packed(
        jnp.asarray(rgba), jnp.asarray(pal), metric=metric, interpret=True))
    got = kernels.meld_packed_reference(
        torch.from_numpy(np.ascontiguousarray(rgba[..., :3])), torch.from_numpy(pal),
        metric=metric,
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    rows = kernels.quant_tile_rows(k)
    _assert_close(unpack_rgb24_tile_words(got, h, w, rows), ref_unpack_rgb24(want, h, w, rows),
                  f"meld words {h}x{w} k={k} {metric}")
    if repeat:  # the pixels whose two closest are the repeated colour are black
        assert (unpack_rgb24_tile_words(got, h, w, rows)[..., :3] == 0).all(-1).any()


def test_twin_above_the_kernel_cap_matches_reference():
    """k = 1025: the reference has no meld kernel above 1024 and takes its
    XLA meld; the port's twin (and kernel) serve it in one pass."""
    rgba, pal = _case(16, 16, 1025, seed=11)
    want = _ref_quantize_meld(rgba, pal)
    words = kernels.meld_packed(torch.from_numpy(np.ascontiguousarray(rgba[..., :3])),
                                torch.from_numpy(pal))
    got = unpack_rgb24_tile_words(words.numpy(), 16, 16, kernels.quant_tile_rows(1025))
    _assert_close(got, want, "meld k=1025")


def test_unpack_rgb24_matches_reference():
    rng = np.random.default_rng(12)
    for rows, h, w in ((256, 300, 201), (128, 17, 1000)):
        words = rng.integers(-(1 << 31), 1 << 31, (3 * rows // 4 * 6, 128), dtype=np.int64)
        words = words.astype(np.int32)
        np.testing.assert_array_equal(unpack_rgb24_tile_words(words, h, w, rows),
                                      ref_unpack_rgb24(words, h, w, rows))


def test_wrapper_rules():
    kernels.LAUNCHES_BY_MODE.clear()
    rgba, pal = _case(8, 8, 4, seed=13)
    rgb, cents = torch.from_numpy(np.ascontiguousarray(rgba[..., :3])), torch.from_numpy(pal)
    assert torch.equal(kernels.meld_packed(rgb, cents, 3), kernels.meld_packed_reference(rgb, cents, 3))
    assert kernels.launches("meld_packed") == 0
    with pytest.raises(ValueError, match="unknown metric"):
        kernels.meld_packed(rgb, cents, metric="cie76")
    with pytest.raises(ValueError, match="k_active"):
        kernels.meld_packed(rgb, cents, 5)
    with pytest.raises(ValueError):
        kernels.meld_packed(rgb.float(), cents)


def _image(h, w, seed):
    """Gradient-plus-noise RGBA (the benchmark's synthetic recipe)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def test_reduce_and_find_match_reference():
    """`reduce(8, ..., MELD)` and `find(..., MELD)` with 16 colours, one of
    them repeated, under CIE94, against the reference processor."""
    ref, port = kmeans_tpu.ImageProcessor(), kt.ImageProcessor(device="cpu")
    img = _image(90, 120, seed=14)
    want = ref.reduce(8, img, reduce_mode=kmeans_tpu.ReduceMode.MELD).pixels
    got = port.reduce(8, img, reduce_mode=kt.ReduceMode.MELD)
    assert got.dimensions == (120, 90) and (got.pixels[..., 3] == 255).all()
    _assert_close(got.pixels, want, "reduce k=8 meld")
    colors = np.random.default_rng(15).integers(0, 256, (16, 3), dtype=np.uint8)
    colors[9] = colors[2]
    want = ref.find(img, colors, kmeans_tpu.ReduceMode.MELD).pixels
    got = port.find(img, colors, kt.ReduceMode.MELD).pixels
    _assert_close(got, want, "find 16 colours meld")
