"""The port on a CUDA card: the hand-written kernels against their plain twins.

These tests need a card and skip without one. This file imports neither
JAX nor `kmeans_tpu`, so it also runs where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`tests/conftest.py` configures JAX, hence `--noconftest` there).
"""

import numpy as np
import pytest
import torch

from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import distance_cie2000_sq
from kmeans_tpu_torch.ops.quantize import dither_threshold, dither_thresholds
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_rgb24_tile_words, unpack_tile_words

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(h, w, k, seed, device):
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    pal = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(device)
    return rgb, srgb8_to_lab(pal).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replace", "dither"])
@pytest.mark.parametrize("k", [1, 4, 8, 17, 257, 1024])
def test_kernel_matches_twin(cuda, k, mode):
    rgb, cents = _case(61, 97, k, 500 + k, cuda)
    thr = dither_threshold(cents) if mode == "dither" else 0.0
    before = kernels.launches("assign_packed")
    got = kernels.assign_packed(rgb, cents, thr, mode=mode, row_offset=1)
    want = kernels.assign_packed_reference(rgb, cents, thr, mode=mode, row_offset=1)
    torch.cuda.synchronize()
    assert kernels.launches("assign_packed") == before + 1
    assert torch.equal(got, want)


def _index_flips(got, want, h, w, k):
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    gi = unpack_tile_words(got.cpu().numpy(), h, w, bits, rows).astype(np.int64)
    wi = unpack_tile_words(want.cpu().numpy(), h, w, bits, rows).astype(np.int64)
    return np.flatnonzero(gi != wi), gi.reshape(-1), wi.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("replace", 8), ("dither", 17), ("replace", 300)])
def test_cie2000_kernel_matches_twin(cuda, mode, k):
    """CIEDE2000 assign: flips are counted, and each must be a near-tie
    (the twin's two distances within 1e-5 of each other)."""
    rgb, cents = _case(61, 97, k, 700 + k, cuda)
    thr = dither_threshold(cents, metric="cie2000") if mode == "dither" else 0.0
    got = kernels.assign_packed(rgb, cents, thr, mode=mode, metric="cie2000")
    want = kernels.assign_packed_reference(rgb, cents, thr, mode=mode, metric="cie2000")
    flips, gi, wi = _index_flips(got, want, 61, 97, k)
    if len(flips) and mode == "replace":
        lab = srgb8_to_lab(rgb.reshape(-1, 3))[flips]
        dg = distance_cie2000_sq(lab, cents[gi[flips]])
        dw = distance_cie2000_sq(lab, cents[wi[flips]])
        assert ((dg - dw).abs() <= 1e-5 * torch.maximum(dg, dw)).all()
    assert len(flips) <= 61 * 97 // 10000


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,metric,repeat",
    [(1, "cie94", False), (2, "cie2000", False), (8, "cie94", True), (17, "cie2000", True),
     (256, "cie94", False), (1025, "cie2000", False)],
)
def test_meld_kernel_matches_twin(cuda, k, metric, repeat):
    """CIE94: equal words; CIEDE2000: every channel within 1 u8 step on at
    most 1e-4 of the pixels. A repeated colour writes black as the twin."""
    rgb, cents = _case(61, 97, k, 800 + k, cuda)
    if repeat:
        cents[-1] = cents[0]
    before = kernels.launches("meld_packed")
    got = kernels.meld_packed(rgb, cents, metric=metric)
    want = kernels.meld_packed_reference(rgb, cents, metric=metric)
    torch.cuda.synchronize()
    assert kernels.launches("meld_packed") == before + 1
    if metric == "cie94":
        assert torch.equal(got, want)
    rows = kernels.quant_tile_rows(k)
    a = unpack_rgb24_tile_words(got.cpu().numpy(), 61, 97, rows).astype(int)
    b = unpack_rgb24_tile_words(want.cpu().numpy(), 61, 97, rows).astype(int)
    step = np.abs(a - b).max(-1)
    assert step.max() <= 1 and (step > 0).sum() <= 61 * 97 // 10000


@pytest.mark.cuda
def test_reduce_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:90, 0:130]
    rgb = np.stack([x * 255 // 130, y * 255 // 90, (x + y) * 255 // 220], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    img = np.concatenate([rgb, np.full((90, 130, 1), 255, np.uint8)], -1)
    before = kernels.launches("assign_packed")
    on_card = ImageProcessor().reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels
    assert kernels.launches("assign_packed") == before + 1
    on_cpu = ImageProcessor(device="cpu").reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels
    np.testing.assert_array_equal(on_card, on_cpu)


def _planes(n, k, seed, device, bf16=False):
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (n, 3), dtype=np.uint8)).to(device)
    planes, n_valid = kernels.pack_lab_planes(
        srgb8_to_lab(rgb), torch.bfloat16 if bf16 else None
    )
    _, cents = _case(1, 1, k, seed + 1, device)
    return planes, cents, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,k_active,inertia,bf16,metric",
    [(1, None, False, False, "cie94"), (8, None, True, False, "cie94"),
     (17, 11, True, False, "cie94"), (65, None, False, True, "cie94"),
     (512, 300, True, False, "cie94"), (8, None, True, False, "cie2000"),
     (65, 40, False, True, "cie2000")],
)
def test_accumulator_kernel_matches_twin(cuda, k, k_active, inertia, bf16, metric):
    """Counts equal; the other columns within 1e-5 * (|twin| + 128 * count);
    a second launch gives the same totals."""
    planes, cents, n = _planes(40_001, k, 600 + k, cuda, bf16)
    before = kernels.launches("lloyd_accumulate")
    args = (planes, cents, n, k_active)
    got = kernels.lloyd_accumulate(*args, emit_inertia=inertia, metric=metric)
    again = kernels.lloyd_accumulate(*args, emit_inertia=inertia, metric=metric)
    want = kernels.lloyd_accumulate_reference(*args, emit_inertia=inertia, metric=metric)
    torch.cuda.synchronize()
    assert kernels.launches("lloyd_accumulate") == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[:, 3], want[:, 3])
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.cuda
def test_full_resolution_palette_on_card_matches_cpu(cuda, monkeypatch):
    from kmeans_tpu_torch import api

    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 1000)
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:90, 0:130]
    rgb = np.stack([x * 255 // 130, y * 255 // 90, (x + y) * 255 // 220], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    img = np.concatenate([rgb, np.full((90, 130, 1), 255, np.uint8)], -1)
    before = kernels.launches("lloyd_accumulate")
    card = ImageProcessor(train_max_size=None)
    on_card = card.palette(8, img)
    assert kernels.launches("lloyd_accumulate") == before + card.last_iterations
    on_cpu = ImageProcessor(device="cpu", train_max_size=None).palette(8, img)
    np.testing.assert_array_equal(on_card, on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("delta_e", ["94", "2000"])
def test_meld_and_cie2000_reduce_on_card_match_cpu(cuda, delta_e):
    """Meld reduce and find, and a dither reduce, on the card against the
    CPU: within 1 u8 step on at most 1e-3 of the pixels for meld (its blend
    sees the last bits of the centroids and of each device's powf, atan2,
    sin and cos), 1e-4 for dither."""
    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:90, 0:130]
    rgb = np.stack([x * 255 // 130, y * 255 // 90, (x + y) * 255 // 220], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    img = np.concatenate([rgb, np.full((90, 130, 1), 255, np.uint8)], -1)
    colors = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    card, cpu = ImageProcessor(delta_e=delta_e), ImageProcessor(device="cpu", delta_e=delta_e)
    before = kernels.launches("meld_packed")
    pairs = [(card.reduce(8, img, reduce_mode=ReduceMode.MELD).pixels,
              cpu.reduce(8, img, reduce_mode=ReduceMode.MELD).pixels),
             (card.find(img, colors, ReduceMode.MELD).pixels,
              cpu.find(img, colors, ReduceMode.MELD).pixels),
             (card.reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels,
              cpu.reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels)]
    assert kernels.launches("meld_packed") == before + 2
    np.testing.assert_array_equal(card.palette(8, img), cpu.palette(8, img))
    for (on_card, on_cpu), bar in zip(pairs, (1e-3, 1e-3, 1e-4)):
        step = np.abs(on_card.astype(int) - on_cpu.astype(int)).max(-1)
        assert step.max() <= 1 and (step > 0).sum() <= bar * 90 * 130


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize(
    "k,k_active,mode",
    [(17, None, "replace"), (64, 5, "dither"), (129, None, "replace"), (256, 12, "dither"),
     (512, None, "replace"), (513, None, "replace")],
)
def test_fast_assign_kernel_matches_twin(cuda, k, k_active, mode, metric):
    """The factorized CIE94 and pruned CIEDE2000 assign tiers: equal words.
    `k_active` 5 and 12 leave candidate slots unfilled (m = 8, 16); k = 513
    runs exact."""
    rgb, cents = _case(61, 97, k, 900 + k, cuda)
    thr = dither_threshold(cents, k_active, metric) if mode == "dither" else 0.0
    before = kernels.launches("assign_packed")
    got = kernels.assign_packed(rgb, cents, thr, k_active, mode, 2, metric, fast=True)
    want = kernels.assign_packed_reference(rgb, cents, thr, k_active, mode, 2, metric, fast=True)
    torch.cuda.synchronize()
    assert kernels.launches("assign_packed") == before + 1
    assert torch.equal(got, want)
    if k == 513:
        assert torch.equal(got, kernels.assign_packed(rgb, cents, thr, k_active, mode, 2, metric))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("k,k_active", [(17, None), (64, 5), (129, 12), (512, None), (513, None)])
def test_fast_meld_kernel_matches_twin(cuda, k, k_active, metric):
    """The factorized CIE94 and pruned CIEDE2000 meld tiers: equal words."""
    rgb, cents = _case(61, 97, k, 950 + k, cuda)
    before = kernels.launches("meld_packed")
    got = kernels.meld_packed(rgb, cents, k_active, metric, fast=True)
    want = kernels.meld_packed_reference(rgb, cents, k_active, metric, fast=True)
    torch.cuda.synchronize()
    assert kernels.launches("meld_packed") == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,k_active,inertia,bf16,metric",
    [(8, None, False, False, "cie94"), (24, 20, False, True, "cie94"),   # factorized
     (8, None, True, False, "cie94"), (300, None, True, False, "cie94"),  # algebraic
     (24, None, True, False, "cie2000"), (129, 12, False, False, "cie2000"),  # pruned
     (512, None, True, True, "cie2000"), (16, None, True, False, "cie2000")],  # exact
)
def test_fast_accumulator_kernel_matches_twin(cuda, k, k_active, inertia, bf16, metric):
    """The accumulator's fast forms: counts equal, the other columns within
    1e-5 * (|twin| + 128 * count), equal totals twice."""
    planes, cents, n = _planes(40_001, k, 1000 + k, cuda, bf16)
    args = (planes, cents, n, k_active)
    kwargs = {"emit_inertia": inertia, "metric": metric, "fast": True}
    before = kernels.launches("lloyd_accumulate")
    got = kernels.lloyd_accumulate(*args, **kwargs)
    again = kernels.lloyd_accumulate(*args, **kwargs)
    want = kernels.lloyd_accumulate_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernels.launches("lloyd_accumulate") == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[:, 3], want[:, 3])
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("delta_e", ["94", "2000"])
def test_fast_reduce_on_card_matches_cpu(cuda, delta_e):
    """`ImageProcessor(fast=True)` at k = 24 on the card against the CPU:
    replace within 1e-4 of the pixels, meld within 1 u8 step on 1e-3."""
    rng = np.random.default_rng(10)
    y, x = np.mgrid[0:90, 0:130]
    rgb = np.stack([x * 255 // 130, y * 255 // 90, (x + y) * 255 // 220], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    img = np.concatenate([rgb, np.full((90, 130, 1), 255, np.uint8)], -1)
    card = ImageProcessor(delta_e=delta_e, fast=True)
    cpu = ImageProcessor(device="cpu", delta_e=delta_e, fast=True)
    np.testing.assert_array_equal(card.palette(24, img), cpu.palette(24, img))
    for mode, bar in ((ReduceMode.REPLACE, 1e-4), (ReduceMode.MELD, 1e-3)):
        on_card = card.reduce(24, img, reduce_mode=mode).pixels.astype(int)
        on_cpu = cpu.reduce(24, img, reduce_mode=mode).pixels.astype(int)
        step = np.abs(on_card - on_cpu).max(-1)
        assert (step > 0).sum() <= bar * 90 * 130
        assert mode is ReduceMode.REPLACE or step.max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,mode,metric,chunk",
    [(1, "replace", "cie94", None), (8, "dither", "cie94", None),
     (1025, "replace", "cie94", None), (2048, "dither", "cie94", None),
     (17, "dither", "cie2000", None), (300, "replace", "cie94", 64),
     (300, "dither", "cie2000", 64)],
)
def test_colour_out_kernel_matches_twin(cuda, k, mode, metric, chunk, monkeypatch):
    """`quantize_rgba` (the assign kernel's colour-out mode) against its
    twin: equal RGBA. `chunk` lowers `STAGE_CHUNK` so that k = 300 takes
    the chunked instance (the palette staged 64 centroids at a time)."""
    if chunk:
        monkeypatch.setattr(kernels, "STAGE_CHUNK", chunk)
    rgb, cents = _case(61, 97, k, 1100 + k, cuda)
    thr = dither_threshold(cents, metric=metric) if mode == "dither" else 0.0
    before = dict(kernels.LAUNCHES_BY_MODE)
    got = kernels.quantize_rgba(rgb, cents, thr, mode=mode, row_offset=1, metric=metric)
    want = kernels.quantize_rgba_reference(rgb, cents, thr, mode=mode, row_offset=1,
                                           metric=metric)
    torch.cuda.synchronize()
    tier = "exact-chunked" if chunk else "exact"
    assert kernels.LAUNCHES_BY_MODE["quantize_rgba", metric, tier] == before.get(
        ("quantize_rgba", metric, tier), 0) + 1
    assert got.shape == (61, 97, 4) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,mode", [(8, "replace"), (256, "dither")])
def test_u8_index_kernel_matches_twin(cuda, k, mode):
    rgb, cents = _case(61, 97, k, 1200 + k, cuda)
    thr = dither_threshold(cents) if mode == "dither" else 0.0
    got = kernels.assign_u8(rgb, cents, thr, mode=mode)
    want = kernels.assign_u8_reference(rgb, cents, thr, mode=mode)
    assert got.shape == (61, 97) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,metric,chunk", [(16384, "cie94", None), (300, "cie94", 64),
                                            (300, "cie2000", 64)])
def test_meld_kernel_at_any_palette_size(cuda, k, metric, chunk, monkeypatch):
    """The meld kernel past one shared-memory chunk of centroids (16,384
    colours, or 300 with 64-centroid chunks) against its twin: CIE94 equal
    words, CIEDE2000 within 1 u8 step on at most 1e-4 of the pixels."""
    if chunk:
        monkeypatch.setattr(kernels, "STAGE_CHUNK", chunk)
    rgb, cents = _case(29, 41, k, 1300 + k, cuda)
    cents[-1] = cents[0]
    before = kernels.LAUNCHES_BY_MODE["meld_packed", metric, "exact-chunked"]
    got = kernels.meld_packed(rgb, cents, metric=metric)
    want = kernels.meld_packed_reference(rgb, cents, metric=metric)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES_BY_MODE["meld_packed", metric, "exact-chunked"] == before + 1
    if metric == "cie94":
        assert torch.equal(got, want)
    rows = kernels.quant_tile_rows(k)
    a = unpack_rgb24_tile_words(got.cpu().numpy(), 29, 41, rows).astype(int)
    b = unpack_rgb24_tile_words(want.cpu().numpy(), 29, 41, rows).astype(int)
    step = np.abs(a - b).max(-1)
    assert step.max() <= 1 and (step > 0).sum() <= 29 * 41 // 10000


def _frames(b, h, w, k, seed, device):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)
    pal = torch.from_numpy(rng.integers(0, 256, (b, k, 3), dtype=np.uint8)).to(device)
    return frames, srgb8_to_lab(pal).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize(
    "form,k,shared,fast",
    [("packed", 8, False, False), ("packed", 257, True, False), ("packed", 64, False, True),
     ("meld", 17, False, False), ("meld", 64, True, True),
     ("rgba", 1025, False, False), ("rgba", 17, True, False)],
)
def test_frames_kernels_match_twins(cuda, form, k, shared, fast, metric):
    """One launch over 3 frames of 30x41 (H not a multiple of 4: each
    frame's dither phase restarts at its own row 0), each with its own
    palette, `k_active` and threshold; `shared` puts one image through the
    three palettes (frame stride 0). Equal words (meld under CIEDE2000:
    within 1 u8 step on 1e-4 of the pixels)."""
    frames, cents = _frames(3, 30, 41, k, 1400 + k, cuda)
    if shared:
        frames = frames[0][None].expand(3, 30, 41, 3)
    k_actives = [k, max(1, k // 2), max(1, k - 3)]
    thr = dither_thresholds(cents, k_actives, metric)
    name = {"packed": "assign_frames_packed", "meld": "meld_frames_packed",
            "rgba": "quantize_frames"}[form]
    before = kernels.launches(name)
    if form == "meld":
        got = kernels.meld_frames_packed(frames, cents, k_actives, metric, fast)
        want = kernels.meld_frames_packed_reference(frames, cents, k_actives, metric, fast)
    else:
        call = kernels.assign_frames_packed if form == "packed" else kernels.quantize_frames
        twin = (kernels.assign_frames_packed_reference if form == "packed"
                else kernels.quantize_frames_reference)
        got = call(frames, cents, thr, k_actives, "dither", metric, fast)
        want = twin(frames, cents, thr, k_actives, "dither", metric, fast)
    torch.cuda.synchronize()
    assert kernels.launches(name) == before + 1
    assert got.shape == want.shape
    if form != "meld" or metric == "cie94":
        assert torch.equal(got, want)
    else:
        rows = kernels.quant_tile_rows(k)
        for f in range(3):
            a = unpack_rgb24_tile_words(got[f].cpu().numpy(), 30, 41, rows).astype(int)
            b = unpack_rgb24_tile_words(want[f].cpu().numpy(), 30, 41, rows).astype(int)
            step = np.abs(a - b).max(-1)
            assert step.max() <= 1 and (step > 0).sum() <= 30 * 41 // 10000


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [ReduceMode.DITHER, ReduceMode.MELD])
def test_batch_entry_points_on_card_match_cpu(cuda, mode):
    """`reduce_images`, `reduce_batch` (one frames launch each),
    `find_batch` (one launch) and `palette_images` on the card against the
    CPU: equal palettes; dither within 1e-4 of the pixels, meld within 1
    u8 step on 1e-3."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:45, 0:70]
    frames = []
    for f in range(3):
        rgb = np.stack([x * 255 // 70, y * 255 // 45, (x + y + 20 * f) * 255 // 155], -1)
        rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
        frames.append(np.concatenate([rgb, np.full((45, 70, 1), 255, np.uint8)], -1))
    colors = rng.integers(0, 256, (12, 3), dtype=np.uint8)
    card, cpu = ImageProcessor(), ImageProcessor(device="cpu")
    kernels.LAUNCHES_BY_MODE.clear()
    on_card = [card.reduce_images(frames, 8, mode), card.reduce_batch(frames[0], [3, 8], mode),
               card.find_batch(frames, colors, mode)]
    frames_name = "meld_frames_packed" if mode is ReduceMode.MELD else "assign_frames_packed"
    single = "meld_packed" if mode is ReduceMode.MELD else "assign_packed"
    assert kernels.launches(frames_name) == 2 and kernels.launches(single) == 1
    on_cpu = [cpu.reduce_images(frames, 8, mode), cpu.reduce_batch(frames[0], [3, 8], mode),
              cpu.find_batch(frames, colors, mode)]
    np.testing.assert_array_equal(card.palette_images(frames, 8), cpu.palette_images(frames, 8))
    bar = 1e-3 if mode is ReduceMode.MELD else 1e-4
    for got, want in zip(on_card, on_cpu):
        for a, b in zip(got, want):
            step = np.abs(a.pixels.astype(int) - b.pixels.astype(int)).max(-1)
            assert step.max() <= (1 if mode is ReduceMode.MELD else 255)
            assert (step > 0).sum() <= bar * 45 * 70


# --- TF32 settings, frames past the grid limit, the threshold kernel, the
# experiment kernels --------------------------------------------------------


def _set_tf32(how):
    """Turn TF32 matmuls on through one of torch's two APIs; return a
    callable that restores the caller's setting exactly: the legacy flag
    by the legacy API, then the new API's value (each API reads the other's
    writes, and a mix makes some reads raise)."""
    m = torch.backends.cuda.matmul
    new_api = hasattr(m, "fp32_precision")
    if how == "fp32_precision" and not new_api:
        pytest.skip("this torch has no fp32_precision API")
    saved_new = m.fp32_precision if new_api else None
    saved_legacy = m.allow_tf32 if how == "allow_tf32" else None

    def restore():
        if how == "allow_tf32":
            m.allow_tf32 = saved_legacy
        if new_api:
            m.fp32_precision = saved_new

    if how == "allow_tf32":
        m.allow_tf32 = True
    else:
        m.fp32_precision = "tf32"
    return restore


def _matmul_flags():
    """Every matmul-precision read torch offers; a read that raises (mixed
    APIs) is recorded as such."""
    m = torch.backends.cuda.matmul
    reads = {"precision": torch.get_float32_matmul_precision,
             "allow_tf32": lambda: m.allow_tf32}
    if hasattr(m, "fp32_precision"):
        reads["fp32_precision"] = lambda: m.fp32_precision
    flags = {}
    for name, read in reads.items():
        try:
            flags[name] = read()
        except RuntimeError:
            flags[name] = "raises"
    return flags


def _gradient_frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for f in range(n):
        rgb = np.stack([x * 255 // w, y * 255 // h, (x + y + 20 * f) * 255 // (h + w)], -1)
        rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
        out.append(np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["allow_tf32", "fp32_precision"])
def test_training_under_tf32_equals_without(cuda, how, monkeypatch):
    """The shrunk, batched and row-chunked trainers give the same outputs
    with TF32 matmuls on as off, and the caller's flags read back
    unchanged."""
    from kmeans_tpu_torch import api

    monkeypatch.setattr(api, "_CHUNKED_TRAIN_ELEMS", 1000)
    frames = _gradient_frames(3, 45, 70, 21)
    proc, full = ImageProcessor(), ImageProcessor(train_max_size=None)

    def run():
        return ([proc.reduce(8, frames[0]).pixels]
                + [r.pixels for r in proc.reduce_images(frames, 8)]
                + [full.palette(600, frames[1])])

    before = _matmul_flags()
    want = run()
    restore = _set_tf32(how)
    try:
        assert _matmul_flags() != before
        got = run()
    finally:
        restore()
    assert _matmul_flags() == before
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "meld"])
def test_frames_past_the_grid_limit(cuda, form):
    """65,537 frames of 4x4 in one wrapper call: the words equal launches
    over [0, 65535) and [65535, 65537) apart, and the twins on frames 0,
    65534, 65535 and 65536."""
    b, k = 65_537, 8
    rng = np.random.default_rng(31)
    frames = torch.from_numpy(rng.integers(0, 256, (b, 4, 4, 3), dtype=np.uint8)).to(cuda)
    pal = torch.from_numpy(rng.integers(0, 256, (b, k, 3), dtype=np.uint8)).to(cuda)
    cents = srgb8_to_lab(pal).contiguous()
    k_actives = [1 + f % k for f in range(b)]
    thr = dither_thresholds(cents, k_actives)

    def run(sl):
        if form == "meld":
            return kernels.meld_frames_packed(frames[sl], cents[sl], k_actives[sl])
        return kernels.assign_frames_packed(frames[sl], cents[sl], thr[sl], k_actives[sl],
                                            mode="dither")

    whole = run(slice(None))  # each frame pads to a 32,768-pixel tile: GBs of words
    assert torch.equal(whole[:65_535], run(slice(0, 65_535)))
    assert torch.equal(whole[65_535:], run(slice(65_535, None)))
    for f in (0, 65_534, 65_535, 65_536):
        if form == "meld":
            want = kernels.meld_packed_reference(frames[f], cents[f], k_actives[f])
        else:
            want = kernels.assign_packed_reference(frames[f], cents[f], thr[f], k_actives[f],
                                                   mode="dither")
        assert torch.equal(whole[f], want.reshape(whole[f].shape))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 257])
def test_dither_threshold_kernel_matches_twin(cuda, k, metric):
    from kmeans_tpu_torch.ops.quantize import (
        dither_threshold_reference,
        dither_thresholds_reference,
    )

    _, cents = _case(1, 1, k, 900 + k, cuda)
    before = kernels.launches("dither_threshold")
    got = dither_threshold(cents, metric=metric)
    assert kernels.launches("dither_threshold") == before + 1
    assert got.view(torch.int32) == dither_threshold_reference(cents, metric=metric).view(
        torch.int32)
    palettes = torch.stack([_case(1, 1, k, 950 + f, cuda)[1] for f in range(3)])
    k_actives = [k, max(1, k // 2), 1]
    got = dither_thresholds(palettes, k_actives, metric)
    want = dither_thresholds_reference(palettes, k_actives, metric)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


THRESHOLD_KINDS = ("random", "every_step", "duplicates", "nan_inf", "k_active")


def _threshold_palette(kind, k, seed, device):
    """`(palette [k, 3], k_active)` of one adversarial kind for the
    threshold's first-trigger scan (as `tests/test_torch_threshold_scan.py`)."""
    from kmeans_tpu_torch.tools.threshold_walk import every_step_palette

    rng = np.random.default_rng(seed)
    if kind == "every_step":
        return every_step_palette(k, device), k
    pal = np.stack([rng.uniform(0, 100, k), rng.uniform(-60, 60, k),
                    rng.uniform(-60, 60, k)], axis=1).astype(np.float32)
    if kind == "duplicates" and k > 1:
        pal[k // 2:] = pal[: k - k // 2]
        pal[rng.integers(0, k, k // 3)] = pal[0]
    if kind == "nan_inf":
        specials = (np.nan, np.inf, -np.inf)
        for i in rng.choice(k, min(k, 3), replace=False):
            pal[i, rng.integers(0, 3)] = specials[rng.integers(0, 3)]
    k_active = max(1, int(rng.integers(1, k + 1))) if kind == "k_active" else k
    return torch.from_numpy(pal).to(device), k_active


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("kind", THRESHOLD_KINDS)
@pytest.mark.parametrize("k", [1, 2, 3, 33, 700])
def test_threshold_scan_adversarial(cuda, k, kind, metric):
    from kmeans_tpu_torch.ops.quantize import dither_threshold_reference

    pal, k_active = _threshold_palette(kind, k, 1200 + k, cuda)
    got = dither_threshold(pal, k_active, metric)
    want = dither_threshold_reference(pal, k_active, metric)
    assert got.view(torch.int32) == want.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_threshold_scan_ragged_frames(cuda, metric):
    """B = 6 palettes of every kind in one launch, each with its own
    `k_active` (1, 2 and 3 among them)."""
    from kmeans_tpu_torch.ops.quantize import dither_thresholds_reference

    pals = torch.stack([_threshold_palette(kind, 300, 1300 + f, cuda)[0]
                        for f, kind in enumerate(THRESHOLD_KINDS + ("random",))])
    k_actives = [300, 1, 2, 3, 150, 299]
    got = dither_thresholds(pals, k_actives, metric)
    want = dither_thresholds_reference(pals, k_actives, metric)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k", [(37, 53, 61), (61, 97, 3), (13, 7, 129), (1, 1, 1),
                                   (64, 130, 256), (5, 3, 200)])
def test_factor_mxu_ragged(cuda, h, w, k):
    """factor-mxu on pixel counts that fill no whole 128-pixel step and
    palettes of no whole 8 or 64 columns: every index a real column, every
    flip against the TF32 twin a near-tie."""
    from kmeans_tpu_torch.tools import exp_mxu

    rng = np.random.default_rng(70 + k)
    img = torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(cuda)
    cents = torch.from_numpy(exp_mxu.random_centroids(k, rng)).to(cuda)
    before = kernels.launches("exp_factor_mxu")
    mxu = exp_mxu.factor_mxu(img, cents)
    assert kernels.launches("exp_factor_mxu") == before + 1
    assert int(mxu.max()) < k
    want = exp_mxu.factor_mxu_reference(img, cents, tf32=True)
    flips, near = exp_mxu.near_ties(img, cents, mxu, want, tf32=True)
    assert near and flips <= max(1, h * w // 100)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k", [(8, 16, 64), (40, 100, 256), (37, 53, 100)])
def test_exp_mxu_kernels_match_twins(cuda, h, w, k):
    """factor-vpu equals its twin and, at 16 < k <= 256, the fast u8
    assign; factor-mxu flips against its TF32 twin only on near-ties."""
    from kmeans_tpu_torch.tools import exp_mxu

    rng = np.random.default_rng(40 + k)
    img = torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(cuda)
    cents = torch.from_numpy(exp_mxu.random_centroids(k, rng)).to(cuda)
    vpu = exp_mxu.factor_vpu(img, cents)
    assert torch.equal(vpu, exp_mxu.factor_vpu_reference(img, cents))
    assert torch.equal(vpu, kernels.assign_u8(img[..., :3].contiguous(), cents, 0.0, fast=True))
    mxu = exp_mxu.factor_mxu(img, cents)
    want = exp_mxu.factor_mxu_reference(img, cents, tf32=True)
    flips, near = exp_mxu.near_ties(img, cents, mxu, want, tf32=True)
    assert near and flips <= h * w // 100


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("h,w", [(61, 97), (1, 2053), (7, 3), (1, 1), (16, 256)])
def test_factor_vpu_ragged_and_misaligned(cuda, h, w, k):
    """factor-vpu's register tile at pixel counts past its last whole tile
    (5,917; 8 x 256 + 5; 21; 1) and at a whole number of tiles (4,096),
    and on the row slice [1:], which starts off a 16-byte boundary where
    the width is odd: each index equals the twin's, one launch a call."""
    from kmeans_tpu_torch.tools import exp_mxu

    rng = np.random.default_rng(90 + k + h)
    img = torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(cuda)
    cents = torch.from_numpy(exp_mxu.random_centroids(k, rng)).to(cuda)
    for view in [img] + ([img[1:]] if h > 1 else []):
        before = kernels.launches("exp_factor_vpu")
        got = exp_mxu.factor_vpu(view, cents)
        assert kernels.launches("exp_factor_vpu") == before + 1
        assert torch.equal(got, exp_mxu.factor_vpu_reference(view, cents))


@pytest.mark.cuda
def test_factor_vpu_launcher_refuses_misaligned_words(cuda):
    """The C launcher never reads RGBA words off a 16-byte boundary: it
    returns cudaErrorMisalignedAddress and launches nothing."""
    from kmeans_tpu_torch.ops.gamma_lut import gamma_lut
    from kmeans_tpu_torch.tools import _exp, exp_mxu

    rng = np.random.default_rng(95)
    img = torch.from_numpy(exp_mxu.random_image(61, 97, rng)).to(cuda)
    cents = torch.from_numpy(exp_mxu.random_centroids(64, rng)).to(cuda)
    words = img[1:].reshape(-1, 4).view(torch.int32)
    assert words.data_ptr() % 16 != 0
    out = torch.full((words.shape[0],), 7, dtype=torch.uint8, device=cuda)
    lib = _exp.load_exp_library()
    err = lib.exp_factor_vpu(words.data_ptr(), words.shape[0],
                             kernels.factor_g_table(cents).data_ptr(), 64,
                             gamma_lut(cuda).data_ptr(), out.data_ptr(), _exp.stream_of(out))
    torch.cuda.synchronize()
    assert err == exp_mxu.CUDA_ERROR_MISALIGNED_ADDRESS
    assert bool((out == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "constant", "global"])
def test_exp_gather_kernels_match_twins(cuda, placement):
    from kmeans_tpu_torch.tools import exp_gather

    table = exp_gather.gamma_table(cuda)
    idx = torch.from_numpy(exp_gather.gather_indices()).to(cuda)
    want = torch.from_numpy(exp_gather.gamma_table_np()[exp_gather.gather_indices()]).to(cuda)
    assert torch.equal(exp_gather.gather(table, idx, placement).view(torch.int32),
                       want.view(torch.int32))
    grid = torch.from_numpy(exp_gather.grid_indices(np.random.default_rng(5), 64)).to(cuda)
    got = exp_gather.lut_sum(table, grid, placement)
    assert torch.equal(got.view(torch.int32),
                       exp_gather.lut_sum_reference(table, grid).view(torch.int32))
    ulps = exp_gather.ulps(exp_gather.pow_sum(grid), exp_gather.pow_sum_reference(grid))
    assert int(ulps.max()) <= 8


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_constant_placement_follows_the_table(cuda):
    """Two tables in turn, then an in-place write: each call of the constant
    placement returns the current table's bits, and fills only when the
    table changed."""
    from kmeans_tpu_torch.tools import exp_gather

    fills = ("exp_lut_fill", "constant", "copy")
    idx = torch.from_numpy(exp_gather.gather_indices()).to(cuda)
    grid = torch.from_numpy(exp_gather.grid_indices(np.random.default_rng(6), 64)).to(cuda)
    first = exp_gather.gamma_table(cuda)
    other = torch.from_numpy(np.random.default_rng(8).random(256, dtype=np.float32)).to(cuda)
    for table, want_fills in ((first, 1), (other, 1), (first, 1)):
        before = kernels.LAUNCHES_BY_MODE[fills]
        for _ in range(2):
            assert _same_bits(exp_gather.gather(table, idx, "constant"),
                              exp_gather.gather_reference(table, idx))
            assert _same_bits(exp_gather.lut_sum(table, grid, "constant"),
                              exp_gather.lut_sum_reference(table, grid))
        assert kernels.LAUNCHES_BY_MODE[fills] - before == want_fills
    for write in (lambda t: t.mul_(0.5), lambda t: t[100:].copy_(other[:156])):
        write(first)
        before = kernels.LAUNCHES_BY_MODE[fills]
        assert _same_bits(exp_gather.lut_sum(first, grid, "constant"),
                          exp_gather.lut_sum_reference(first, grid))
        assert _same_bits(exp_gather.gather(first, idx, "constant"),
                          exp_gather.gather_reference(first, idx))
        assert kernels.LAUNCHES_BY_MODE[fills] - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "constant", "global"])
@pytest.mark.parametrize("n,offset", [(1, 0), (100, 0), (1001, 0), (4099, 1),
                                      (64_896 * 128, 0)])
def test_lut_kernels_at_any_length(cuda, placement, n, offset):
    """n = 1, below one block, not a multiple of 256 (nor of 4), indices off
    a 16-byte boundary (the one-element loop), and the 4K grid."""
    from kmeans_tpu_torch.tools import exp_gather

    rng = np.random.default_rng(n)
    store = torch.from_numpy(rng.integers(-300, 300, n + offset).astype(np.int32)).to(cuda)
    idx = store[offset:]
    table = exp_gather.gamma_table(cuda)
    assert _same_bits(exp_gather.lut_sum(table, idx, placement),
                      exp_gather.lut_sum_reference(table, idx))
    assert _same_bits(exp_gather.gather(table, idx, placement),
                      exp_gather.gather_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (100, 0), (1001, 0), (4099, 1),
                                      (64_896 * 128, 0)])
def test_pow_sum_at_any_length(cuda, n, offset):
    """The pow sum's 4-element loop and its one-element tail (n = 1, 100,
    1001), its one-element kernel (indices off a 16-byte boundary), and the
    4K grid, against the twin: at most 8 ulps, the sums differing counted."""
    from kmeans_tpu_torch.tools import exp_gather

    rng = np.random.default_rng(n)
    store = torch.from_numpy(rng.integers(-300, 300, n + offset).astype(np.int32)).to(cuda)
    idx = store[offset:]
    ulps = exp_gather.ulps(exp_gather.pow_sum(idx), exp_gather.pow_sum_reference(idx))
    assert int(ulps.max()) <= 8, f"{int((ulps > 0).sum())} of {n} sums differ, max {int(ulps.max())}"


@pytest.mark.cuda
def test_pow_curve_probe_on_every_input(cuda):
    """The pow kernel's own curve on all 256 inputs: each divide equals the
    true divide on every input the curve takes it on, and the curve is
    within 8 ulps of `powf`'s term (the aim: 0)."""
    from kmeans_tpu_torch.tools import exp_gather

    report = exp_gather.probe_report(exp_gather.pow_probe(cuda))
    for divide in ("divide_255", "divide_1055", "divide_1292"):
        assert report[divide]["entries_differing"] == 0, report
    assert report["curve_vs_powf"]["max_ulps"] <= 8, report


ADVERSARIAL = ["random", "duplicates", "grey", "pixel_is_centroid", "inf", "tiny", "k_active"]


def _adversarial(case, k, seed, device, h=37, w=53):
    """(rgb [h, w, 3] u8, centroids [k, 3] Lab, k_active) for the exact
    kernels' tiled loops: duplicate centroids (exact ties: the lowest index
    wins), grey pixels (chroma 0), centroids equal to pixels (zero
    dividends), a centroid at +-inf, one of chroma 1e-25 on grey pixels
    (dividends below 2^-64: the rescan), or `k_active < kp`."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if case in ("grey", "tiny"):
        rgb[..., 1] = rgb[..., 2] = rgb[..., 0]
    pal = rng.integers(0, 256, (k, 3), dtype=np.uint8)
    if case == "pixel_is_centroid":
        pal = rgb.reshape(-1, 3)[rng.choice(h * w, k, replace=False)]
    rgb = torch.from_numpy(rgb).to(device)
    cents = srgb8_to_lab(torch.from_numpy(pal).to(device)).contiguous()
    if case == "duplicates" and k > 1:
        cents[k // 2:] = cents[: k - k // 2].clone()
    if case == "inf":
        cents[k // 2] = torch.tensor([np.inf, -np.inf, np.inf], device=device)
    if case == "tiny":
        cents[0] = torch.tensor([50.0, 1e-25, 0.0], device=device)
    k_active = max(1, k - k // 3) if case == "k_active" else k
    return rgb, cents, k_active


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("k", [1, 2, 8, 17, 64, 256, 512])
def test_exact_assign_adversarial_palettes(cuda, k, case, metric):
    """The exact assign kernel's tiled loop in every output mode (packed
    replace and dither, RGBA, u8) equals its twin word for word on
    adversarial palettes and odd image sizes."""
    rgb, cents, k_active = _adversarial(case, k, 3000 + k, cuda)
    finite = cents[torch.isfinite(cents).all(-1)]
    thr = dither_threshold(finite, metric=metric) if len(finite) else 0.0
    for mode in ("replace", "dither"):
        args = (rgb, cents, thr, k_active, mode, 1, metric)
        assert torch.equal(kernels.assign_packed(*args), kernels.assign_packed_reference(*args))
        assert torch.equal(kernels.quantize_rgba(*args), kernels.quantize_rgba_reference(*args))
        if k <= 256:
            assert torch.equal(kernels.assign_u8(*args), kernels.assign_u8_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ["random", "duplicates", "inf", "k_active"])
@pytest.mark.parametrize("k", [2048, 4097])
def test_exact_colour_out_past_the_staged_chunk(cuda, k, case, metric):
    """Colour out at 2048 colours (one staged table) and 4097 (the chunked
    instance: 4096 centroids, then 1): equal RGBA words."""
    rgb, cents, k_active = _adversarial(case, k, 3100 + k, cuda, 29, 41)
    tier = "exact-chunked" if k > kernels.STAGE_CHUNK else "exact"
    before = kernels.LAUNCHES_BY_MODE["quantize_rgba", metric, tier]
    for mode in ("replace", "dither"):
        args = (rgb, cents, 2.5 if mode == "dither" else 0.0, k_active, mode, 0, metric)
        assert torch.equal(kernels.quantize_rgba(*args), kernels.quantize_rgba_reference(*args))
    assert kernels.LAUNCHES_BY_MODE["quantize_rgba", metric, tier] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_exact_frames_adversarial(cuda, k, metric):
    """The frames mode of the tiled loop: three frames with duplicate, inf
    and grey-pixel palettes and per-frame `k_active`, packed and RGBA."""
    parts = [_adversarial(case, k, 3200 + k, cuda, 30, 41)
             for case in ("duplicates", "inf", "tiny")]
    frames = torch.stack([p[0] for p in parts])
    cents = torch.stack([p[1] for p in parts]).contiguous()
    k_actives = [k, max(1, k // 2), max(1, k - 3)]
    thr = [1.5, 0.0, 3.25]
    for call, twin in ((kernels.assign_frames_packed, kernels.assign_frames_packed_reference),
                       (kernels.quantize_frames, kernels.quantize_frames_reference)):
        got = call(frames, cents, thr, k_actives, "dither", metric)
        assert torch.equal(got, twin(frames, cents, thr, k_actives, "dither", metric))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("k", [1, 2, 8, 17, 64, 256, 512])
def test_exact_accumulator_adversarial(cuda, k, case, metric):
    """The accumulator's tiled loop and warp reduction on the same
    adversarial palettes: equal counts, the other columns within
    1e-5 * (|twin| + 128 * count)."""
    rgb, cents, k_active = _adversarial(case, k, 3300 + k, cuda, 61, 97)
    planes, n = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
    args = (planes, cents, n, k_active, None, metric, True)
    got = kernels.lloyd_accumulate(*args)
    want = kernels.lloyd_accumulate_reference(*args)
    assert torch.equal(got[:, 3], want[:, 3])
    finite = torch.isfinite(cents).all(-1) | (want[:, 3] == 0)
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    err = (got.double() - want.double()).abs()
    assert (err[finite] <= bound[finite]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_accumulator_same_bits_on_two_streams(cuda, metric):
    """kp = 512 with a weight plane, the inertia column and bfloat16 planes:
    two launches on two streams give equal bits, equal counts to the twin,
    sums within the bar."""
    rng = np.random.default_rng(77)
    rgb = torch.from_numpy(rng.integers(0, 256, (300_001, 3), dtype=np.uint8)).to(cuda)
    planes, n = kernels.pack_lab_planes(srgb8_to_lab(rgb), torch.bfloat16)
    w = kernels.pack_plane(torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(cuda))
    _, cents = _case(1, 1, 512, 78, cuda)
    args = (planes, cents, n, None, w, metric, True)
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            outs.append(kernels.lloyd_accumulate(*args))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    want = kernels.lloyd_accumulate_reference(*args)
    assert torch.equal(outs[0][:, 3], want[:, 3])
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    assert ((outs[0].double() - want.double()).abs() <= bound).all()


def _meld_within_bar(got, want, h, w, k, metric):
    """CIE94: equal words. CIEDE2000: every channel within 1 u8 step on at
    most 1e-4 of the pixels (the exact CIEDE2000 twin's library calls, as
    in `test_meld_kernel_matches_twin`)."""
    if metric == "cie94":
        return torch.equal(got, want)
    rows = kernels.quant_tile_rows(k)
    a = unpack_rgb24_tile_words(got.cpu().numpy(), h, w, rows).astype(int)
    b = unpack_rgb24_tile_words(want.cpu().numpy(), h, w, rows).astype(int)
    step = np.abs(a - b).max(-1)
    return step.max() <= 1 and (step > 0).sum() <= h * w // 10000


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("k", [1, 2, 8, 16, 17, 64, 256, 512])
def test_exact_meld_adversarial_palettes(cuda, k, case, metric):
    """The exact meld tiles (the `d(closest, second)` table up to 16
    colours, the sRGB encode by step points) on the adversarial palettes."""
    rgb, cents, k_active = _adversarial(case, k, 3400 + k, cuda)
    got = kernels.meld_packed(rgb, cents, k_active, metric)
    want = kernels.meld_packed_reference(rgb, cents, k_active, metric)
    assert _meld_within_bar(got, want, 37, 53, k, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ["random", "duplicates", "inf", "tiny", "k_active"])
def test_chunked_meld_adversarial(cuda, case, metric, monkeypatch):
    """The chunked meld with 64-centroid chunks at k = 300: both closest
    carry through the tile across chunks."""
    monkeypatch.setattr(kernels, "STAGE_CHUNK", 64)
    rgb, cents, k_active = _adversarial(case, 300, 3500, cuda, 29, 41)
    before = kernels.LAUNCHES_BY_MODE["meld_packed", metric, "exact-chunked"]
    got = kernels.meld_packed(rgb, cents, k_active, metric)
    want = kernels.meld_packed_reference(rgb, cents, k_active, metric)
    assert kernels.LAUNCHES_BY_MODE["meld_packed", metric, "exact-chunked"] == before + 1
    assert _meld_within_bar(got, want, 29, 41, 300, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("k,fast", [(1, False), (8, False), (64, False), (64, True)])
def test_meld_frames_adversarial(cuda, k, fast, metric):
    """The frames mode of the meld tiles: three frames with duplicate, inf
    and tiny-chroma palettes and per-frame `k_active`."""
    parts = [_adversarial(case, k, 3600 + k, cuda, 30, 41)
             for case in ("duplicates", "inf", "tiny")]
    frames = torch.stack([p[0] for p in parts])
    cents = torch.stack([p[1] for p in parts]).contiguous()
    k_actives = [k, max(1, k // 2), max(1, k - 3)]
    got = kernels.meld_frames_packed(frames, cents, k_actives, metric, fast)
    want = kernels.meld_frames_packed_reference(frames, cents, k_actives, metric, fast)
    for f in range(3):
        assert _meld_within_bar(got[f], want[f], 30, 41, k, "cie94" if fast else metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("k", [17, 64, 129, 256, 512])
def test_fast_adversarial_palettes(cuda, k, case, metric):
    """The factorized CIE94 tile and the pruned CIEDE2000 network screen in
    every assign output mode and in meld: equal words to the twins."""
    rgb, cents, k_active = _adversarial(case, k, 3700 + k, cuda)
    finite = cents[torch.isfinite(cents).all(-1)]
    thr = dither_threshold(finite, metric=metric) if len(finite) else 0.0
    tier = kernels.assign_tier(True, metric, k)
    before = kernels.LAUNCHES_BY_MODE["assign_packed", metric, tier]
    for mode in ("replace", "dither"):
        args = (rgb, cents, thr, k_active, mode, 1, metric, True)
        assert torch.equal(kernels.assign_packed(*args), kernels.assign_packed_reference(*args))
        assert torch.equal(kernels.quantize_rgba(*args), kernels.quantize_rgba_reference(*args))
        if k <= 256:
            assert torch.equal(kernels.assign_u8(*args), kernels.assign_u8_reference(*args))
    assert kernels.LAUNCHES_BY_MODE["assign_packed", metric, tier] == before + 2
    assert torch.equal(kernels.meld_packed(rgb, cents, k_active, metric, True),
                       kernels.meld_packed_reference(rgb, cents, k_active, metric, True))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("k", [17, 129, 512])
def test_fast_accumulator_adversarial(cuda, k, case, metric):
    """The accumulator's fast tiers (factorized, algebraic with the inertia
    column, pruned) on the adversarial palettes: equal counts, the other
    columns within 1e-5 * (|twin| + 128 * count)."""
    rgb, cents, k_active = _adversarial(case, k, 3800 + k, cuda, 61, 97)
    planes, n = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
    for inertia in ((False, True) if metric == "cie94" else (True,)):
        args = (planes, cents, n, k_active, None, metric, inertia)
        got = kernels.lloyd_accumulate(*args, fast=True)
        want = kernels.lloyd_accumulate_reference(*args, fast=True)
        assert torch.equal(got[:, 3], want[:, 3])
        finite = torch.isfinite(cents).all(-1) | (want[:, 3] == 0)
        bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
        err = (got.double() - want.double()).abs()
        assert (err[finite] <= bound[finite]).all()


# The fast accumulator tiers: metric, inertia column (the algebraic tier
# always has it). Factorized and algebraic run register tiles, pruned one
# pixel at a time.
FAST_TIERS = {"factor": ("cie94", False), "algebraic": ("cie94", True),
              "prune": ("cie2000", True)}


def _fast_tile_case(tier, planes, cents, n_valid, k_active=None, weight=None):
    """One fast accumulator launch twice against the twin: counts equal, the
    other columns within 1e-5 * (|twin| + 128 * count), equal totals."""
    metric, inertia = FAST_TIERS[tier]
    args = (planes, cents, n_valid, k_active, weight, metric, inertia)
    before = kernels.LAUNCHES_BY_MODE["lloyd_accumulate", metric, tier]
    got = kernels.lloyd_accumulate(*args, fast=True)
    again = kernels.lloyd_accumulate(*args, fast=True)
    want = kernels.lloyd_accumulate_reference(*args, fast=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES_BY_MODE["lloyd_accumulate", metric, tier] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[:, 3], want[:, 3])
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    assert ((got.double() - want.double()).abs() <= bound).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("residue", range(8))
@pytest.mark.parametrize("tier", sorted(FAST_TIERS))
def test_fast_accumulator_tile_residues(cuda, tier, residue):
    """The register tiles' edges: `n_valid` at every residue of an 8-pixel
    tile (a 4-pixel one twice), mid-block, over planes whose pixels past
    it are real colours, so that padding drops out by its index alone."""
    planes, cents, _ = _planes(3 * 16384, 64 if tier == "prune" else 40, 4100 + residue, cuda)
    n_valid = 16384 + 4 * 256 * 3 + 8 * 17 + residue
    got = _fast_tile_case(tier, planes, cents, n_valid)
    assert got[:, 3].sum() == n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("k,k_active,weighted,bf16", [
    (17, 5, True, False), (129, None, False, True), (256, 12, True, True),
    (512, None, True, False)])
@pytest.mark.parametrize("tier", sorted(FAST_TIERS))
def test_fast_accumulator_tiles_across_palettes(cuda, tier, k, k_active, weighted, bf16):
    """kp = 17, 129, 256 and 512 (m = 8 and 16 under prune), `k_active`
    below m (slots never filled), a weight plane, bfloat16 planes."""
    planes, cents, n = _planes(70_001, k, 4200 + k, cuda, bf16)
    rng = np.random.default_rng(4300 + k)
    w = (kernels.pack_plane(torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(cuda))
         if weighted else None)
    _fast_tile_case(tier, planes, cents, n, k_active, w)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(FAST_TIERS))
def test_fast_accumulator_tiles_on_two_streams(cuda, tier):
    """kp = 256, a weight plane: two launches on two streams give equal
    bits, counts equal to the twin's, sums within the bar."""
    metric, inertia = FAST_TIERS[tier]
    planes, cents, n = _planes(300_001, 256, 4400, cuda)
    rng = np.random.default_rng(4401)
    w = kernels.pack_plane(torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(cuda))
    args = (planes, cents, n, None, w, metric, inertia)
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            outs.append(kernels.lloyd_accumulate(*args, fast=True))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], _fast_tile_case(tier, planes, cents, n, None, w))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_meld_and_fast_assign_same_words_on_two_streams(cuda, metric):
    """The meld tiles (k = 8, exact) and the fast assign (k = 300) launched
    on two streams give equal words, and the twins' words."""
    rgb, cents = _case(300, 401, 8, 3900, cuda)
    _, big = _case(1, 1, 300, 3901, cuda)
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            outs.append((kernels.meld_packed(rgb, cents, metric=metric),
                         kernels.assign_packed(rgb, big, 1.5, None, "dither", 0, metric, True)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert _meld_within_bar(outs[0][0], kernels.meld_packed_reference(rgb, cents, metric=metric),
                            300, 401, 8, metric)
    assert torch.equal(outs[0][1], kernels.assign_packed_reference(rgb, big, 1.5, None, "dither",
                                                                   0, metric, True))


# --- Bucketing: the weighted accumulator on a padded canvas, bucketed find,
# the coalescers ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_weighted_accumulator_on_a_bucketed_canvas(cuda, metric):
    """A 300x420 image padded to its 320x448 bucket, the full canvas with its
    weight plane (0 on the padding): the kernel's counts equal the twin's
    and the counts of the unpadded pixels alone, exactly; the sums agree
    within the accumulator's bar."""
    from kmeans_tpu_torch.models.kmeans import _weight_plane
    from kmeans_tpu_torch.ops.resize import resize_to_canvas
    from kmeans_tpu_torch.utils.bucketing import bucket_shape

    h, w = 300, 420
    img = _gradient_frames(1, h, w, 21)[0][..., :3]
    bh, bw = bucket_shape(h, w)
    padded = np.zeros((bh, bw, 3), np.uint8)
    padded[:h, :w] = img
    canvas, weight = resize_to_canvas(torch.from_numpy(padded).to(cuda), bh, bw, h, w, h, w)
    planes, n = kernels.pack_lab_planes(srgb8_to_lab(canvas.reshape(-1, 3)))
    wplane = _weight_plane(weight.reshape(-1))
    _, cents = _case(1, 1, 8, 22, cuda)
    got = kernels.lloyd_accumulate(planes, cents, n, 5, wplane, metric=metric)
    want = kernels.lloyd_accumulate_reference(planes, cents, n, 5, wplane, metric=metric)
    alone, n_alone = kernels.pack_lab_planes(
        srgb8_to_lab(torch.from_numpy(np.ascontiguousarray(img)).to(cuda).reshape(-1, 3)))
    unpadded = kernels.lloyd_accumulate(alone, cents, n_alone, 5, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 3], want[:, 3]) and torch.equal(got[:, 3], unpadded[:, 3])
    assert got[5:, 3].sum() == 0 and got[:, 3].sum() == h * w
    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("mode", [ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD])
def test_bucketed_find_on_card_equals_unbucketed(cuda, mode, k):
    """Bucketed `find`, `find_batch` and `find_many` on the card equal
    unbucketed `find` on the card bit for bit (37x53 and 61x97 pad off the
    Bayer period), with one launch for each bucket of two or more."""
    frames = _gradient_frames(3, 37, 53, 23)
    mixed = frames[:2] + _gradient_frames(1, 61, 97, 24) + _gradient_frames(1, 40, 50, 25)
    colors = np.random.default_rng(26).integers(0, 256, (k, 3), dtype=np.uint8)
    bucketed, plain = ImageProcessor(bucketing=True), ImageProcessor()
    name = "meld_packed" if mode is ReduceMode.MELD else "assign_packed"
    kernels.LAUNCHES_BY_MODE.clear()
    got_one = [bucketed.find(f, colors, mode).pixels for f in mixed]
    got_batch = bucketed.find_batch(frames, colors, mode)
    got_many = bucketed.find_many(mixed, colors, mode)
    torch.cuda.synchronize()
    # 4 solo finds, 1 find_batch, find_many: 37x53 x2 and 40x50 share 40x56.
    assert kernels.launches(name) == 4 + 1 + 2
    for i, f in enumerate(mixed):
        want = plain.find(f, colors, mode).pixels
        np.testing.assert_array_equal(got_one[i], want)
        np.testing.assert_array_equal(got_many[i].pixels, want)
    for g, f in zip(got_batch, frames):
        np.testing.assert_array_equal(g.pixels, plain.find(f, colors, mode).pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [ReduceMode.DITHER, ReduceMode.MELD])
def test_bucketed_coalescers_on_card_match_cpu(cuda, mode):
    """`reduce_many` and `palette_many` over a mixed batch (two buckets of
    two, one image alone) on the card against the CPU: equal palettes;
    dither within 1e-4 of the pixels, meld within 1 u8 step on 1e-3. Each
    bucket of two takes one frames launch."""
    mixed = (_gradient_frames(2, 45, 70, 27) + _gradient_frames(1, 40, 66, 28)
             + _gradient_frames(2, 90, 130, 29))
    card = ImageProcessor(bucketing=True)
    cpu = ImageProcessor(device="cpu", bucketing=True)
    kernels.LAUNCHES_BY_MODE.clear()
    on_card = card.reduce_many(mixed, 6, mode)
    frames_name = "meld_frames_packed" if mode is ReduceMode.MELD else "assign_frames_packed"
    assert kernels.launches(frames_name) == 2
    on_cpu = cpu.reduce_many(mixed, 6, mode)
    for a, b in zip(card.palette_many(mixed, 6), cpu.palette_many(mixed, 6)):
        np.testing.assert_array_equal(a, b)
    bar = 1e-3 if mode is ReduceMode.MELD else 1e-4
    for a, b in zip(on_card, on_cpu):
        step = np.abs(a.pixels.astype(int) - b.pixels.astype(int)).max(-1)
        assert step.max() <= (1 if mode is ReduceMode.MELD else 255)
        assert (step > 0).sum() <= bar * step.size


@pytest.mark.cuda
def test_validate_kernels_on_card(cuda, capsys):
    """`validate_kernels` holds every kernel against its twin on the card."""
    from kmeans_tpu_torch.ops.validate import validate_kernels

    before = kernels.launches("assign_u8")
    assert validate_kernels() is True
    assert kernels.launches("assign_u8") > before
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(line.endswith(": OK") for line in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("bucketing", [False, True])
def test_host_algorithms_on_card_match_cpu(cuda, bucketing):
    """The host palette algorithms: the shrink on the card gives the CPU's
    bytes, so each palette is the CPU's; replace and dither on the card give
    the CPU's pixels, through one assign launch each."""
    from kmeans_tpu_torch import Algorithm, Image
    from kmeans_tpu_torch.api import OCTREE_MAX_SIZE

    img = _gradient_frames(1, 150, 210, 31)[0]
    card = ImageProcessor(bucketing=bucketing)
    cpu = ImageProcessor(device="cpu", bucketing=bucketing)
    image = Image((210, 150), img)
    np.testing.assert_array_equal(card._shrunk_pixels(image, OCTREE_MAX_SIZE),
                                  cpu._shrunk_pixels(image, OCTREE_MAX_SIZE))
    for algo in (Algorithm.OCTREE, Algorithm.MEDIANCUT, Algorithm.WU):
        np.testing.assert_array_equal(card.palette(8, img, algo), cpu.palette(8, img, algo))
        for mode in (ReduceMode.REPLACE, ReduceMode.DITHER):
            before = kernels.launches("assign_packed")
            on_card = card.reduce(8, img, algo, mode).pixels
            assert kernels.launches("assign_packed") == before + 1
            np.testing.assert_array_equal(on_card, cpu.reduce(8, img, algo, mode).pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replace", "dither", "meld"])
def test_streamed_band_words_match_twins(cuda, mode):
    """Streaming on the card in bands of 37 rows (band starts off the Bayer
    period, a short last band): each band's words equal the plain twin's
    with the band's `row_offset` (meld has none), `find_streamed` equals
    the bucketed `find`, and `reduce_streamed` equals the CPU's, palette
    and pixels (meld within 1 u8 step on at most 1e-3 of them)."""
    from kmeans_tpu_torch import Image
    from kmeans_tpu_torch.api import _colors_to_lab
    from kmeans_tpu_torch.utils.bucketing import pad_palette_k

    img = _gradient_frames(1, 150, 210, 41)[0]
    colors = np.random.default_rng(42).integers(0, 256, (5, 4), dtype=np.uint8)
    colors[:, 3] = 255
    card, cpu = ImageProcessor(), ImageProcessor(device="cpu")
    pal, k_active = pad_palette_k(torch.from_numpy(_colors_to_lab(colors)).to(cuda))
    thr = dither_threshold(pal, k_active) if mode == "dither" else 0.0
    for r0 in range(0, 150, 37):
        band = card._upload_band(Image((210, 150), img), r0, 37)
        if mode == "meld":
            got = kernels.meld_packed(band, pal, k_active)
            want = kernels.meld_packed_reference(band, pal, k_active)
        else:
            got = kernels.assign_packed(band, pal, thr, k_active, mode, row_offset=r0)
            want = kernels.assign_packed_reference(band, pal, thr, k_active, mode,
                                                   row_offset=r0)
        assert torch.equal(got, want)
    before = kernels.launches("meld_packed" if mode == "meld" else "assign_packed")
    streamed = card.find_streamed(img, colors, ReduceMode(mode), band_rows=37).pixels
    assert kernels.launches("meld_packed" if mode == "meld" else "assign_packed") == before + 5
    np.testing.assert_array_equal(
        streamed, ImageProcessor(bucketing=True).find(img, colors, ReduceMode(mode)).pixels)
    np.testing.assert_array_equal(card.palette_streamed(8, img, band_rows=37),
                                  cpu.palette_streamed(8, img, band_rows=37))
    step = np.abs(card.reduce_streamed(8, img, ReduceMode(mode), 37).pixels.astype(np.int64)
                  - cpu.reduce_streamed(8, img, ReduceMode(mode), 37).pixels).max(-1)
    if mode == "meld":
        assert step.max() <= 1 and (step > 0).sum() <= 1e-3 * step.size
    else:
        assert step.max() == 0


@pytest.mark.cuda
def test_streamed_peak_memory_follows_the_band(cuda):
    """`reduce_streamed` in bands of 256 rows holds about the same device
    memory for a 2048x1024 and a 2048x2048 image, less than the bucketed
    `reduce` of the larger one."""
    def peak(call):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    card = ImageProcessor()
    small, large = (_gradient_frames(1, h, 2048, 43)[0] for h in (1024, 2048))
    peaks = [peak(lambda: card.reduce_streamed(8, img, band_rows=256)) for img in (small, large)]
    whole = peak(lambda: ImageProcessor(bucketing=True).reduce(8, large))
    assert peaks[1] < whole
    assert abs(peaks[1] / peaks[0] - 1) <= 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("bucketing", [False, True])
def test_reduce_pipelined_on_card_matches_reduce(cuda, bucketing):
    """Six images of three sizes through the pipeline (side stream, pinned
    buffers, events): each output is the card's solo `reduce`."""
    card = ImageProcessor(bucketing=bucketing)
    frames = [_gradient_frames(1, h, w, 44 + h)[0] for h, w in ((270, 480), (180, 320),
                                                                (301, 333))] * 2
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
        outs = card.reduce_pipelined(frames, 8, mode)
        for out, frame in zip(outs, frames):
            np.testing.assert_array_equal(out.pixels,
                                          card.reduce(8, frame, reduce_mode=mode).pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replace", "dither", "meld"])
def test_native_unpack_of_card_words_matches_twins(cuda, mode):
    """The native strip and unpacks (`kmeans_tpu_torch/runtime/`) on the
    card's output words: the bytes of the numpy twins, 0 apart; and a
    streamed reduce 1280 wide (its own width bucket: each band unpacks
    straight into its rows) equal with the twins in the native paths'
    place."""
    from kmeans_tpu_torch import Image, api
    from kmeans_tpu_torch.utils import packing

    rng = np.random.default_rng(41)
    px = rng.integers(0, 256, (301, 517, 4), dtype=np.uint8)
    np.testing.assert_array_equal(api._host_rgb(px), np.ascontiguousarray(px[..., :3]))
    proc = ImageProcessor(device="cuda")
    img = Image((517, 301), px)
    cents = proc.extract_palette_kmeans(img, 8)
    kind, out, pal = proc._output_pass(proc._upload_image(img), cents, mode)
    words = out.cpu().numpy()
    rows = kernels.quant_tile_rows(8)
    if kind == "indexed":
        pal_np = pal.cpu().numpy()
        want = packing._unpack_tile_words_gather_np(words, 301, 517, pack_bits(8), pal_np, rows)
        got = packing.unpack_tile_words_gather(words, 301, 517, pack_bits(8), pal_np, rows)
    else:
        want = packing._unpack_rgb24_np(words, 301, 517, rows)
        got = unpack_rgb24_tile_words(words, 301, 517, rows)
    np.testing.assert_array_equal(got, want)
    big = Image((1280, 300), rng.integers(0, 256, (300, 1280, 4), dtype=np.uint8))
    native = proc.reduce_streamed(6, big, ReduceMode(mode), band_rows=128).pixels
    saved = (api.unpack_tile_words_gather, api.unpack_rgb24_tile_words)

    def fill(arr, dest):
        if dest is None:
            return arr
        dest[...] = arr
        return dest

    try:
        api.unpack_tile_words_gather = lambda words, h, w, bits, pal, tile_rows, out=None: fill(
            packing._unpack_tile_words_gather_np(words, h, w, bits, pal, tile_rows), out)
        api.unpack_rgb24_tile_words = lambda words, h, w, tile_rows, out=None: fill(
            packing._unpack_rgb24_np(words, h, w, tile_rows), out)
        twin = proc.reduce_streamed(6, big, ReduceMode(mode), band_rows=128).pixels
    finally:
        api.unpack_tile_words_gather, api.unpack_rgb24_tile_words = saved
    np.testing.assert_array_equal(native, twin)


@pytest.mark.cuda
def test_server_on_card_answers_as_direct_calls(cuda):
    """`kmeans_tpu_torch.serve` over `ImageProcessor(bucketing=True)` on the
    card: /reduce (batched), /find, /reduce-gif and the deep probe answer
    as the processor's direct calls; the dimension-bomb GIF is a 400."""
    import http.client
    import threading

    from kmeans_tpu_torch import Image
    from kmeans_tpu_torch.serve import create_server
    from kmeans_tpu_torch.utils.imageio import (
        decode_gif_bytes,
        decode_image_bytes,
        encode_gif_bytes,
        encode_png_bytes,
    )

    rng = np.random.default_rng(42)
    px = rng.integers(0, 256, (90, 130, 4), dtype=np.uint8)
    px[..., 3] = 255
    img = Image((130, 90), px)
    frames = [Image((40, 30), np.repeat(np.repeat(rng.integers(0, 256, (3, 4, 4), np.uint8) | 3,
                                                  10, 0), 10, 1)) for _ in range(3)]
    for f in frames:
        f.pixels[..., 3] = 255
    proc = ImageProcessor(device="cuda", bucketing=True)
    srv = create_server(port=0, processor=proc, batch_window_s=0.01)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def post(path, body, method="POST"):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=300)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    try:
        results = [None] * 4

        def client(i):
            results[i] = post("/reduce?k=5&mode=dither", encode_png_bytes(img))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        want = proc.reduce(5, img, reduce_mode=ReduceMode.DITHER).pixels
        for status, data in results:
            assert status == 200
            np.testing.assert_array_equal(decode_image_bytes(data).pixels, want)
        status, data = post("/find?colors=ff0000,00ff00,0000ff", encode_png_bytes(img))
        assert status == 200
        np.testing.assert_array_equal(
            decode_image_bytes(data).pixels,
            proc.find(img, np.array([[255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255]],
                                    np.uint8)).pixels)
        status, data = post("/reduce-gif?k=4", encode_gif_bytes(frames, delays=[3, 4, 5]))
        got, delays = decode_gif_bytes(data, with_delays=True)
        assert status == 200 and delays == [3, 4, 5]
        for a, b in zip(got, proc.reduce_images(frames, 4)):
            np.testing.assert_array_equal(a.pixels, b.pixels)
        assert post("/healthz?deep=1", None, "GET") == (200, b"ok\n")
        bomb = (b"GIF89a\xff\xff\xff\xff\x00\x00\x00\x2c" + bytes(4) + b"\x01\x00\x01\x00"
                + b"\x80" + bytes(6) + bytes([2, 1, 0x44, 0]) + b"\x3b")
        status, data = post("/reduce-gif?k=2", bomb)
        assert status == 400 and b"decode limit" in data
    finally:
        srv.shutdown()
        srv.server_close()


def _shard_image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode,k", [("replace", 8), ("dither", 17), ("meld", 8),
                                    ("replace", 1100)])
def test_sharded_words_match_twins(cuda, shards, mode, k):
    """Each shard's launch on `["cuda:0"] * shards` against the twin on its
    rows with its `row_offset` (an odd height, so the rows pad)."""
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.parallel.sharded_ops import _assign_words, _meld_words, _row_sharded

    mesh = make_mesh([cuda] * shards)
    rgb, cents = _case(63, 97, k, 900 + k, cuda)
    blocks, _, local_h = _row_sharded(mesh, rgb)
    kernels.LAUNCHES_BY_MODE.clear()
    if mode == "meld":
        got = _meld_words(blocks, cents, None, "cie94", False)
        want = [kernels.meld_packed_reference(b, cents) for b in blocks]
    else:
        got = _assign_words(blocks, local_h, cents, mode, None, "cie94", False,
                            colour_out=k > kernels.INDEXED_MAX_K)
        thr = dither_threshold(cents) if mode == "dither" else 0.0
        twin = (kernels.quantize_rgba_reference if k > kernels.INDEXED_MAX_K
                else kernels.assign_packed_reference)
        want = [twin(b, cents, thr, mode=mode, row_offset=s * local_h)
                for s, b in enumerate(blocks)]
    torch.cuda.synchronize()
    name = ("meld_packed" if mode == "meld" else
            "quantize_rgba" if k > kernels.INDEXED_MAX_K else "assign_packed")
    assert kernels.launches(name) == shards
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_find_sharded_equals_find_on_card(cuda, shards):
    """`find_sharded` on repeated `cuda:0` shards gives `find`'s pixels in
    every mode, one launch a shard."""
    from kmeans_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cuda:0"] * shards)
    proc = ImageProcessor(device="cuda")
    img = _shard_image(301, 203, 7)
    colors = np.random.default_rng(8).integers(0, 256, (12, 3), dtype=np.uint8)
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
        kernels.LAUNCHES_BY_MODE.clear()
        got = proc.find_sharded(img, colors, mode, mesh=mesh).pixels
        name = "meld_packed" if mode is ReduceMode.MELD else "assign_packed"
        assert kernels.launches(name) == shards
        np.testing.assert_array_equal(got, proc.find(img, colors, mode).pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pallas_route_launches(cuda, shards, monkeypatch):
    """The full-resolution sharded training launches the accumulator once a
    shard an iteration; a one-shard mesh gives `reduce`'s pixels, more
    shards the reference's bars."""
    from kmeans_tpu_torch import api
    from kmeans_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(api, "_LARGE_TRAIN_PIXELS", 10_000)
    proc = ImageProcessor(device="cuda", train_max_size=None)
    img = _shard_image(200, 300, 9)
    single = proc.reduce(8, img).pixels
    for d in (1, shards):
        kernels.LAUNCHES_BY_MODE.clear()
        got = proc.reduce_sharded(8, img, mesh=make_mesh(["cuda:0"] * d)).pixels
        torch.cuda.synchronize()
        assert kernels.launches("lloyd_accumulate") == d * proc.last_iterations
        if d == 1:
            np.testing.assert_array_equal(got, single)
        assert (got == single).all(-1).mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [ReduceMode.REPLACE, ReduceMode.DITHER])
def test_banded_reduce_on_card_equals_monolithic_pass(cuda, mode):
    """Pipeline mode's banded `reduce` (side stream, pinned band buffers,
    events; 5 bands of a 2100-row image, the last of 52 rows) gives the
    monolithic output pass's pixels on the same centroids, with one assign
    launch a band (and one threshold launch for dither)."""
    from kmeans_tpu_torch.api import PIPELINE_BAND_ROWS

    card = ImageProcessor(pipeline=True)
    img = _gradient_frames(1, 2100, 333, 45)[0]
    kernels.LAUNCHES_BY_MODE.clear()
    got = card.reduce(8, img, reduce_mode=mode).pixels
    assert kernels.launches("assign_packed") == -(-2100 // PIPELINE_BAND_ROWS) == 5
    assert kernels.launches("dither_threshold") == int(mode is ReduceMode.DITHER)
    cents = card.extract_palette_kmeans(Image((333, 2100), img), 8)
    dev = torch.from_numpy(np.ascontiguousarray(img[..., :3])).to(cuda)
    np.testing.assert_array_equal(got, card._quantize(dev, cents, mode.value))


@pytest.mark.cuda
@pytest.mark.parametrize("bucketing", [False, True])
def test_pipelined_palette_on_card_matches_cpu(cuda, bucketing):
    """The pipelined palettes train on the same host strip bytes on both
    devices: the card's equal the CPU's."""
    img = _gradient_frames(1, 700, 520, 46)[0]
    frames = [img, img[::-1].copy()]
    card = ImageProcessor(pipeline=True, bucketing=bucketing)
    cpu = ImageProcessor(device="cpu", pipeline=True, bucketing=bucketing)
    np.testing.assert_array_equal(card.palette(8, img), cpu.palette(8, img))
    np.testing.assert_array_equal(card.palette_images(frames, 8), cpu.palette_images(frames, 8))
