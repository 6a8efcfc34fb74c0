"""The port on a CUDA card: the hand-written kernels against their plain twins.

These tests need a card and skip without one. This file imports neither
JAX nor `kmeans_tpu`, so it also runs where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`tests/conftest.py` configures JAX, hence `--noconftest` there).
"""

import numpy as np
import pytest
import torch

from kmeans_tpu_torch import ImageProcessor, ReduceMode
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
