"""The accumulator's tiles as `csrc/lloyd_accumulate.cu` walks them, modelled
in numpy: which pixel each thread's tile slot takes (every padded pixel
once, padding by its index), the factorized and algebraic register tiles'
order of visits (the centroid loop outermost, each pixel's carry in index
order, so ties keep the first minimum) against the twin, and the pruned tier's
launch bound against the shared memory its blocks take. The constants are
read from the source; the card runs the kernel itself
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "kmeans_tpu_torch" / "csrc" / "lloyd_accumulate.cu").read_text()
H100_SMS = 132
SMEM_PER_SM = 228 * 1024  # the H100's shared memory an SM gives its blocks


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, WARPS, MAX_BLOCKS = constant("kThreads"), 8, constant("kMaxBlocks")
PIX_PER_THREAD = constant("kPixPerThread")


def source_tile(tier: str):
    """The tile `tile_pixels` gives a fast tier (`kTierFactor`,
    `kTierAlgebraic`): kTilePixels where its condition names the tier, else
    R rows of one pixel a thread."""
    body = re.search(r"constexpr int tile_pixels\(int metric, int tier\) \{(.*?)\}", SOURCE,
                     re.S).group(1)
    tiled = f"tier == {tier}" in body.split("?")[0]
    return constant("kTilePixels") if tiled else ("rows", PIX_PER_THREAD)


# Each instance's tile: a register tile of P pixels a thread (runs of 4),
# or ("rows", R): R rows of kThreads pixels, one pixel a thread at a time.
TILES = {"exact cie94": constant("kTilePixels"), "factor": source_tile("kTierFactor"),
         "exact cie2000": ("rows", PIX_PER_THREAD), "algebraic": source_tile("kTierAlgebraic"),
         "prune": ("rows", PIX_PER_THREAD)}


def grid_blocks(n_pix: int) -> int:
    """`kmeans_lloyd_grid_blocks`: one block a 1024-pixel tile, at most
    kMaxBlocks."""
    return max(1, min(n_pix // (THREADS * PIX_PER_THREAD), MAX_BLOCKS))


def tile_pixels(n_pix: int, tile) -> tuple:
    """The pixel of (tile, thread, slot s): under a P-pixel register tile
    run s // 4 of the thread's tile, 4 threads' runs apart, s % 4 into it;
    under R rows, row s. Tile i runs in block i % grid."""
    t = np.arange(THREADS)[:, None]
    if isinstance(tile, tuple):
        p = tile[1]
        within = t + np.arange(p)[None, :] * THREADS
    else:
        p = tile
        s = np.arange(p)[None, :]
        within = 4 * t + (s // 4) * 4 * THREADS + s % 4
    tiles = np.arange(n_pix // (THREADS * p))
    return tiles[:, None, None] * THREADS * p + within[None], tiles % grid_blocks(n_pix)


@pytest.mark.parametrize("tier", sorted(TILES))
@pytest.mark.parametrize("rows", [128, 3 * 128, 65 * 128, 64896])
def test_tile_slots_cover_each_padded_pixel_once(tier, rows):
    """Every padded pixel (`pack_lab_planes` pads to 128 x 128-pixel rows;
    64896 rows is a 3840x2160 image) is taken once, by a block of the grid;
    a register tile's four slots of a run are four neighbours (one 16-byte
    load a run)."""
    tile = TILES[tier]
    n_pix = rows * kernels.LANES
    pix, blocks = tile_pixels(n_pix, tile)
    assert np.array_equal(np.sort(pix.reshape(-1)), np.arange(n_pix))
    assert blocks.max() < grid_blocks(n_pix)
    if not isinstance(tile, tuple):
        assert tile % 4 == 0 and n_pix % (THREADS * tile) == 0  # the launcher's check
        assert np.all(np.diff(pix[..., :4], axis=-1) == 1)


@pytest.mark.parametrize("case", ["random", "duplicates", "k_active"])
def test_factor_tile_keeps_the_first_minimum(case):
    """`screen.cuh::scan_factor_tile` over a tile of kTilePixels pixels: the centroid loop outermost, each pixel's carry updated with
    strict `<` in index order; modelled on the twin's scores, its picks are
    the twin's, ties (duplicate centroids) to the lower index."""
    p = TILES["factor"]
    rng = np.random.default_rng(17)
    rgb = torch.from_numpy(rng.integers(0, 256, (p * 40, 3), dtype=np.uint8))
    lab = srgb8_to_lab(rgb)
    k = 40
    cents = srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)))
    if case == "duplicates":
        cents[k // 2:] = cents[:k // 2].clone()
        lab[::3] = cents[rng.integers(0, k // 2, len(lab[::3]))]
    k_active = k - 7 if case == "k_active" else k
    l, a, b = lab[:, 0].contiguous(), lab[:, 1].contiguous(), lab[:, 2].contiguous()
    c1 = torch.sqrt(a * a + b * b)
    score = kernels._screen_fn(l, a, b, c1, cents)
    scores = torch.stack([score(j) for j in range(k_active)], 1).numpy()
    best_d = np.full((len(lab) // p, p), np.float32(3.4e38), np.float32)
    best_k = np.zeros((len(lab) // p, p), np.int64)
    tiles = scores.reshape(len(lab) // p, p, k_active)
    for j in range(k_active):  # the centroid loop, outermost
        for s in range(p):  # the tile's pixels
            take = tiles[:, s, j] < best_d[:, s]
            best_d[take, s] = tiles[take, s, j]
            best_k[take, s] = j
    want_k, want_d = kernels._argmin(l, a, b, cents, k_active, "cie94", "factor")
    assert np.array_equal(best_k.reshape(-1), want_k.numpy())
    assert np.array_equal(best_d.reshape(-1), want_d.numpy())
    if case == "duplicates":
        assert (best_k.reshape(-1)[::3] < k // 2).all()


@pytest.mark.parametrize("case", ["random", "duplicates", "k_active"])
def test_algebraic_tile_totals_equal_the_twin(case):
    """The accumulator's algebraic tier as `lloyd_accumulate.cu` runs it:
    each thread's register tile (`tile_pixels`) scanned by
    `screen.cuh::scan_algebraic_tile`, the centroid loop outermost and each
    pixel's carry updated with strict `<` in index order, on the twin's
    distances; padding pixels (index >= n_valid) dropped by their index.
    Modelled in numpy, its counts equal `lloyd_accumulate_reference`'s and
    its inertia column (each member's distance) agrees to float32
    rounding; duplicate centroids keep the lower index."""
    p = TILES["algebraic"]
    assert not isinstance(p, tuple), "the algebraic tier runs a register tile"
    rng = np.random.default_rng(29)
    n_valid = 16384 + 8 * 33 + 5  # off the tile
    rgb = torch.from_numpy(rng.integers(0, 256, (n_valid, 3), dtype=np.uint8))
    k = 40
    cents = srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)))
    lab = srgb8_to_lab(rgb)
    if case == "duplicates":
        cents[k // 2:] = cents[:k // 2].clone()
        lab[::3] = cents[rng.integers(0, k // 2, len(lab[::3]))]
    k_active = k - 7 if case == "k_active" else k
    planes, n = kernels.pack_lab_planes(lab)
    flat = planes.reshape(3, -1)
    l, a, b = flat[0].contiguous(), flat[1].contiguous(), flat[2].contiguous()
    dist = kernels._algebraic_fn(l, a, b, torch.sqrt(a * a + b * b), cents)
    scores = torch.stack([dist(j) for j in range(k_active)], 1).numpy()
    pix, _ = tile_pixels(l.numel(), p)
    best_d = np.full(pix.shape, np.float32(3.4e38), np.float32)
    best_k = np.zeros(pix.shape, np.int64)
    for j in range(k_active):  # the centroid loop, outermost
        for s_ in range(p):  # the tile's pixels
            d = scores[pix[..., s_], j]
            take = d < best_d[..., s_]
            best_d[..., s_] = np.where(take, d, best_d[..., s_])
            best_k[..., s_] = np.where(take, j, best_k[..., s_])
    valid = pix < n
    counts = np.bincount(best_k[valid], minlength=k).astype(np.float32)
    inertia = np.bincount(best_k[valid], weights=best_d[valid].astype(np.float64), minlength=k)
    want = kernels.lloyd_accumulate_reference(planes, cents, n, k_active, emit_inertia=True,
                                              fast=True)
    assert np.array_equal(counts, want[:, 3].numpy())
    np.testing.assert_allclose(inertia, want[:, 4].double().numpy(), rtol=1e-5, atol=1e-3)
    if case == "duplicates":
        assert counts[k // 2:].sum() == 0


@pytest.mark.parametrize("kp,stats", [(17, 4), (64, 5), (129, 4), (256, 5)])
def test_pruned_grid_is_resident_at_once(kp, stats):
    """The pruned tier's launch bound (kPruneMinBlocks blocks an SM, so at
    most 65536 / (256 x that) registers a thread) and its shared memory
    (centroids, the padded feature table, eight warp accumulators) let an
    H100 hold the whole grid of at most kMaxBlocks at kp <= 256: no block
    waits for another to end."""
    bound = constant("kPruneMinBlocks")
    assert re.search(r"tier == kTierPrune \? kPruneMinBlocks", SOURCE)
    smem = 4 * kp * (4 + WARPS * stats + 8)
    assert bound * smem <= SMEM_PER_SM
    assert MAX_BLOCKS <= H100_SMS * bound
    assert 65536 // (THREADS * bound) >= 64


def test_chip_smoke_names_the_tiles_it_runs():
    """`chip_smoke.py`'s kernels line names each accumulator tier's design
    (`design_of`) with the source's constants, and every kernel it lists
    has one."""
    spec = importlib.util.spec_from_file_location("chip_smoke_names", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.LOOP_PAIRS["lloyd_tile_kernel<0,1"] == TILES["factor"]
    assert smoke.LOOP_PAIRS["lloyd_tile_kernel<0,2"] == TILES["algebraic"]
    assert smoke.LLOYD_PRUNE_MIN_BLOCKS == constant("kPruneMinBlocks")
    names = re.findall(r'\bentry\("([^"]+)"', (ROOT / "chip_smoke.py").read_text())
    designs = {name: smoke.design_of(name) for name in names}
    assert all(designs.values())
    assert designs["lloyd_accumulate[fast cie94, factorized]"].startswith(
        f"register tile of {TILES['factor']} pixels")
    assert f"{constant('kPruneMinBlocks')} blocks an SM" in designs[
        "lloyd_accumulate[fast cie2000, pruned]"]
    assert designs["lloyd_accumulate[fast cie94, algebraic]"].startswith(
        f"register tile of {TILES['algebraic']} pixels")
