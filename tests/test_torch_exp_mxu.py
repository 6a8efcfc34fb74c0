"""The port of `tools/exp_mxu.py` against the reference on the CPU.

- `factor_vpu_reference` (the twin of the CUDA-core kernel) against the
  reference's own `_factor_vpu_kernel`, built by
  `tools/exp_mxu.py::_build_kernels()` (the file is imported by path and
  run with `interpret=True`): 0 differing indices.
- `factor_mxu_reference(tf32=False)` against the reference's
  `_factor_mxu_kernel` in interpret mode: flips counted, each a near-tie
  (the twin's scores of the two picks within 2^-10 of the best's scale).
- the vpu twin against the port's `assign_u8_reference(fast=True)`.
- `tf32_round` against hand-computed bit patterns.
The kernels themselves run only on a card: `tests/test_torch_cuda.py`.
"""

import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.tools import exp_mxu

_REF_PATH = Path(__file__).resolve().parent.parent / "tools" / "exp_mxu.py"
_REF_RUN = []
_CU = (Path(__file__).resolve().parent.parent / "kmeans_tpu_torch" / "tools" / "csrc"
       / "exp_mxu.cu").read_text()
H100_SMS = 132


def _reference_run():
    """`tools/exp_mxu.py::_build_kernels()`, imported by path once."""
    if not _REF_RUN:
        spec = importlib.util.spec_from_file_location("reference_exp_mxu", _REF_PATH)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _REF_RUN.append(module._build_kernels())
    return _REF_RUN[0]


def _inputs(h, w, kp, seed):
    rng = np.random.default_rng(seed)
    return exp_mxu.random_image(h, w, rng), exp_mxu.random_centroids(kp, rng)


def _reference(name, rgba, cents):
    tile_rows = 128 if name == "factor-vpu" else 32
    return np.array(_reference_run()(name, jnp.asarray(rgba), jnp.asarray(cents), tile_rows,
                                     interpret=True))


CASES = [(8, 16, 64), (8, 16, 256), (40, 100, 64), (40, 100, 256)]


@pytest.mark.parametrize("h,w,kp", CASES)
def test_vpu_twin_matches_reference_kernel(h, w, kp):
    rgba, cents = _inputs(h, w, kp, seed=h + kp)
    want = _reference("factor-vpu", rgba, cents)
    got = exp_mxu.factor_vpu_reference(torch.from_numpy(rgba), torch.from_numpy(cents))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,kp", CASES)
def test_mxu_twin_matches_reference_kernel(h, w, kp):
    """The reference's product sums in XLA's order, the twin left to
    right: only near-ties may flip."""
    rgba, cents = _inputs(h, w, kp, seed=h + kp)
    want = _reference("factor-mxu", rgba, cents)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    got = exp_mxu.factor_mxu_reference(img, c, tf32=False)
    flips, near = exp_mxu.near_ties(img, c, torch.from_numpy(want), got, tf32=False)
    assert near, f"{flips} flips, not all near-ties"
    assert flips <= h * w // 1000


@pytest.mark.parametrize("h,w", [(8, 16), (40, 100)])
def test_vpu_twin_equals_fast_assign(h, w):
    rgba, cents = _inputs(h, w, 64, seed=7)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    want = kernels.assign_u8_reference(img[..., :3].contiguous(), c, 0.0, fast=True)
    assert torch.equal(exp_mxu.factor_vpu_reference(img, c), want)
    # The CPU wrappers run the twins: factor-mxu's with TF32 rounding.
    assert torch.equal(exp_mxu.factor_vpu(img, c), want)
    assert torch.equal(exp_mxu.factor_mxu(img, c), exp_mxu.factor_mxu_reference(img, c, True))


def test_mxu_twin_in_float32_is_the_vpu_order():
    """With float32 operands the product sums the seven terms in the
    score's own order (plus 0 * 0), and the chunk merge keeps the first
    minimum: the vpu twin's indices at every pixel."""
    rgba, cents = _inputs(37, 53, 100, seed=9)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    assert torch.equal(exp_mxu.factor_mxu_reference(img, c, tf32=False),
                       exp_mxu.factor_vpu_reference(img, c))


def _bits(values):
    return torch.tensor(values, dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("x,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is exact
    (0x3F800FFF, 0x3F800000),  # below half of the dropped bits: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero (even would go down)
    (0x3F803000, 0x3F804000),  # a tie from an odd last kept bit: away
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0x3FFFF000, 0x40000000),  # the carry moves into the exponent
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x7F7FF000, 0x7F800000),  # past the largest TF32: infinity
    (0xFF800000, 0xFF800000),  # -inf passes
    (0x7FC00001, 0x7FC00001),  # NaN passes, payload and all
])
def test_tf32_round_bits(x, want):
    got = exp_mxu.tf32_round(_bits([x])).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got[0]) == want


def test_near_ties_counts_only_flips():
    rgba, cents = _inputs(8, 16, 64, seed=3)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    idx = exp_mxu.factor_mxu_reference(img, c, tf32=True)
    assert exp_mxu.near_ties(img, c, idx, idx, tf32=True) == (0, True)
    scores = exp_mxu.factor_scores(img, c, tf32=True)
    worst = torch.argmax(scores, dim=1).to(torch.uint8).reshape(8, 16)
    flips, near = exp_mxu.near_ties(img, c, worst, idx, tf32=True)
    assert flips == 128 and not near


def test_wrappers_reject_what_the_kernels_do_not_take():
    rgba, cents = _inputs(4, 4, 8, seed=1)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    with pytest.raises(ValueError, match="RGBA"):
        exp_mxu.factor_vpu(img[..., :3], c)
    with pytest.raises(ValueError, match="k must be"):
        exp_mxu.factor_mxu(img, torch.zeros((257, 3)))


def test_tool_smoke_on_cpu(capsys):
    assert exp_mxu.main(["--smoke", "--cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    by_name = {line["variant"]: line for line in lines[-1]["all"]}
    assert set(by_name) == {"rolled-fast", "factor-vpu", "factor-mxu"}
    assert by_name["factor-vpu"]["mismatch_frac_vs_exact"] < exp_mxu.MISMATCH_BAR
    assert all(line["ms"] == "not measured" for line in by_name.values())


def test_tool_refuses_to_time_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        exp_mxu.main([])


@pytest.mark.parametrize("kp", [1, 3, 61, 64, 100, 129, 256])
def test_b_operand_inverts_to_the_product_g(kp):
    """`mxu_b_operand` (the kernel's `wgmma` layout) read back as rows is
    `mxu_operands`' TF32 G, and each padded column is `[0, +inf, 0, ...]`."""
    rgba, cents = _inputs(4, 8, kp, seed=kp)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    gb = exp_mxu.mxu_b_operand(c)
    kp_pad = exp_mxu.mxu_width(kp)
    assert gb.dtype == torch.float32 and tuple(gb.shape) == (kp_pad * 8,)
    rows = gb.reshape(kp_pad // 8, 2, 8, 4).permute(0, 2, 1, 3).reshape(kp_pad, 8)
    _, gmat = exp_mxu.mxu_operands(img, c, tf32=True)
    assert torch.equal(rows[:kp].T.contiguous().view(torch.int32), gmat.view(torch.int32))
    pad = rows[kp:]
    assert bool((pad[:, 1] == float("inf")).all())
    assert bool((pad[:, [0, 2, 3, 4, 5, 6, 7]] == 0).all())


@pytest.mark.parametrize("h,w,kp", [(8, 16, 1), (8, 16, 3), (40, 100, 61), (40, 100, 100),
                                    (8, 16, 129)])
def test_twin_never_picks_a_padded_column(h, w, kp):
    """The TF32 twin over the kernel's padded G (every KC-column chunk, the
    +inf columns included) picks what it picks over the kp columns."""
    rgba, cents = _inputs(h, w, kp, seed=3 * kp)
    img, c = torch.from_numpy(rgba), torch.from_numpy(cents)
    kp_pad = exp_mxu.mxu_width(kp)
    rows = exp_mxu.mxu_b_operand(c).reshape(kp_pad // 8, 2, 8, 4).permute(0, 2, 1, 3)
    feats, _ = exp_mxu.mxu_operands(img, c, tf32=True)
    padded = exp_mxu.chunked_argmin(feats, rows.reshape(kp_pad, 8).T.contiguous())
    assert int(padded.max()) < kp
    want = exp_mxu.factor_mxu_reference(img, c, tf32=True)
    assert torch.equal(padded.to(torch.uint8).reshape(h, w), want)


def _cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def vpu_slots(n: int, sms: int = H100_SMS) -> tuple[np.ndarray, np.ndarray]:
    """The pixels factor-vpu's launch visits, in a numpy model of
    `exp_factor_vpu` and `factor_vpu_kernel`: the grid the launcher sizes
    (`grid_blocks` of the larger of the whole tiles and the tail's blocks,
    at most kVpuMinBlocks an SM); block b takes tiles b, b + grid, ...;
    thread t's run q of a tile starts at 4 t + 4 q kThreads (one 16-byte
    load, one 32-bit store), its four slots consecutive; then the pixels
    past the last whole tile, one a thread, grid-stride. Returns the tile
    slots `[runs, 4]` and the tail's pixels."""
    threads, p, per_sm = (_cu_constant(c) for c in ("kThreads", "kVpuTilePixels",
                                                     "kVpuMinBlocks"))
    tile = threads * p
    tiles, tail_blocks = n // tile, -(-(n % tile) // threads)
    grid = min(max(tiles, tail_blocks, 1), sms * per_sm)
    runs, tail = [], []
    for block in range(grid):
        for t in range(block, tiles, grid):
            for thread in range(threads):
                for q in range(p // 4):
                    start = t * tile + 4 * thread + 4 * q * threads
                    runs.append(start + np.arange(4))
        for thread in range(threads):
            tail += range(tiles * tile + block * threads + thread, n, grid * threads)
    return np.array(runs, dtype=np.int64).reshape(-1, 4), np.array(tail, dtype=np.int64)


@pytest.mark.parametrize("n", [1, 3, 128, 5917, 8 * 256 + 5, 4 * 2048])
def test_vpu_tile_slots_visit_each_pixel_once(n):
    """factor-vpu's register tile (kVpuTilePixels a thread, runs of 4)
    and its one-pixel tail visit each of n pixels once, n any count; each
    run is four neighbours from a multiple of 4 (a 16-byte load from an
    aligned image, a 32-bit store)."""
    p = _cu_constant("kVpuTilePixels")
    assert p % 4 == 0
    assert "grid_blocks(tiles > tail_blocks ? tiles : tail_blocks, kVpuMinBlocks)" in _CU
    runs, tail = vpu_slots(n)
    seen = np.concatenate([runs.reshape(-1), tail])
    assert np.array_equal(np.sort(seen), np.arange(n))
    assert (runs[:, 0] % 4 == 0).all() and (np.diff(runs, axis=1) == 1).all()
    assert len(tail) == n % (256 * p)
