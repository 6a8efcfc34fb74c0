"""The pruned tier's screen as `csrc/screen.cuh::prune_screen` runs it,
modelled step by step in numpy, against the twin's walk
(`kmeans_tpu_torch/ops/kernels.py::_prune_screen`); and the meld kernel's
sRGB encode by step points (`csrc/colorspace.cuh::linear_to_srgb8`)
against the direct chain. Both run on the CPU; the card checks the
kernels themselves (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.tools import srgb_steps

K_BIG = np.float32(3.4e38)
K_BIG_HALF = np.float32(1.7e38)
ALL = 0xFFFFFFFF
CSRC = Path(__file__).resolve().parents[1] / "kmeans_tpu_torch" / "csrc"
PATHS = collections.Counter()  # which way `prune_screen_model` ended


def screen_key(s: np.float32, k: int, low: int) -> int:
    """`screen_key`: the orderable bits of s (-0 as +0) with the low bits
    replaced by k; all ones for a score not below kBig."""
    if not s < K_BIG:
        return ALL
    b = int(np.array([s + np.float32(0.0)], np.float32).view(np.uint32)[0])
    u = b ^ ((ALL if b >> 31 else 0) | 0x80000000)
    return (u & ~low & ALL) | k


def sort_network(n: int, cx) -> None:
    """`sort_network`: Batcher's odd-even merge sort, the kernel's loops."""
    p = 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j + k < n:
                for i in range(k):
                    if i + j + k < n and (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        cx(i + j, i + j + k)
                j += 2 * k
            k >>= 1
        p <<= 1


def walk(scores, ks, m):
    """`TopM::insert` over the centroids `ks` in turn: the list (d, i)."""
    d, idx = [K_BIG] * m, [0] * m
    for k in ks:
        sd, si = scores[k], k
        if not sd < d[m - 1]:
            continue
        for j in range(m):
            if sd < d[j]:
                d[j], sd = sd, d[j]
                idx[j], si = si, idx[j]
    return d, idx


def bucket_top(key: int, low: int) -> np.float32:
    """`bucket_top`: the largest score of the key's bucket; +inf for ~0."""
    if key == ALL:
        return np.float32(np.inf)
    u = key | low
    b = u ^ 0x80000000 if u & 0x80000000 else ~u & ALL
    return np.array([b], np.uint32).view(np.float32)[0]


def prune_screen_model(scores, k_active: int, m: int):
    """`prune_screen` step by step: the first m keys sorted by the network;
    then each score not above the m-th key's bucket (the gate) is inserted
    (slot i the greater of the old slot i - 1 and the lesser of the old
    slot i and the key) if its key is below the m-th; then the scores
    of the keys kept, sorted where buckets are shared, or the walk over
    the scores of bucket <= the m-th key's."""
    kbits = (k_active - 1).bit_length()
    low = (1 << kbits) - 1
    keep = [screen_key(scores[min(k, k_active - 1)], k, low) if k < k_active else ALL
            for k in range(m)]

    def cx(a, b):
        keep[a], keep[b] = min(keep[a], keep[b]), max(keep[a], keep[b])

    sort_network(m, cx)
    out = ALL
    gate = bucket_top(keep[m - 1], low)
    for k in range(m, k_active):
        if scores[k] <= gate:
            key = screen_key(scores[k], k, low)
            out = min(out, max(key, keep[m - 1]))
            if key < keep[m - 1]:
                keep = [min(keep[0], key)] + [max(keep[i - 1], min(keep[i], key))
                                              for i in range(1, m)]
                gate = bucket_top(keep[m - 1], low)
    bucket = keep[m - 1] >> kbits
    use_walk = keep[m - 1] != ALL and (out >> kbits) == bucket
    if not use_walk:
        high = (int(np.array([K_BIG_HALF], np.float32).view(np.uint32)[0]) | 0x80000000) & ~low
        idx = [keep[j] & low if keep[j] != ALL else 0 for j in range(m)]
        d = [np.float32(0.0) if keep[j] != ALL else K_BIG for j in range(m)]
        shared = any(keep[j] != ALL and keep[j] >> kbits == keep[j - 1] >> kbits
                     for j in range(1, m))
        if shared or any(keep[j] != ALL and keep[j] >= high for j in range(m)):
            d = [scores[idx[j]] if keep[j] != ALL else K_BIG for j in range(m)]
            def cx(a, b):
                if d[b] < d[a]:
                    d[a], d[b] = d[b], d[a]
                    idx[a], idx[b] = idx[b], idx[a]

            sort_network(m, cx)
            use_walk = any(d[j] < K_BIG and d[j] == d[j - 1] for j in range(1, m))
        PATHS["sorted" if shared and not use_walk else "keys"] += 1
    if use_walk:
        PATHS["walk"] += 1
        ks = [k for k in range(k_active)
              if scores[k] < K_BIG and screen_key(scores[k], k, low) >> kbits <= bucket]
        d, idx = walk(scores, ks, m)
    return d, idx


def twin(scores, k_active: int, m: int):
    """The twin's `_prune_screen` on one pixel's scores."""
    t = torch.from_numpy(np.asarray(scores, np.float32))
    cand_d, cand_i = kernels._prune_screen(lambda k: t[k:k + 1], k_active, m, t[:1])
    return [np.float32(x.item()) for x in cand_d], [int(x.item()) for x in cand_i]


def _same(a, b) -> bool:
    """Equal lists as the exact pass reads them: the indices in order, and
    whether each score is below kBigHalf (the screen leaves 0 for a score
    below it where it need not compute the score again)."""
    (da, ia), (db, ib) = a, b
    return ia == ib and [x < K_BIG_HALF for x in da] == [x < K_BIG_HALF for x in db]


# Scores drawn to tie: few distinct values, both zeros, NaN, +-inf, values
# in [kBigHalf, kBig) and kBig itself, and arbitrary floats.
SPECIAL = [0.0, -0.0, 1.0, 2.0, -3.5, 7.25, float("nan"), float("inf"), float("-inf"),
           1.7e38, 1.75e38, 3.3e38, 3.4e38, 1e-30, -1e-30]
score_st = st.one_of(st.sampled_from(SPECIAL),
                     st.floats(width=32, allow_nan=True, allow_infinity=True),
                     st.integers(-4, 4).map(float))


@pytest.mark.parametrize("m", [8, 16])
@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_network_screen_equals_the_walk(m, data):
    """Ties (across the m-th slot too), -0 and +0, NaN, inf, scores in
    [kBigHalf, kBig), k_active below m: the list equals the twin's."""
    k_active = data.draw(st.integers(1, 3 * m + 5))
    scores = [np.float32(x) for x in data.draw(st.lists(score_st, min_size=k_active,
                                                        max_size=k_active))]
    model = prune_screen_model(scores, k_active, m)
    assert _same(model, twin(scores, k_active, m))
    assert _same(model, walk(scores, range(k_active), m))


@pytest.mark.parametrize("m,k_active", [(8, 64), (16, 256), (16, 512)])
def test_network_screen_on_close_scores(m, k_active):
    """Scores a few ulps apart, where keys share buckets (their low bits
    hold the index): all of them close (the walk, on equal scores or a
    shared bucket at the m-th key), or the best m distinct and close above
    a gap (the kept scores sorted, no walk)."""
    rng = np.random.default_rng(k_active)
    PATHS.clear()
    for trial in range(20):
        base = np.array([rng.uniform(-2e3, 2e3)], np.float32).view(np.int32)[0]
        if trial % 2:
            bits = base + 3 * rng.permutation(k_active)
            bits[rng.permutation(k_active)[m:]] += 1 << 20
        else:
            bits = base + rng.integers(0, 4 * k_active, k_active)
        scores = [np.float32(s) for s in np.asarray(bits, np.int32).view(np.float32)]
        assert _same(prune_screen_model(scores, k_active, m), walk(scores, range(k_active), m))
    assert PATHS["sorted"] and PATHS["walk"]


def test_the_walk_keeps_equal_scores_out_of_index_order():
    """Why the screen falls back to the walk on equal scores: a smaller
    arrival moves the first of a run of equal scores to the run's end."""
    scores = [np.float32(v) for v in (5.0, 5.0, 9.0, 1.0)]
    d, idx = twin(scores, 4, 8)
    assert idx[:3] == [3, 1, 0] and d[1] == d[2] == 5.0


def test_sort_networks_are_batchers_and_sort():
    """`screen.cuh`'s KM_BATCHER8 and KM_BATCHER16 are Batcher's loops'
    19 and 63 compare-exchanges, and they sort."""
    text = (CSRC / "screen.cuh").read_text()
    rng = np.random.default_rng(0)
    for n, count in ((8, 19), (16, 63)):
        pairs = []
        sort_network(n, lambda a, b: pairs.append((a, b)))
        body = re.search(rf"#define KM_BATCHER{n}\(X\) \\\n(.*?)\n(?:\n|#)", text, re.S).group(1)
        assert [tuple(map(int, ab)) for ab in re.findall(r"X\((\d+), (\d+)\)", body)] == pairs
        assert len(pairs) == count
        for _ in range(200):
            v = list(rng.integers(0, 5, n))
            for a, b in pairs:
                v[a], v[b] = min(v[a], v[b]), max(v[a], v[b])
            assert v == sorted(v)


def _srgb8_chain(c: np.ndarray) -> np.ndarray:
    """`linear_to_srgb8_pow` in numpy float32 (the CPU's powf)."""
    c = np.asarray(c, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        safe = np.maximum(c, np.float32(0.0))
        v = np.where(c > np.float32(0.0031308),
                     np.float32(1.055) * safe ** np.float32(1.0 / 2.4) - np.float32(0.055),
                     np.float32(12.92) * c)
        v = np.where(np.isnan(v), np.float32(0.0), v)
        clipped = np.minimum(np.maximum(v, np.float32(0.0)), np.float32(1.0))
        return np.rint(clipped * np.float32(255.0)).astype(np.int64)


def test_srgb_step_points_are_the_encodes_steps():
    """The committed step points against the direct chain on the CPU,
    whose `powf` may round otherwise within a few ulps of a step: 64 ulps
    below each point the chain gives less, 64 above at least its byte, and
    on random inputs away from the points the search gives the chain's
    byte; NaN, -0, negatives and +inf as the kernel maps them."""
    steps = srgb_steps.committed_steps()
    assert len(steps) == 256 and steps[0] == 0
    assert all(0 < a < b for a, b in zip(steps[1:], steps[2:]))
    points = np.array(steps[1:], np.int32)
    below = (points - 64).view(np.float32)
    above = (points + 64).view(np.float32)
    j = np.arange(1, 256)
    assert (_srgb8_chain(below) < j).all() and (_srgb8_chain(above) >= j).all()
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.1, 1.1, 200_000).astype(np.float32)
    bits = x.view(np.int32)
    far = np.abs(bits[:, None] - points[None, :]).min(1) > 64
    assert far.mean() > 0.99
    assert (srgb_steps.search_model(x[far], steps) == _srgb8_chain(x[far])).all()
    special = np.array([np.nan, -0.0, 0.0, -1.0, -np.inf, np.inf, 1.0, 2.0], np.float32)
    assert srgb_steps.search_model(special, steps).tolist() == [0, 0, 0, 0, 0, 255, 255, 255]


def test_macro_lines_round_trip():
    """`srgb_steps.macro_lines` writes what `committed_steps` reads."""
    steps = srgb_steps.committed_steps()
    text = (CSRC / "colorspace.cuh").read_text()
    body = re.search(r"#define KM_SRGB8_STEPS \\\n(.*?)\nstatic", text, re.S).group(1)
    assert srgb_steps.macro_lines(steps) == body
