"""The dither threshold's first-trigger walk in plain PyTorch, and the palettes that time it.

`first_trigger_walk` is a plain model of `csrc/dither_threshold.cu`: it
walks a palette as the kernel does, round by round, scoring a window of
candidates at once against the round's state `(a, b, d_ab)`, taking the
round's first candidate that triggers the serial walk's update, applying
it, and starting the next round just after it; a round with no trigger
moves past its window. The window is `slot * n` candidates, `n` doubling
up to `warps` after a round with no trigger and halving after one with a
trigger, as the kernel's warps do. The distances are
`ops/delta_e.py::metric_fns`' on the same inputs, so the threshold is the
serial twin's (`ops/quantize.py::dither_threshold_reference`) bit for bit
wherever the same distance calls give the same bits. It returns the
threshold, the number of updates the walk made, and the rounds the kernel
takes. No entry point calls it: `chip_smoke.py` and `tools/kernel_times.py`
count each timed palette's updates with it on the card, and
`tests/test_torch_threshold_scan.py` holds it to the twin on the CPU.

On the CPU, ATen scores 2 SIMD vectors of float32 or more (16 or 32) on a
vectorized path whose `atan2` can differ from the scalar one by an ulp;
the twin's calls are scalars. `piece` splits each window into calls of at
most that many candidates (15 keeps every call on the scalar path).
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops.delta_e import metric_fns


def _distances(dist, cand: torch.Tensor, x: torch.Tensor, piece: int | None) -> torch.Tensor:
    """`dist(cand, x)` in calls of at most `piece` candidates; `x` is one
    colour or one per candidate."""
    step = piece or max(cand.shape[0], 1)
    return torch.cat([dist(cand[i:i + step], x if x.dim() == 1 else x[i:i + step])
                      for i in range(0, cand.shape[0], step)])


def first_trigger_walk(palette: torch.Tensor, k_active=None, metric: str = "cie94",
                       slot: int = 32, warps: int = 1, piece: int | None = None):
    """`(threshold, updates, rounds)` of one `[K, 3]` palette: the
    threshold a 0-dim float32 tensor on the palette's device."""
    dist, _ = metric_fns(metric)
    k = palette.shape[0]
    ka = k if k_active is None else int(k_active)
    a = palette[0]
    b = palette[min(1, k - 1)]
    dab = dist(a, b)
    end = min(k, ka)
    s, n, updates, rounds = 2, 1, 0, 0
    while s < end:
        rounds += 1
        cand = palette[s:min(s + slot * n, end)]
        da = _distances(dist, cand, a, piece)
        db = _distances(dist, cand, b, piece)
        first = (da > db) & (da > dab)
        trig = first | (db > dab)
        hits = torch.nonzero(trig).flatten()
        if hits.numel() == 0:
            s += slot * n
            n = min(2 * n, warps)
            continue
        h = int(hits[0])
        if bool(first[h]):
            b, dab = cand[h], da[h]
        else:
            a, dab = cand[h], db[h]
        updates += 1
        s += h + 1
        n = max(1, n // 2)
    return dab / torch.sqrt(torch.full((), float(ka), device=palette.device)), updates, rounds


def count_updates(palette: torch.Tensor, metric: str = "cie94") -> int:
    """The serial walk's updates on a `[K, 3]` palette (every entry
    active). A palette whose every step replaces b (each candidate farther
    from p[0] than from b and than d_ab) is recognised in one pass, with
    the walk's own distances; any other is walked by `first_trigger_walk`
    with a wide window. On the CPU both score 15 candidates a call."""
    dist, _ = metric_fns(metric)
    piece = 15 if palette.device.type == "cpu" else None
    k = palette.shape[0]
    if k > 2:
        cand = palette[2:]
        da = _distances(dist, cand, palette[0], piece)
        db = _distances(dist, cand, palette[1:-1], piece)
        dab = torch.cat([dist(palette[0], palette[1]).reshape(1), da[:-1]])
        if bool(((da > db) & (da > dab)).all()):
            return k - 2
    return first_trigger_walk(palette, metric=metric, slot=4096, piece=piece)[1]


def every_step_palette(k: int, device=None) -> torch.Tensor:
    """`[k, 3]` float32 greys of rising lightness, L = 100 i / (k - 1): each
    candidate lies farther from p[0] than the one before it (b, then
    d_ab) and nearer to b than to p[0], so the serial walk replaces b at
    every step under both metrics (on greys CIE94 is |dL|, and CIEDE2000's
    dL / S_L grows with L while the mean lightness stays below 50)."""
    l = torch.arange(k, dtype=torch.float64) * (100.0 / max(k - 1, 1))
    pal = torch.zeros((k, 3), dtype=torch.float32)
    pal[:, 0] = l.to(torch.float32)
    return pal.to(device)
