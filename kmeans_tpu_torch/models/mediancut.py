"""Median-cut colour quantizer (host numpy), for `algo=Algorithm.MEDIANCUT`.

A copy of `kmeans_tpu/models/mediancut.py` (`extract_palette_mediancut:24`),
kept inside the port because importing `kmeans_tpu` imports JAX. Integer
arithmetic throughout, so the same input gives the reference's palette.

Heckbert's formulation: aggregate pixels to (unique colour, count) pairs;
start with one box over all colours; repeatedly split the box with the
largest (range * population) priority at the weighted median of its
longest RGB axis until `color_count` boxes exist (or none can be split);
each box yields the weighted integer mean of its colours.
"""

from __future__ import annotations

import numpy as np


def extract_palette_mediancut(
    rgb: np.ndarray, color_count: int
) -> list[tuple[int, int, int, int]]:
    """`[N, 3]` uint8 pixels -> up to `color_count` RGBA tuples."""
    if color_count <= 0:
        return []
    rgb = np.asarray(rgb, dtype=np.uint8).reshape(-1, 3)
    packed = (
        rgb[:, 0].astype(np.uint32) << 16
        | rgb[:, 1].astype(np.uint32) << 8
        | rgb[:, 2].astype(np.uint32)
    )
    uniq, counts = np.unique(packed, return_counts=True)
    if len(uniq) == 0:
        return []
    colors = np.stack(
        [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
    ).astype(np.int64)
    counts = counts.astype(np.int64)

    # Each box is an index array into `colors`.
    boxes = [np.arange(len(colors))]

    def priority(box: np.ndarray) -> int:
        c = colors[box]
        ranges = c.max(axis=0) - c.min(axis=0)
        return int(ranges.max()) * int(counts[box].sum())

    while len(boxes) < color_count:
        # Split the highest-priority splittable box.
        order = sorted(range(len(boxes)), key=lambda i: priority(boxes[i]), reverse=True)
        for i in order:
            box = boxes[i]
            c = colors[box]
            ranges = c.max(axis=0) - c.min(axis=0)
            if ranges.max() == 0 or len(box) < 2:
                continue
            axis = int(ranges.argmax())
            sort_idx = box[np.argsort(c[:, axis], kind="stable")]
            w = counts[sort_idx]
            cum = np.cumsum(w)
            half = cum[-1] / 2
            split = int(np.searchsorted(cum, half)) + 1
            split = min(max(split, 1), len(sort_idx) - 1)
            boxes[i] = sort_idx[:split]
            boxes.append(sort_idx[split:])
            break
        else:
            break  # nothing splittable left

    palette = []
    for box in boxes:
        w = counts[box]
        total = int(w.sum())
        mean = (colors[box] * w[:, None]).sum(axis=0) // total
        palette.append((int(mean[0]), int(mean[1]), int(mean[2]), 255))
    return sorted(set(palette))
