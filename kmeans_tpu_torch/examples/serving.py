"""Serving example: images of many sizes through `bucketing=True`
(examples/serving.py). Sizes round up to the {4,5,6,7}*2^k ladder of
buckets, `warmup` runs each bucket the traffic will hit once before the
first request, and `reduce_many` / `palette_many` serve mixed sizes with
one training loop and one output launch per bucket. The images are
generated from seeds; nothing is read.

Usage: python -m kmeans_tpu_torch.examples.serving [--requests WxH,...] [--cpu]
(`--requests` replaces the five request sizes; the first two are warmed.)
"""

from __future__ import annotations

import time

import numpy as np

from kmeans_tpu_torch.api import ImageProcessor
from kmeans_tpu_torch.examples._args import parse
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils.bucketing import bucket_shape

EXPECTED_SIZES = [(640, 480), (800, 600)]
REQUESTS = [(640, 480), (600, 450), (620, 500), (800, 600), (860, 640)]
K = 8


def random_image(w: int, h: int, seed: int) -> Image:
    """Four noisy colour blobs (examples/serving.py:29)."""
    rng = np.random.default_rng(seed)
    base = np.array([[220, 50, 40], [40, 200, 70], [60, 70, 220], [235, 220, 90]])
    idx = rng.integers(0, 4, (h, w))
    rgb = np.clip(base[idx] + rng.integers(-12, 13, (h, w, 3)), 0, 255)
    rgba = np.concatenate([rgb.astype(np.uint8), np.full((h, w, 1), 255, np.uint8)], -1)
    return Image((w, h), rgba)


def run(processor: ImageProcessor, requests=REQUESTS, expected=EXPECTED_SIZES) -> dict:
    """The example's calls on `processor`; returns their outputs by name
    (`"reduce"`, a list; `"reduce_many"`; `"palette_many"`) with the
    request images (`"frames"`, `"requests"`)."""
    t0 = time.time()
    n = processor.warmup(expected, color_counts=[K])
    print(f"warmup: {n} bucket(s) in {time.time() - t0:.1f}s")
    outs, imgs = [], []
    for i, (w, h) in enumerate(requests):
        img = random_image(w, h, seed=i)
        t0 = time.time()
        out = processor.reduce(K, img)
        k = len(np.unique(out.pixels.reshape(-1, 4), axis=0))
        bh, bw = bucket_shape(h, w)
        print(f"request {w}x{h} (bucket {bw}x{bh}): {time.time() - t0:.3f}s, {k} colors")
        outs.append(out)
        imgs.append(img)
    frames = [random_image(w, h, seed=10 + i) for i, (w, h) in enumerate(requests)]
    t0 = time.time()
    many = processor.reduce_many(frames, K)
    print(f"reduce_many: {len(many)} mixed-size images, {time.time() - t0:.3f}s")
    t0 = time.time()
    pals = processor.palette_many(frames, K)
    hexes = ",".join(f"#{r:02X}{g:02X}{b:02X}" for r, g, b, _ in pals[0])
    print(f"palette_many: {len(pals)} palettes in {time.time() - t0:.3f}s, first: {hexes}")
    return {"reduce": outs, "requests": imgs, "frames": frames, "reduce_many": many,
            "palette_many": pals}


def _sizes(text: str) -> list:
    return [tuple(int(v) for v in size.split("x")) for size in text.split(",")]


def main(argv=None) -> int:
    args, device = parse(__doc__.splitlines()[0], argv, lambda p: p.add_argument(
        "--requests", type=_sizes, default=REQUESTS, help="request sizes, WxH,WxH,..."))
    run(ImageProcessor(device=device, bucketing=True), args.requests, args.requests[:2])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
