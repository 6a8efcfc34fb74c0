"""Batched GIF example: the k=2..15 frames in one batched training and one
frames pass (examples/batched.py, the reference's
`core/examples/parallel.rs:7-65`).

Usage: python -m kmeans_tpu_torch.examples.batched input.png [output.gif] [--cpu]
"""

from __future__ import annotations

import time

from kmeans_tpu_torch.api import ImageProcessor, ReduceMode
from kmeans_tpu_torch.examples._args import input_output, output_path, parse, require_file
from kmeans_tpu_torch.utils.imageio import load_image, save_gif

KS = list(range(2, 16))


def main(argv=None) -> int:
    args, device = parse(__doc__.splitlines()[0], argv, lambda p: input_output(p, ".gif"))
    if not require_file(args.input):
        return 2
    dst = output_path(args, ".gif")
    start = time.time()
    image = load_image(args.input)
    processor = ImageProcessor(device=device)
    frames = processor.reduce_batch(image, KS, ReduceMode.REPLACE)
    save_gif(frames, dst, delay_cs=100, loop=True)
    print(f"Time elapsed in creating gif is: {time.time() - start:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
