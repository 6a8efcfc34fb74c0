"""Multi-device example: pixel-sharded training and the row-sharded
quantize (examples/sharded.py). The mesh spans the CUDA devices present,
or `--shards N` repeats of the first (one card runs every shard); with
`--cpu`, N repeats of the CPU. With four shards or more (an even count),
`reduce_images_sharded` also trains two frames over a 2 x N/2 mesh.

Usage: python -m kmeans_tpu_torch.examples.sharded input.png [k] [output.png]
       [--shards N] [--cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kmeans_tpu_torch.api import ImageProcessor, ReduceMode
from kmeans_tpu_torch.examples._args import parse, require_file
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.models.kmeans import reference_seed_index
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.parallel import fit_sharded, make_mesh, quantize_image_sharded
from kmeans_tpu_torch.utils.imageio import load_image, save_image


def _add(parser) -> None:
    parser.add_argument("input", help="input PNG")
    parser.add_argument("k", nargs="?", type=int, default=8)
    parser.add_argument("output", nargs="?", default=None,
                        help="output PNG (default: <input>-sharded-c<k>.png)")
    parser.add_argument("--shards", type=int, default=None,
                        help="shard count (default: the CUDA devices present; 2 with --cpu)")


def devices_for(device: str, shards: int | None) -> list:
    """The mesh's devices: `shards` repeats of the first device, or every
    CUDA device present."""
    if device == "cpu":
        return [torch.device("cpu")] * (shards or 2)
    if shards is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cuda", 0)] * shards


def run(image: Image, k: int, devices: list) -> tuple:
    """`fit_sharded` of the image's Lab over a `1 x len(devices)` mesh,
    then `quantize_image_sharded` in replace mode. Returns `(output
    [H, W, 4] uint8, iterations)`."""
    mesh = make_mesh(devices, data=1)
    w, h = image.dimensions
    rgb = torch.from_numpy(np.ascontiguousarray(image.pixels[..., :3])).to(devices[0])
    lab = srgb8_to_lab(rgb.reshape(-1, 3))
    n, d = lab.shape[0], len(devices)
    n_pad = (n + d - 1) // d * d
    lab_p = torch.cat([lab, lab.new_zeros((n_pad - n, 3))])
    weight = torch.cat([lab.new_ones(n), lab.new_zeros(n_pad - n)])
    centroids, iters = fit_sharded(mesh, lab_p, weight, k, reference_seed_index(w, h))
    out = np.asarray(quantize_image_sharded(mesh, image.pixels, centroids, mode="replace"))
    return out, int(iters)


def main(argv=None) -> int:
    args, device = parse(__doc__.splitlines()[0], argv, _add)
    if not require_file(args.input):
        return 2
    devices = devices_for(device, args.shards)
    if not devices:
        print("error: no CUDA device (pass --cpu to run on the CPU)")
        return 2
    print(f"mesh: 1x{len(devices)} ({devices[0].type})")
    image = load_image(args.input)
    w, h = image.dimensions
    out, iters = run(image, args.k, devices)
    print(f"converged in {iters} iterations")
    dst = args.output or os.path.basename(args.input).replace(".png", f"-sharded-c{args.k}.png")
    save_image(Image((w, h), out), dst)
    print(f"wrote {dst}: {len(np.unique(out.reshape(-1, 4), axis=0))} colors")
    if len(devices) >= 4 and len(devices) % 2 == 0:
        frames = [image, Image((w, h), image.pixels[::-1].copy())]
        outs = ImageProcessor(device=devices[0]).reduce_images_sharded(
            frames, args.k, ReduceMode.REPLACE, mesh=make_mesh(devices, data=2))
        print(f"reduce_images_sharded: {len(outs)} frames on a 2x{len(devices) // 2} mesh, "
              f"{len(np.unique(outs[0].pixels.reshape(-1, 4), axis=0))} colors")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
