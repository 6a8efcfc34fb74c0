"""Share of its roofline that the output pass (`assign_kernel`, one launch a
call for one image or all its frames) reaches over the profiled cycle, in
percent.

Frozen count of the exact CIE94 replace or dither pass over P output
pixels at k colours, whatever the kernel does: each pixel 33 float32
operations into Lab (18 for the matrix, 9 for the f-functions with each
cube root one, 6 for L, a, b), 9 of its own (chroma and the CIE94
weights), 4 more under dither (the Bayer offset times the threshold,
added to L, a, b), and 18 for each centroid (the distance and its argmin
update); bytes: the RGB read once (3 a pixel), the packed indices written
once (ceil(log2 k) bits a pixel), the 256-entry gamma table and each
frame's centroids read once. The bound is the larger of operations over
67 TFLOP/s and bytes over 3.35 TB/s (`gpubench/peaks.py`)."""

import math

from gpubench.peaks import bound_s

LAB_OPS = 33
PIXEL_OPS = 9
DITHER_OPS = 4
PAIR_OPS = 18


def pass_bound_s(pixels: int, frames: int, k: int, mode: str) -> float:
    per_pixel = LAB_OPS + PIXEL_OPS + (DITHER_OPS if mode == "dither" else 0) + PAIR_OPS * k
    index_bytes = pixels * max(1, math.ceil(math.log2(k))) / 8
    return bound_s(pixels * per_pixel, 3 * pixels + index_bytes + 1024 + frames * 12 * k)


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.device_ops
    launches = sum(n for name, (n, _) in ops.items() if "assign_kernel" in name)
    us = sum(t for name, (_, t) in ops.items() if "assign_kernel" in name)
    if launches == 0 or us <= 0:
        return None
    shape, traffic = run.cell.config["image"], run.cell.traffic
    frames = shape.get("frames", 1)
    per_call = pass_bound_s(run.profiled_pixels // run.trace.calls, frames, traffic["colors"],
                            traffic["mode"])
    return 100.0 * run.trace.calls * per_call / (us / 1e6)
