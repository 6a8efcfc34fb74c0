"""Share of its roofline that the tile accumulator (`lloyd_tile_kernel` and
its `sum_blocks_kernel`) reaches over the profiled cycle, in percent.

Frozen count of one Lloyd step of the exact CIE94 algorithm on N training
pixels and k centroids, whatever the kernel does: each pixel 9 float32
operations of its own (chroma and the CIE94 weights), 18 for each centroid
(the distance and its argmin update), 2 for each of the 4 totals it adds
to; bytes: the Lab planes read once (12 a pixel), the centroids read and
the `[k, 4]` totals written once. A step is one accumulator launch. The
bound is the larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s
(`gpubench/peaks.py`). A change that does less work per pixel-centroid
pair (pruning in exact mode) reads above 100% and needs this count redone
first."""

from gpubench.peaks import bound_s
from gpubench.reference.colour import shrunk_size

PIXEL_OPS = 9
PAIR_OPS = 18
TOTAL_OPS = 2 * 4


def step_bound_s(n: int, k: int) -> float:
    return bound_s(n * (PIXEL_OPS + PAIR_OPS * k + TOTAL_OPS), 12 * n + 12 * k + 16 * k)


def training_pixels(cell) -> int:
    shape = cell.config["image"]
    w, h = shrunk_size(shape["width"], shape["height"],
                       cell.processor_options()["train_max_size"])
    return w * h


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.device_ops
    steps = sum(n for name, (n, _) in ops.items() if "lloyd_tile_kernel" in name)
    us = sum(t for name, (_, t) in ops.items()
             if "lloyd_tile_kernel" in name or "sum_blocks_kernel" in name)
    if steps == 0 or us <= 0:
        return None
    k = run.cell.traffic["colors"]
    return 100.0 * steps * step_bound_s(training_pixels(run.cell), k) / (us / 1e6)
