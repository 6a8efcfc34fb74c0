"""Device meshes: a `[data, pixel]` grid of `torch.device`s in one process.

Port of `kmeans_tpu/parallel/mesh.py`. The JAX package drives every
device from one Python process through a `jax.sharding.Mesh`; so does
this package, with the grid held here and each shard's tensors on its
own device:

- **data**: independent frames split across the rows of the grid;
- **pixel**: one image's rows or pixels split across a row's devices, the
  per-cluster partials and the seeding's argmax combined by the plain
  functions of `parallel/collectives.py`.

There is no process group and no collective library: the only traffic
between shards is a few small partials a step, moved to the mesh's first
device and added there in shard order. A mesh may name one device more
than once (`["cuda:0"] * 4` on one card, `["cpu"] * 8` in the tests), so
one card and the CPU run the real 2-, 4- and 8-shard code.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
PIXEL_AXIS = "pixel"


class Mesh:
    """A `[data, pixel]` grid of devices of one type (all CPU or all CUDA).
    `devices` is the grid as a numpy object array, `shape` maps each axis
    name to its size (as the JAX mesh's does), `root` is the first device,
    where the shards' partials meet."""

    axis_names = (DATA_AXIS, PIXEL_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], PIXEL_AXIS: devices.shape[1]}

    @property
    def root(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def device_type(self) -> str:
        return self.root.type

    def row(self, i: int = 0) -> list:
        """The pixel-axis devices of data row `i`."""
        return list(self.devices[i])

    def __repr__(self) -> str:
        return f"Mesh({self.shape[DATA_AXIS]}x{self.shape[PIXEL_AXIS]}, {list(self.devices.flat)})"


def _as_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the mesh names {device} and no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"the mesh names {device}; {torch.cuda.device_count()} "
                               "CUDA device(s) are visible")
    elif device.type != "cpu":
        raise ValueError(f"mesh devices must be cuda or cpu, got {device}")
    return device


def make_mesh(devices=None, data: int = 1, pixel: int | None = None) -> Mesh:
    """Build a `(data, pixel)` mesh (kmeans_tpu/parallel/mesh.py:26). With
    defaults, every device goes to the pixel axis. `devices=None` takes
    every visible CUDA device and raises when there is none; a device may
    repeat. A list that mixes CPU and CUDA devices raises: nothing moves
    work to the CPU quietly."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every visible CUDA device and none is "
                               "available; pass devices=['cpu'] * n for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {[str(d) for d in devices]}")
    devices = [_as_device(d) for d in devices]
    n = len(devices)
    if pixel is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        pixel = n // data
    if data * pixel != n:
        raise ValueError(f"mesh {data}x{pixel} != {n} devices")
    grid = np.empty((data, pixel), dtype=object)
    for i, d in enumerate(devices):
        grid[i // pixel, i % pixel] = d
    return Mesh(grid)
