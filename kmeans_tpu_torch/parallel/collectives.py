"""The collectives of the sharded paths, as plain functions in one process.

The JAX package's sharded bodies run under `shard_map`, whose `psum`,
`all_gather` and `axis_index` tie the shards together. Here the shards are
a list, in shard order, of tensors on the mesh's devices, and the same
three semantics are:

- `psum(parts, root)`: the parts moved to `root` and added there in shard
  order, so the total is the same bits on every run and every device mix;
- `all_gather(parts, root)`: the parts stacked on `root`, shard order
  along the new leading axis;
- `shard_rows(n, shards)`: a shard's row count after padding to the shard
  count, from which shard `s` (the index in the list) starts at row
  `s * shard_rows(n, shards)`.

`replicate(tensor, devices)` makes the one copy per distinct device that a
replicated operand needs. Nothing here uses `torch.distributed`: the
traffic between shards is a few small partials a step (`[K, 4]`
accumulator totals, `[K, 3]` sums and `[K]` counts, per-shard argmax
winners).
"""

from __future__ import annotations

import torch


def shard_rows(n: int, shards: int) -> int:
    """Rows (or pixels) of each shard once `n` is padded up to a multiple
    of `shards` (kmeans_tpu/parallel/sharded_ops.py:47, 155-157)."""
    return -(-n // shards)


def to_device(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    if tensor.device == device:
        return tensor
    if device.type == "cuda":
        with torch.cuda.device(device):
            return tensor.to(device)
    return tensor.to(device)


def psum(parts, root: torch.device) -> torch.Tensor:
    """Sum of the shards' tensors on `root`, added in shard order."""
    total = to_device(parts[0], root)
    for part in parts[1:]:
        total = total + to_device(part, root)
    return total


def all_gather(parts, root: torch.device) -> torch.Tensor:
    """The shards' tensors stacked on `root` in shard order."""
    return torch.stack([to_device(p, root) for p in parts])


def replicate(tensor: torch.Tensor, devices) -> list:
    """`tensor` on each of `devices`, one copy per distinct device (a
    device that repeats shares its copy)."""
    copies: dict = {}
    for d in devices:
        if d not in copies:
            copies[d] = to_device(tensor, d)
    return [copies[d] for d in devices]
