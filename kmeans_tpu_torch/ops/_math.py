"""Float32 arithmetic helpers that keep the port's rounding IEEE-exact.

PyTorch's CUDA `tensor / python_number` multiplies by the reciprocal of
the number instead of dividing (`div_true_kernel_cuda`), which can differ
from a true division in the last bit. The JAX package, its Pallas kernel
and the port's CUDA kernel all divide, so every division by a constant in
the port goes through `div`, which divides by a 0-dim tensor on the
operand's own device: that is a true IEEE division on the CPU and on CUDA,
and it launches no host-to-device copy.
"""

from __future__ import annotations

import torch


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-dim tensor of `like`'s dtype on `like`'s device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def div(num: torch.Tensor, den: float) -> torch.Tensor:
    """`num / den` as a true IEEE division on every device."""
    return torch.div(num, const(den, num))
