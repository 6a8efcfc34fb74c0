"""Per-phase wall-clock attribution for the port's entry points.

Port of the phase recorder in `kmeans_tpu/utils/profiling.py`, as
`api.py` uses it: `phase(name)` adds wall-clock time to `name` while a
`collect_phases(out)` block is open, and is a no-op otherwise.
`phase_sync(*tensors)` ends a phase on the device's clock: while recording,
it waits for the CUDA device (`torch.cuda.synchronize`), so asynchronous
work is billed to the phase that launched it. Each forced wait is counted
under `"_syncs"`; an unrecorded call pays none of them.

The accumulator is a context variable, so recording in one thread or task
does not leak into another.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

_phase_acc: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kmeans_tpu_torch_phases", default=None
)


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall-clock seconds into `name` while recording."""
    acc = _phase_acc.get()
    if acc is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0


def phase_sync(*tensors) -> None:
    """While recording, wait for the CUDA work behind `tensors`."""
    acc = _phase_acc.get()
    if acc is None:
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            acc["_syncs"] = acc.get("_syncs", 0) + 1


@contextlib.contextmanager
def collect_phases(out: dict):
    """Record phases into `out` for the duration of the block."""
    token = _phase_acc.set(out)
    try:
        yield out
    finally:
        _phase_acc.reset(token)
