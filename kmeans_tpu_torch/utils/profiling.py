"""Tracing and per-phase wall-clock attribution for the port's entry points.

Port of `kmeans_tpu/utils/profiling.py`:

- `trace(log_dir)` records a `torch.profiler` trace of host and CUDA
  activity into `log_dir` (TensorBoard's trace format, viewable in
  Perfetto), the counterpart of the reference's `jax.profiler` trace;
- `annotate(name)` labels a region in such a trace
  (`torch.profiler.record_function`, the reference's `jax.named_scope`);
- `Timer(name)` times a section on the host's wall clock and logs it.

And the phase recorder, as `api.py` uses it: `phase(name)` adds
wall-clock time to `name` while a `collect_phases(out)` block is open,
and is a no-op otherwise. `phase_sync(*tensors)` ends a phase on the
device's clock: while recording, it waits for the CUDA device
(`torch.cuda.synchronize`), so asynchronous work is billed to the phase
that launched it. Each forced wait is counted under `"_syncs"`; an
unrecorded call pays none of them.

The accumulator is a context variable, so recording in one thread or task
does not leak into another; a worker thread run in a copy of the
recording thread's context (`contextvars.copy_context().run`) adds to the
same accumulator, under a lock. `recording()` says whether a block is
open.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
import time

import torch

log = logging.getLogger("kmeans_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record host and CUDA activity of the block into `log_dir`
    (kmeans_tpu/utils/profiling.py:28). Without a CUDA device only the
    host's activity is recorded."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    log.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Label a region in a profiler trace (kmeans_tpu/utils/profiling.py:38)."""
    return torch.profiler.record_function(name)


class Timer:
    """Wall-clock section timer, `with Timer("reduce") as t: ...`; the
    seconds land in `t.elapsed` (kmeans_tpu/utils/profiling.py:43)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.name:
            log.info("%s: %.3fs", self.name, self.elapsed)
        return False

_phase_acc: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kmeans_tpu_torch_phases", default=None
)
_phase_lock = threading.Lock()


def _add(acc: dict, name: str, value) -> None:
    with _phase_lock:
        acc[name] = acc.get(name, 0) + value


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
        _add(acc, name, time.perf_counter() - t0)


def phase_sync(*tensors) -> None:
    """While recording, wait for the CUDA work behind `tensors`."""
    acc = _phase_acc.get()
    if acc is None:
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            _add(acc, "_syncs", 1)


@contextlib.contextmanager
def collect_phases(out: dict):
    """Record phases into `out` for the duration of the block."""
    token = _phase_acc.set(out)
    try:
        yield out
    finally:
        _phase_acc.reset(token)


def recording() -> bool:
    """Whether a `collect_phases` block is open in this context
    (kmeans_tpu/utils/profiling.py:136)."""
    return _phase_acc.get() is not None
