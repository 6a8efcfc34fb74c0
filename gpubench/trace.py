"""Reading a `torch.profiler` trace of whole calls: device busy time, kernel
time by name, and the idle gaps labelled by what the host was doing.

`profile_calls(fn, items)` runs `fn(item)` for each item under the
profiler (host and CUDA activity), each call inside a
`record_function(CALL)` span, exports the chrome trace to a temporary file
in `TMPDIR`, and returns a `Trace`. The traced window runs from the first
call's start to the last call's end on the host's clock; busy time is the
union of the device's kernels, copies and sets inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

CALL = "gpubench.call"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
NO_OP = "host outside any profiled op"


@dataclass
class Trace:
    window_us: float
    busy_us: float
    calls: int
    # name -> [launches, total microseconds], device activity only
    device_ops: dict = field(default_factory=dict)
    # host label -> idle microseconds
    idle_by_host: dict = field(default_factory=dict)


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(host_events, starts, t):
    """Label of the innermost host op containing time `t`: with nested
    ops, the latest-starting one that has not ended by `t`."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        start, end, name = host_events[i]
        if end >= t:
            return name
        i -= 1
    return NO_OP


def read_events(events: list) -> Trace:
    """A `Trace` from chrome-trace events (complete events, `"ph": "X"`)."""
    calls = [e for e in events if e.get("name") == CALL and e.get("cat") in HOST_CATS]
    if not calls:
        raise ValueError("no profiled call in the trace")
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    device, ops = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        entry = ops.setdefault(e["name"], [0, 0.0])
        entry[0] += 1
        entry[1] += end - start
        lo, hi = max(start, t0), min(end, t1)
        if hi > lo:
            device.append((lo, hi))
    busy = _union(device)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != CALL)
    starts = [h[0] for h in host]
    idle = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end > gap_start:
            label = _innermost(host, starts, (gap_start + gap_end) / 2)
            idle[label] = idle.get(label, 0.0) + gap_end - gap_start
    return Trace(window_us=t1 - t0, busy_us=sum(b - a for a, b in busy), calls=len(calls),
                 device_ops=ops, idle_by_host=idle)


def profile_calls(fn, items) -> Trace:
    """Run `fn(item)` for each item under the profiler (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for item in items:
            with record_function(CALL):
                fn(item)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_events(events)


def top(mapping: dict, n: int = 10, value=lambda v: v) -> list:
    """The `n` largest entries as `[name, seconds]`, names cut to 120 characters."""
    rows = sorted(mapping.items(), key=lambda kv: -value(kv[1]))[:n]
    return [[name[:120], value(v) / 1e6] for name, v in rows]
