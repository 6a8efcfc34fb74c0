"""Share of the profiled cycle of the pool (host clock, first call's start
to last call's end) in which no kernel, copy or set ran on the device, in
percent."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
