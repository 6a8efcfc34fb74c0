"""90th percentile of the wall time of every call in the window, host RGBA
in to host RGBA out, in ms (inclusive quantiles over all calls)."""

import statistics


def read(run):
    seconds = [s for _, s, _ in run.calls]
    if len(seconds) < 2:
        return None
    return statistics.quantiles(seconds, n=10, method="inclusive")[8] * 1e3
