"""Seconds from the start of the process to the first timed call: torch
and the CUDA context, the program's cached libraries (built on a
checkout's first run), the pool made from the seed, and the warm calls."""


def read(run):
    return run.setup_s
