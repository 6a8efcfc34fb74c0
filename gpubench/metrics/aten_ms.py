"""Device ms a call in kernels that are not the program's own CUDA library's:
PyTorch's own kernels (eager seeding and Lloyd, Lab, the shrink, gathers)
and cuBLAS, over the profiled cycle of the pool. The program's kernels are
known by their names (`PROGRAM_KERNELS`); copies and sets are not
kernels."""

PROGRAM_KERNELS = ("lloyd_tile_kernel", "sum_blocks_kernel", "assign_kernel", "meld_kernel",
                   "dither_threshold_kernel", "srgb8_steps_kernel")


def is_program_kernel(name: str) -> bool:
    return any(k in name for k in PROGRAM_KERNELS)


def read(run):
    if run.trace is None:
        return None
    us = sum(total for name, (_, total) in run.trace.device_ops.items()
             if not is_program_kernel(name) and not name.startswith("Memcpy")
             and not name.startswith("Memset"))
    return us / 1e3 / run.trace.calls
