"""Host work of a call in ms: the program's `host_prep` (alpha strip) and
`unpack` (readback unpack) phases over the traced window, by its phase
recorder (`kmeans_tpu_torch.utils.profiling.collect_phases`), a mean a
call."""


def read(run):
    if not run.phases or not run.calls:
        return None
    return (run.phases.get("host_prep", 0.0) + run.phases.get("unpack", 0.0)) / len(run.calls) * 1e3
