"""Lloyd iterations of a call's training (`ImageProcessor.last_iterations`:
of a batch, its longest member's), a mean over the traced window's calls."""


def read(run):
    its = [i for i in run.iterations if i is not None]
    return sum(its) / len(its) if its else None
