"""Host-side helpers: image IO, index unpacking, bucketing and phase timing.

The names of `kmeans_tpu/utils/__init__.py`, from their ports here, but
`enable_compilation_cache`: the port compiles nothing per shape (its CUDA
library is built once into a hashed directory), so it has no XLA cache to
enable (ROADMAP A.13).
"""

from kmeans_tpu_torch.utils.imageio import load_gif, load_image, save_gif, save_image
from kmeans_tpu_torch.utils.profiling import Timer, annotate, trace

__all__ = [
    "HAVE_NATIVE",
    "Timer",
    "annotate",
    "load_gif",
    "load_image",
    "save_gif",
    "save_image",
    "trace",
]


def __getattr__(name: str):
    # HAVE_NATIVE asks the host's compiler once, on first use, not at import.
    if name == "HAVE_NATIVE":
        from kmeans_tpu_torch.utils import imageio

        return imageio.HAVE_NATIVE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
