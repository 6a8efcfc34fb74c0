"""kmeans_tpu_torch: the k-means colour quantizer of `kmeans_tpu`, in PyTorch.

A port of the JAX package to PyTorch and CUDA. It imports neither JAX nor
`kmeans_tpu`. `ImageProcessor(device=None)` runs on CUDA, where the assign
pass (`csrc/quantize_assign.cu`), the meld pass (`csrc/quantize_meld.cu`)
and full-resolution training's Lloyd step (`csrc/lloyd_accumulate.cu`)
are hand-written kernels, under CIE94 or CIEDE2000 (`delta_e=`);
`ImageProcessor(device="cpu")` runs the same path in plain PyTorch.
The host's alpha strip, readback unpacks and image codec are a C runtime
built at first use (`runtime/`). The command line is `python -m
kmeans_tpu_torch` (`cli.py`), the HTTP service `python -m
kmeans_tpu_torch.serve` (`serve.py`).
"""

from kmeans_tpu_torch.api import Algorithm, ColorSpace, ImageProcessor, ReduceMode
from kmeans_tpu_torch.image import Image, borrowed_pixel, copied_pixel

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "ColorSpace",
    "Image",
    "ImageProcessor",
    "ReduceMode",
    "borrowed_pixel",
    "copied_pixel",
    "__version__",
]
