"""kmeans_tpu_torch: the k-means colour quantizer of `kmeans_tpu`, in PyTorch.

A port of the JAX package to PyTorch and CUDA. It imports neither JAX nor
`kmeans_tpu`. `ImageProcessor(device=None)` runs on CUDA, where the assign
pass is a hand-written kernel (`csrc/quantize_assign.cu`);
`ImageProcessor(device="cpu")` runs the same path in plain PyTorch.
"""

from kmeans_tpu_torch.api import Algorithm, ColorSpace, ImageProcessor, ReduceMode
from kmeans_tpu_torch.image import Image

__all__ = ["Algorithm", "ColorSpace", "Image", "ImageProcessor", "ReduceMode"]
