"""Multi-device sharding in one process: meshes, pixel-sharded training,
row-sharded output passes (kmeans_tpu/parallel/__init__.py)."""

from kmeans_tpu_torch.parallel.distributed import fit_sharded, fit_sharded_batch
from kmeans_tpu_torch.parallel.mesh import DATA_AXIS, PIXEL_AXIS, Mesh, make_mesh
from kmeans_tpu_torch.parallel.sharded_ops import quantize_image_sharded

__all__ = [
    "DATA_AXIS",
    "PIXEL_AXIS",
    "Mesh",
    "make_mesh",
    "fit_sharded",
    "fit_sharded_batch",
    "quantize_image_sharded",
]
