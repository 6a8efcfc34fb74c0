"""PyTorch port vs the JAX package: the training shrink."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import resize as ref_rs
from kmeans_tpu_torch.ops import resize as rs

torch.set_num_threads(2)


def test_shrunk_dimensions_equal_over_a_grid():
    for w in list(range(1, 40)) + [255, 256, 257, 300, 420, 1000, 3840]:
        for h in list(range(1, 40, 3)) + [144, 256, 257, 2160]:
            for cap in (None, 1, 16, 256):
                assert rs.shrunk_dimensions(w, h, cap) == ref_rs.shrunk_dimensions(
                    w, h, cap
                ), (w, h, cap)


@pytest.mark.parametrize(
    "src,dst",
    [((300, 420), (182, 256)), ((300, 420), (100, 37)), ((61, 97), (61, 97)),
     ((7, 5), (3, 2)), ((512, 96), (256, 48))],
)
def test_resize_uint8_identical_bytes(src, dst):
    """Same bytes as the reference's `resize_uint8` run op by op (the
    reference's jitted training fuses these ops and may contract them into
    FMAs, which can move a pixel by one u8 step; that is counted in
    tests/test_torch_api.py at the palette level)."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = np.asarray(ref_rs.resize_uint8(jnp.asarray(img), *dst))
    got = rs.resize_uint8(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_bilinear_float_matches():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (40, 64, 3)).astype(np.float32)
    want = np.asarray(ref_rs.resize_bilinear(jnp.asarray(img), 17, 23))
    got = rs.resize_bilinear(torch.from_numpy(img), 17, 23).numpy()
    np.testing.assert_array_equal(got, want)
