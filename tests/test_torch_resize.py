"""PyTorch port vs the JAX package: the training shrink."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import resize as ref_rs
from kmeans_tpu_torch.ops import resize as rs

torch.set_num_threads(2)

_ref_resize_jit = jax.jit(ref_rs.resize_uint8, static_argnums=(1, 2))


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
     ((7, 5), (3, 2)), ((512, 96), (256, 48)), ((1080, 1920), (144, 256)),
     ((1350, 1080), (256, 204)), ((61, 97), (40, 64))],
)
def test_resize_uint8_identical_bytes(src, dst):
    """Same bytes as the reference's `resize_uint8` as its entry points run
    it, jitted at static sizes: XLA folds the coordinate's divide and
    multiply into one constant, contracts the coordinate and the blends
    into fused multiply-adds and multiplies by 1/255. Run op by op, the
    reference rounds the 0.5 ties apart (3.9% of the bytes of 1080p ->
    256x144); the count of differing bytes is reported, and the bar is 0."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = np.asarray(_ref_resize_jit(jnp.asarray(img), *dst))
    got = rs.resize_uint8(torch.from_numpy(img), *dst).numpy()
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {got.size} bytes differ"


def test_resize_bilinear_float_matches():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (40, 64, 3)).astype(np.float32)
    want = np.asarray(ref_rs.resize_bilinear(jnp.asarray(img), 17, 23))
    got = rs.resize_bilinear(torch.from_numpy(img), 17, 23).numpy()
    np.testing.assert_array_equal(got, want)
