"""The port on a CUDA card: the hand-written kernel against its plain twin.

These tests need a card and skip without one. This file imports neither
JAX nor `kmeans_tpu`, so it also runs where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`tests/conftest.py` configures JAX, hence `--noconftest` there).
"""

import numpy as np
import pytest
import torch

from kmeans_tpu_torch import ImageProcessor, ReduceMode
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.quantize import dither_threshold

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(h, w, k, seed, device):
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    pal = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(device)
    return rgb, srgb8_to_lab(pal).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replace", "dither"])
@pytest.mark.parametrize("k", [1, 4, 8, 17, 257, 1024])
def test_kernel_matches_twin(cuda, k, mode):
    rgb, cents = _case(61, 97, k, 500 + k, cuda)
    thr = dither_threshold(cents) if mode == "dither" else 0.0
    before = kernels.ASSIGN_PACKED_LAUNCHES
    got = kernels.assign_packed(rgb, cents, thr, mode=mode, row_offset=1)
    want = kernels.assign_packed_reference(rgb, cents, thr, mode=mode, row_offset=1)
    torch.cuda.synchronize()
    assert kernels.ASSIGN_PACKED_LAUNCHES == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_reduce_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:90, 0:130]
    rgb = np.stack([x * 255 // 130, y * 255 // 90, (x + y) * 255 // 220], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    img = np.concatenate([rgb, np.full((90, 130, 1), 255, np.uint8)], -1)
    before = kernels.ASSIGN_PACKED_LAUNCHES
    on_card = ImageProcessor().reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels
    assert kernels.ASSIGN_PACKED_LAUNCHES == before + 1
    on_cpu = ImageProcessor(device="cpu").reduce(8, img, reduce_mode=ReduceMode.DITHER).pixels
    np.testing.assert_array_equal(on_card, on_cpu)
