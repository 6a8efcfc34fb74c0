"""The dither threshold's wrappers (`ops/quantize.py`): on a CPU tensor
they run the plain twins, held to the reference's `dither_threshold`
(within 1e-6 relative, as `tests/test_torch_quantize.py`; the frames form
bit for bit in `tests/test_torch_frames.py`); on a
CUDA tensor they launch `csrc/dither_threshold.cu`, held to the twins in
`tests/test_torch_cuda.py`. Any other device raises."""

import numpy as np
import pytest
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.quantize import (
    dither_threshold,
    dither_threshold_reference,
    dither_thresholds,
    dither_thresholds_reference,
)


def _palette(k, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 100, k), rng.uniform(-60, 60, k),
                     rng.uniform(-60, 60, k)], axis=1).astype(np.float32)


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 40])
def test_cpu_wrapper_runs_the_twin(k, metric):
    pal = _palette(k, 60 + k)
    before = kernels.launches("dither_threshold")
    got = dither_threshold(torch.from_numpy(pal), metric=metric)
    assert kernels.launches("dither_threshold") == before
    want = dither_threshold_reference(torch.from_numpy(pal), metric=metric)
    assert got.shape == () and got.view(torch.int32) == want.view(torch.int32)


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_cpu_frames_wrapper_runs_the_twin(metric):
    pals = torch.from_numpy(np.stack([_palette(12, 70 + f) for f in range(3)]))
    k_actives = [12, 5, 1]
    got = dither_thresholds(pals, k_actives, metric)
    want = dither_thresholds_reference(pals, k_actives, metric)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for f, ka in enumerate(k_actives):
        single = dither_threshold(pals[f], ka, metric)
        assert single.view(torch.int32) == got[f].view(torch.int32)


def test_other_devices_raise():
    pal = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dither_threshold(pal)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dither_thresholds(pal[None])
