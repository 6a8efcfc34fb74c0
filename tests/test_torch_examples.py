"""The port's examples (`kmeans_tpu_torch/examples/`) run once each under
`--cpu` on a small generated PNG; no reference call. Each writes what its
original writes: a GIF of one frame per k (at most k colours each), a
sharded PNG, and the serving calls' outputs."""

from __future__ import annotations

import numpy as np
import pytest

import kmeans_tpu_torch as kt
from kmeans_tpu_torch.examples import batched, gif, serving, sharded
from kmeans_tpu_torch.utils.imageio import load_gif, load_image, save_image


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    rng = np.random.default_rng(16)
    base = rng.integers(0, 256, (6, 3))
    idx = rng.integers(0, 6, (3, 4)).repeat(6, 0).repeat(6, 1)
    rgb = np.clip(base[idx] + rng.integers(-9, 10, (18, 24, 3)), 0, 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("examples") / "in.png"
    save_image(kt.Image((24, 18), np.concatenate([rgb, np.full((18, 24, 1), 255, np.uint8)],
                                                 -1)), path)
    return path


@pytest.mark.parametrize("example", ["gif", "batched", "serving", "sharded"])
def test_example_runs_on_the_cpu(example, png, tmp_path, capsys):
    if example in ("gif", "batched"):
        out = tmp_path / "out.gif"
        module = gif if example == "gif" else batched
        assert module.main([str(png), str(out), "--cpu"]) == 0
        frames = load_gif(out)
        assert len(frames) == 14
        for k, frame in zip(range(2, 16), frames):
            assert len(np.unique(frame.pixels.reshape(-1, 4), axis=0)) <= k
        assert module.main([str(tmp_path / "missing.png"), "--cpu"]) == 2
    elif example == "serving":
        assert serving.main(["--cpu", "--requests", "24x18,20x15,22x17"]) == 0
        assert "palette_many: 3 palettes" in capsys.readouterr().out
    else:
        out = tmp_path / "out.png"
        assert sharded.main([str(png), "5", str(out), "--shards", "4", "--cpu"]) == 0
        got = load_image(out).pixels
        assert len(np.unique(got.reshape(-1, 4), axis=0)) <= 5
        assert "reduce_images_sharded: 2 frames on a 2x2 mesh" in capsys.readouterr().out
