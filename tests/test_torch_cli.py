"""PyTorch port vs the JAX package: the command line.

The cases of the reference's `tests/test_cli.py` against
`kmeans_tpu_torch.cli`: the validators, output naming, swatch and hex
printing give the reference's results, and every subcommand run through
`cli.main(argv, device="cpu")` writes the same PNG bytes (and prints the
same palette) as `kmeans_tpu.cli.main(argv)` on the JAX CPU backend
(meld, which the reference's tests do not run: the same pixels but for 1
u8 step on at most 1e-3 of them). The reference runs with its native
runtime built for these tests and injected (`_torch_reference_runtime.py`),
so both write palette PNGs through libpng. A JPEG input and the GIF
subcommands (`reduce-gif` in both palette modes, `find-gif`) give the same
files in both CLIs; meld and k > 256 GIFs exit in both. `--band-rows` streams `reduce`, `palette` and `find` in row bands, with
the reference's bytes, and so does `--pipeline` (ROADMAP A.13) write
them; a `--band-rows` below 4, or beside a host algorithm, exits as in the
reference. `python -m kmeans_tpu_torch` is this CLI, and on a host
without CUDA it refuses to run rather than fall back to the CPU, as
`validate_kernels` does.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_reference_runtime import ref_runtime  # noqa: F401 (fixture)
from kmeans_tpu import cli as ref_cli
from kmeans_tpu.utils import imageio as ref_imageio
from kmeans_tpu_torch import cli
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils import imageio
from kmeans_tpu_torch.utils.imageio import load_image, save_image

torch.set_num_threads(2)

pytestmark = pytest.mark.usefixtures("ref_runtime")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_validators_match_reference():
    for value in ("1", "150"):
        assert cli.validate_k(value) == ref_cli.validate_k(value)
    for value in ("jog.png", "jog.jpg"):
        assert cli.validate_filename(value) == value
    for value in ("256", "none", "FULL"):
        assert cli.validate_train_max_size(value) == ref_cli.validate_train_max_size(value)
    assert cli.validate_band_rows("16") == ref_cli.validate_band_rows("16") == 16
    assert cli.validate_size("60") == 60
    bad = [(cli.validate_k, ref_cli.validate_k, ("abs", "0", "-3")),
           (cli.validate_filename, ref_cli.validate_filename, ("jog.pom", ".png")),
           (cli.validate_train_max_size, ref_cli.validate_train_max_size, ("0", "-1", "abc")),
           (cli.validate_band_rows, ref_cli.validate_band_rows, ("2", "x")),
           (cli.validate_size, ref_cli.validate_size, ("0", "61")),
           (cli.validate_palette, ref_cli.validate_palette, ("#ffffff#000000", ""))]
    for port, ref, values in bad:
        for value in values:
            for fn in (port, ref):
                with pytest.raises((argparse.ArgumentTypeError, ValueError)):
                    fn(value)


def test_colours_naming_swatch_and_hex_match_reference():
    for spec in ("#ffffff,#000000", "#ff0000,#00ff00"):
        np.testing.assert_array_equal(cli.validate_palette(spec), ref_cli.validate_palette(spec))
        np.testing.assert_array_equal(cli.parse_colors(spec), ref_cli.parse_colors(spec))
    for args in ((8, "kmeans", "replace", None, "/a/tokyo.png"),
                 (8, "kmeans", "replace", "/x/y.png", "/a/t.png")):
        assert cli.reduce_file_path(*args) == ref_cli.reduce_file_path(*args)
    assert (cli.palette_file_path(8, "/a/tokyo.png", None, "wu", 40)
            == ref_cli.palette_file_path(8, "/a/tokyo.png", None, "wu", 40)
            == "/a/tokyo-palette-c8-wu-s40.png")
    found = cli.find_file_path("dither", None, "/a/tokyo.jpg")
    assert found.startswith("/a/tokyo-find-dither-") and found.endswith(".jpg")
    assert cli._gif_out_path("/a/anim.gif", "find-replace") == "/a/anim-find-replace.gif"
    pal = np.array([[255, 171, 205, 255], [4, 5, 6, 255]], np.uint8)
    np.testing.assert_array_equal(cli.render_swatch(pal, 40), ref_cli.render_swatch(pal, 40))
    assert cli.render_swatch(pal, 40).shape == (40, 80, 4)
    assert cli.palette_hex(pal) == ref_cli.palette_hex(pal) == "#FFABCD,#040506"


def test_palette_images_match_reference(tmp_path):
    rgba = np.zeros((8, 8, 4), np.uint8)
    rgba[..., 0] = np.arange(64).reshape(8, 8) * 4
    rgba[..., 1] = np.arange(64).reshape(8, 8)
    rgba[..., 3] = 255
    p = str(tmp_path / "pal.png")
    save_image(Image((8, 8), rgba), p)
    np.testing.assert_array_equal(cli.parse_palette_image(p), ref_cli.parse_palette_image(p))
    assert cli.validate_palette(p).shape == (64, 4)
    dup = str(tmp_path / "dup.png")
    save_image(Image((2, 2), np.full((2, 2, 4), 255, np.uint8)), dup)
    for fn in (cli.parse_palette_image, ref_cli.parse_palette_image):
        with pytest.raises(argparse.ArgumentTypeError, match="recuring"):
            fn(dup)


@pytest.fixture(scope="module")
def sample_png(tmp_path_factory):
    """The reference test's 64x64 three-blob sample."""
    rng = np.random.default_rng(9)
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230]], np.int32)
    idx = rng.integers(0, 3, size=(64, 64))
    rgb = np.clip(base[idx] + rng.integers(-10, 11, (64, 64, 3)), 0, 255)
    rgba = np.concatenate([rgb.astype(np.uint8), np.full((64, 64, 1), 255, np.uint8)], -1)
    path = tmp_path_factory.mktemp("gfx") / "sample.png"
    save_image(Image((64, 64), rgba), str(path))
    return str(path)


def _both(argv, tmp_path, capsys):
    """Run `argv` (with `{out}` for the output path) through both CLIs;
    returns `(port bytes, reference bytes, port stdout, reference stdout)`."""
    outs = []
    for name, run in (("port", lambda a: cli.main(a, device="cpu")), ("ref", ref_cli.main)):
        out = str(tmp_path / f"{name}.png")
        assert run([a.replace("{out}", out) for a in argv]) == 0
        with open(out, "rb") as f:
            outs.append((f.read(), capsys.readouterr().out))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


# The end-to-end cases of tests/test_cli.py, one argv each.
CASES = {
    "reduce": ["reduce", "-c", "3"],
    "reduce_full_res": ["--train-max-size", "none", "reduce", "-c", "3"],
    "reduce_full_res_bf16": ["--train-dtype", "bfloat16", "--train-max-size", "none",
                             "reduce", "-c", "3"],
    "palette": ["palette", "-c", "3", "-s", "10"],
    "find": ["find", "-p", "#ff0000,#00ff00,#0000ff"],
    "octree_dither": ["reduce", "-c", "3", "-a", "octree", "-m", "dither"],
    "mediancut": ["reduce", "-c", "3", "-a", "mediancut"],
    "wu": ["reduce", "-c", "3", "-a", "wu"],
    "wu_palette": ["palette", "-c", "3", "-a", "wu", "-s", "4"],
    "meld": ["reduce", "-c", "3", "-m", "meld"],
    "bucketing": ["--bucketing", "reduce", "-c", "3"],
    "delta_e_2000": ["--delta-e", "2000", "reduce", "-c", "3"],
    "fast": ["--fast", "reduce", "-c", "3"],
    "band_rows_reduce": ["reduce", "-c", "3", "--band-rows", "16"],
    "band_rows_dither": ["reduce", "-c", "3", "-m", "dither", "--band-rows", "9"],
    "band_rows_palette": ["palette", "-c", "3", "--band-rows", "8", "-s", "10"],
    "band_rows_find": ["find", "-p", "#ff0000,#00ff00,#0000ff", "-m", "dither",
                       "--band-rows", "4"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_writes_reference_bytes(case, sample_png, tmp_path, capsys):
    argv = CASES[case]
    i = next(i for i, a in enumerate(argv) if a in ("reduce", "palette", "find"))
    argv = argv[:i + 1] + ["-i", sample_png, "-o", "{out}"] + argv[i + 1:]
    got, want, got_out, want_out = _both(argv, tmp_path, capsys)
    img = load_image(str(tmp_path / "port.png"))
    if "meld" in argv:
        # Meld blends the two closest colours in float32: the packages may
        # round a blend 1 u8 step apart (PERF.md's known class).
        step = np.abs(img.pixels.astype(np.int64)
                      - load_image(str(tmp_path / "ref.png")).pixels).max(-1)
        assert step.max() <= 1 and (step > 0).sum() <= step.size // 1000
    else:
        assert got == want
    assert got_out == want_out
    if argv[i] == "palette":
        assert got_out.startswith("Palette: #") and got_out.count("#") == 3
        assert img.dimensions[1] == int(argv[-1])
    else:
        assert img.dimensions == (64, 64)
        if "meld" not in argv:
            assert len(np.unique(img.pixels.reshape(-1, 4), axis=0)) <= 3


def test_default_output_names(sample_png, capsys):
    """Without `-o` both CLIs write beside the input under the reference's
    names, the same bytes."""
    for argv, name in ((["reduce", "-i", sample_png, "-c", "3", "-a", "wu"],
                        "sample-reduce-c3-wu-replace.png"),
                       (["palette", "-i", sample_png, "-c", "3", "-s", "10"],
                        "sample-palette-c3-kmeans-s10.png")):
        path = os.path.join(os.path.dirname(sample_png), name)
        assert ref_cli.main(argv) == 0
        with open(path, "rb") as f:
            want = f.read()
        os.remove(path)
        assert cli.main(argv, device="cpu") == 0
        with open(path, "rb") as f:
            assert f.read() == want
    capsys.readouterr()


def test_palette_swatch_roundtrip_through_find(sample_png, tmp_path, capsys):
    swatch = str(tmp_path / "swatch.png")
    assert cli.main(["palette", "-i", sample_png, "-c", "3", "-s", "1", "-o", swatch],
                    device="cpu") == 0
    capsys.readouterr()
    got, want, _, _ = _both(["find", "-i", sample_png, "-p", swatch, "-o", "{out}"],
                            tmp_path, capsys)
    assert got == want
    out_colors = set(map(tuple, load_image(str(tmp_path / "port.png")).pixels.reshape(-1, 4)))
    assert out_colors <= set(map(tuple, load_image(swatch).pixels.reshape(-1, 4)))


def test_refusals(sample_png, tmp_path, capsys):
    out = str(tmp_path / "x.png")
    base = ["reduce", "-i", sample_png, "-c", "3", "-o", out]
    # --pipeline runs (ROADMAP A.13, ported): the reference CLI's bytes and
    # printed palette (tests/test_cli.py::test_cli_pipeline_flag), the
    # palette also past a training cap of 32 px, where the host strip trains.
    got, want, _, _ = _both(["--pipeline", "reduce", "-i", sample_png, "-c", "3", "-o", "{out}"],
                            tmp_path, capsys)
    assert got == want
    got, want, got_out, want_out = _both(
        ["--pipeline", "--train-max-size", "32", "palette", "-i", sample_png, "-c", "3", "-s",
         "4", "-o", "{out}"], tmp_path, capsys)
    assert got == want and got_out == want_out and got_out.startswith("Palette")
    for argv in (base + ["--band-rows", "16", "-a", "octree"],
                 ["palette", "-i", sample_png, "-c", "3", "--band-rows", "16", "-a", "wu"]):
        for run in (lambda a: cli.main(a, device="cpu"), ref_cli.main):
            with pytest.raises(SystemExit, match="requires the kmeans algorithm"):
                run(argv)
    for run in (lambda a: cli.main(a, device="cpu"), ref_cli.main):
        with pytest.raises(SystemExit) as exc:
            run(base + ["--band-rows", "2"])
        assert exc.value.code == 2
        with pytest.raises(SystemExit, match="bucketing"):
            run(["--train-dtype", "bfloat16", "--bucketing"] + base)
    assert not os.path.exists(out)


@pytest.mark.parametrize("which", ["port", "reference"])
def test_cli_band_rows(which, sample_png, tmp_path):
    """tests/test_cli.py::test_cli_band_rows against each CLI: a streamed
    reduce keeps the size and k colours; `--band-rows` beside a host
    algorithm, or below 4 (the API would clamp it), exits."""
    run = (lambda a: cli.main(a, device="cpu")) if which == "port" else ref_cli.main
    out = str(tmp_path / "br.png")
    assert run(["reduce", "-i", sample_png, "-c", "3", "--band-rows", "16", "-o", out]) == 0
    img = load_image(out)
    assert img.dimensions == load_image(sample_png).dimensions
    assert len(np.unique(img.pixels.reshape(-1, 4), axis=0)) <= 3
    with pytest.raises(SystemExit):
        run(["reduce", "-i", sample_png, "-c", "3", "--band-rows", "16", "-a", "octree",
             "-o", out])
    with pytest.raises(SystemExit):
        run(["reduce", "-i", sample_png, "-c", "3", "--band-rows", "2", "-o", out])


def _run_both(argv_of):
    """Run `argv_of(name)` through the port's CLI and the reference's."""
    assert cli.main(argv_of("port"), device="cpu") == 0
    assert ref_cli.main(argv_of("ref")) == 0


def test_cli_jpg_end_to_end(sample_png, tmp_path):
    """tests/test_cli.py::test_cli_jpg_end_to_end on both CLIs: the sample
    saved as a JPEG reduces to the same PNG bytes, and `find` writes a JPEG
    output (its name keeps the input's extension) with the same bytes."""
    img = load_image(sample_png)
    jpg = str(tmp_path / "sample.jpg")
    save_image(img, jpg)
    with open(jpg, "rb") as f:
        jpeg = f.read()
    ref_jpg = str(tmp_path / "ref.jpg")
    ref_imageio.save_image(img, ref_jpg)
    with open(ref_jpg, "rb") as f:
        assert f.read() == jpeg
    _run_both(lambda who: ["reduce", "-i", jpg, "-c", "3", "-o", str(tmp_path / f"{who}.png")])
    _run_both(lambda who: ["find", "-i", jpg, "-p", "#ff0000,#00ff00,#0000ff",
                           "-o", str(tmp_path / f"{who}-find.jpg")])
    for name in ("{}.png", "{}-find.jpg"):
        with open(tmp_path / name.format("port"), "rb") as a, \
                open(tmp_path / name.format("ref"), "rb") as b:
            assert a.read() == b.read()
    assert load_image(str(tmp_path / "port.png")).dimensions == img.dimensions


@pytest.fixture(scope="module")
def anim_gif(tmp_path_factory):
    """tests/test_cli.py::test_cli_gif_subcommands's 3-frame 16x16 GIF, with
    per-frame delays."""
    rng = np.random.default_rng(12)
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230]], np.int32)
    frames = []
    for _ in range(3):
        idx = rng.integers(0, 3, size=(16, 16))
        rgb = np.clip(base[idx] + rng.integers(-9, 10, (16, 16, 3)), 0, 255)
        rgba = np.concatenate([rgb.astype(np.uint8), np.full((16, 16, 1), 255, np.uint8)], -1)
        frames.append(Image((16, 16), rgba))
    src = str(tmp_path_factory.mktemp("gif") / "anim.gif")
    imageio.save_gif(frames, src, delays=[5, 10, 15])
    return src


@pytest.mark.parametrize("argv,count", [
    (["reduce-gif", "-c", "2"], 2),
    (["reduce-gif", "-c", "3", "--palette-mode", "global"], 3),
    (["reduce-gif", "-c", "3", "-m", "dither"], 3),
    (["find-gif", "-p", "#ff0000,#00ff00"], 2),
])
def test_cli_gif_subcommands(argv, count, anim_gif, tmp_path):
    """tests/test_cli.py::test_cli_gif_subcommands (and the global palette
    mode of `::test_cli_reduce_gif_global_palette`) on both CLIs: the same
    GIF bytes, 3 frames of at most `count` colours, the delays kept."""
    _run_both(lambda who: argv[:1] + ["-i", anim_gif, "-o", str(tmp_path / f"{who}.gif")]
              + argv[1:])
    with open(tmp_path / "port.gif", "rb") as a, open(tmp_path / "ref.gif", "rb") as b:
        assert a.read() == b.read()
    frames, delays = imageio.load_gif(str(tmp_path / "port.gif"), with_delays=True)
    assert len(frames) == 3 and delays == [5, 10, 15]
    for f in frames:
        assert len(np.unique(f.pixels.reshape(-1, 4), axis=0)) <= count


def test_cli_gif_default_output_name(anim_gif):
    """Without `-o` the GIF subcommands write beside the input under the
    reference's name."""
    out = anim_gif.replace("anim.gif", "anim-find-replace.gif")
    assert cli.main(["find-gif", "-i", anim_gif, "-p", "#ff0000,#00ff00"], device="cpu") == 0
    assert len(imageio.load_gif(out)) == 3
    os.remove(out)


def test_gif_refusals_as_reference(anim_gif):
    """Meld GIFs and more than 256 colours exit in both CLIs."""
    for argv in (["reduce-gif", "-i", anim_gif, "-c", "2", "-m", "meld"],
                 ["reduce-gif", "-i", anim_gif, "-c", "300"],
                 ["find-gif", "-i", anim_gif, "-p", "#ff0000", "-m", "meld"]):
        for run in (lambda a: cli.main(a, device="cpu"), ref_cli.main):
            with pytest.raises(SystemExit):
                run(argv)


def test_python_m_runs_the_cli(sample_png):
    """`python -m kmeans_tpu_torch` is this CLI (a fresh interpreter without
    JAX); without a card a run refuses, naming `device='cpu'`."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-m", "kmeans_tpu_torch", "--help"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("usage: kmeans-tpu-torch")
    for sub in ("palette", "find", "reduce", "reduce-gif", "find-gif"):
        assert sub in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "kmeans_tpu_torch", "reduce", "-i", sample_png,
                        "-c", "3", "-o", os.devnull + ".png"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


def test_no_card_refusals(sample_png):
    """Without CUDA, `main` with no device and `validate_kernels` raise:
    neither falls back to the CPU (where a wrapper would run its twin)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py runs these on it")
    from kmeans_tpu_torch.ops.validate import validate_kernels

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["reduce", "-i", sample_png, "-c", "3"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        validate_kernels()
