"""Command-line interface of the port: `palette`, `find`, `reduce` and the
GIF subcommands.

Port of `kmeans_tpu/cli.py` (itself a parity port of redwarp/kmeans-gpu's
CLI): the same subcommands, flags, defaults, validators, output-file
names, swatch and hex palette printing, run by `ImageProcessor` on the
CUDA card (`main(argv, device=None)`). Tests and library callers pass
`device="cpu"` to `main` for the plain PyTorch path; no flag or
environment variable moves the command line off the card.

    python -m kmeans_tpu_torch palette -i img.png -c 8 [-a kmeans|octree|mediancut|wu] [-s 40]
    python -m kmeans_tpu_torch find    -i img.png -p '#RRGGBB,#RRGGBB'|palette.png [-m replace|dither|meld]
    python -m kmeans_tpu_torch reduce  -i img.png -c 8 [-a ...] [-m ...] [-o out.png]

`--band-rows N` streams `reduce`, `palette` and `find` through the card
in bands of N rows (`ImageProcessor.reduce_streamed`, `palette_streamed`,
`find_streamed`), so device memory holds one band, not the image.
`--pipeline` is `ImageProcessor(pipeline=True)`: `palette` trains on a
host-shrunk strip, and `reduce` of an image of 2048 rows or more goes
through the card in bands of 512 rows. The reference's compile cache is
not ported (ROADMAP A.13): the port compiles nothing per shape. Decoding
and encoding run under the phases `decode` and `encode` of
`utils/profiling.py`.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys
import time

import numpy as np

from kmeans_tpu_torch.api import Algorithm, ImageProcessor, ReduceMode
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils.imageio import load_image, save_image
from kmeans_tpu_torch.utils.profiling import phase

log = logging.getLogger("kmeans_tpu_torch")

_HEX_PALETTE_RE = re.compile(r"^#[0-9a-fA-F]{6}(?:,#[0-9a-fA-F]{6})*$")
MAX_PALETTE_PIXELS = 512  # cli/src/args.rs:199-203


def validate_k(value: str) -> int:
    """k must be an integer >= 1 (`cli/src/args.rs:160-171`)."""
    try:
        k = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError("k must be an integer higher than 0.")
    if k < 1:
        raise argparse.ArgumentTypeError("k must be an integer higher than 0.")
    return k


def validate_filename(value: str) -> str:
    """Only .png / .jpg, with a non-empty stem (`cli/src/args.rs:173-179`)."""
    if len(value) > 4 and (value.endswith(".png") or value.endswith(".jpg")):
        return value
    raise argparse.ArgumentTypeError("Only support png or jpg files.")


def validate_band_rows(value: str) -> int:
    # The reference's streamed API clamps band_rows to >= 4; reject smaller
    # values here instead of silently ignoring the user's choice.
    n = int(value)
    if n < 4:
        raise argparse.ArgumentTypeError("band-rows must be >= 4")
    return n


def validate_train_max_size(value: str):
    # "none" lifts the training shrink entirely (full-resolution training,
    # through the accumulator kernel at k <= 512; redwarp/kmeans-gpu
    # hard-codes 256, core/src/structures.rs:23).
    if value.lower() in ("none", "full"):
        return None
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(
            "train-max-size must be >= 1 or 'none'"
        )
    return n


def validate_size(value: str) -> int:
    s = int(value)
    if not 1 <= s <= 60:
        raise argparse.ArgumentTypeError("size must be between 1 and 60")
    return s


def parse_colors(spec: str) -> np.ndarray:
    """'#RRGGBB,#RRGGBB' -> [k, 4] RGBA8 (`cli/src/args.rs:233-247`)."""
    colors = []
    for part in spec.split(","):
        colors.append(
            (int(part[1:3], 16), int(part[3:5], 16), int(part[5:7], 16), 255)
        )
    return np.asarray(colors, dtype=np.uint8)


def parse_palette_image(path: str) -> np.ndarray:
    """Load a palette from an image file: <= 512 pixels, all distinct;
    colors are sorted and deduped (`cli/src/args.rs:197-231`)."""
    image = load_image(path)
    w, h = image.dimensions
    pixel_count = w * h
    if pixel_count > MAX_PALETTE_PIXELS:
        raise argparse.ArgumentTypeError(
            "Trying to load a palette with more than 512 colors"
        )
    colors = image.pixels.reshape(-1, 4)
    uniq = np.unique(colors, axis=0)  # sorted lexicographically, like Vec::sort
    if len(uniq) < pixel_count:
        raise argparse.ArgumentTypeError(
            "Trying to load a palette with recuring colors"
        )
    return uniq


def validate_palette(value: str) -> np.ndarray:
    """Hex list or palette-image path (`cli/src/args.rs:181-195`)."""
    if _HEX_PALETTE_RE.match(value):
        return parse_colors(value)
    if (
        len(value) > 4
        and (value.endswith(".png") or value.endswith(".jpg"))
        and os.path.exists(value)
    ):
        return parse_palette_image(value)
    raise argparse.ArgumentTypeError(
        'The palette should be a path to an image file, or defined as '
        '"#RRGGBB,#RRGGBB,#RRGGBB"'
    )


# ---------------------------------------------------------------------- #
# Output path conventions (cli/src/main.rs:127-219)
# ---------------------------------------------------------------------- #


def reduce_file_path(k: int, algo: str, mode: str, output, input_path: str) -> str:
    if output:
        return output
    parent = os.path.dirname(input_path)
    stem = os.path.splitext(os.path.basename(input_path))[0]
    return os.path.join(parent, f"{stem}-reduce-c{k}-{algo}-{mode}.png")


def palette_file_path(k: int, input_path: str, output, algo: str, size: int) -> str:
    if output:
        return output
    parent = os.path.dirname(input_path)
    stem = os.path.splitext(os.path.basename(input_path))[0]
    return os.path.join(parent, f"{stem}-palette-c{k}-{algo}-s{size}.png")


def find_file_path(mode: str, output, input_path: str) -> str:
    if output:
        return output
    parent = os.path.dirname(input_path)
    stem, ext = os.path.splitext(os.path.basename(input_path))
    millis = int(time.time() * 1000)
    return os.path.join(parent, f"{stem}-find-{mode}-{millis}{ext}")


def render_swatch(palette: np.ndarray, size: int) -> np.ndarray:
    """k*size x size swatch image (`cli/src/main.rs:221-239`)."""
    k = palette.shape[0]
    row = np.repeat(palette[None, :, :], size, axis=0)  # [size, k, 4]
    return np.repeat(row, size, axis=1).astype(np.uint8)  # [size, k*size, 4]


def palette_hex(palette: np.ndarray) -> str:
    return ",".join(f"#{r:02X}{g:02X}{b:02X}" for r, g, b, _ in palette)


# ---------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kmeans-tpu-torch",
        description="k-means image color quantization on a CUDA card (PyTorch port)",
    )
    # Shape bucketing: pads inputs to the {4,5,6,7}*2^k ladder, the
    # serving mode (the port compiles nothing per shape).
    parser.add_argument(
        "--bucketing",
        action="store_true",
        help="pad inputs to shape buckets, the serving mode (same outputs "
        "as without it)",
    )
    parser.add_argument(
        "--fast",
        action="store_true",
        help="fast kernel tiers for 16 < k <= 512 (factorized CIE94, pruned "
        "CIEDE2000); not bit-equal to the exact path: near-ties may pick "
        "an adjacent palette color",
    )
    parser.add_argument(
        "--delta-e",
        choices=["94", "2000"],
        default="94",
        help="color-difference metric: CIE94 (reference parity, default) "
        "or CIEDE2000 (perceptually more uniform)",
    )
    parser.add_argument(
        "--restarts",
        type=validate_k,
        default=1,
        help="train N independent k-means++ seedings and keep the "
        "lowest-inertia palette; 1 = the reference's single deterministic "
        "seed",
    )
    parser.add_argument(
        "--pipeline",
        action="store_true",
        help="transfer-pipelined paths: palette trains on a host-shrunk "
        "strip (uploads ~0.1 MB instead of the whole image; with "
        "--bucketing the strip pads to its own small bucket), reduce "
        "streams row bands so readbacks overlap uploads; the host shrink "
        "can round isolated strip pixels one u8 step differently from "
        "the device sampler",
    )
    parser.add_argument(
        "--train-max-size",
        type=validate_train_max_size,
        default=256,
        help="long-side cap for the k-means training shrink (the "
        "reference hard-codes 256); 'none' trains on every "
        "full-resolution pixel (through the accumulator kernel at k<=512)",
    )
    parser.add_argument(
        "--train-dtype",
        choices=["float32", "bfloat16"],
        default=None,
        help="storage dtype for the full-resolution training planes: "
        "bfloat16 halves their memory traffic for a ~0.3 delta-E input "
        "quantization (opt-in; rejected with --bucketing)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    palette = sub.add_parser(
        "palette", help="Quantized the image then output the reduced palette."
    )
    palette.add_argument("-c", "--colorcount", type=validate_k, required=True)
    palette.add_argument("-i", "--input", type=validate_filename, required=True)
    palette.add_argument("-o", "--output")
    palette.add_argument(
        "-a", "--algo", choices=["kmeans", "octree", "mediancut", "wu"], default="kmeans"
    )
    palette.add_argument("-s", "--size", type=validate_size, default=40)
    palette.add_argument(
        "--band-rows",
        type=validate_band_rows,
        default=None,
        help="train on the image streamed in row bands of this many rows "
        "(gigapixel images; kmeans algorithm only)",
    )

    find = sub.add_parser(
        "find",
        help="Find colors in image that are closest to the replacements, and swap them.",
    )
    find.add_argument("-i", "--input", type=validate_filename, required=True)
    find.add_argument("-o", "--output")
    find.add_argument("-p", "--palette", type=validate_palette, required=True)
    find.add_argument(
        "-m", "--mode", choices=["replace", "dither", "meld"], default="replace"
    )
    find.add_argument(
        "--band-rows",
        type=validate_band_rows,
        default=None,
        help="process the image in row bands of this many rows "
        "(gigapixel images: device memory holds one band at a time)",
    )

    reduce = sub.add_parser(
        "reduce", help="Quantized the image then replaces it's resulting color."
    )
    reduce.add_argument("-c", "--colorcount", type=validate_k, required=True)
    reduce.add_argument("-i", "--input", type=validate_filename, required=True)
    reduce.add_argument("-o", "--output")
    reduce.add_argument(
        "-a", "--algo", choices=["kmeans", "octree", "mediancut", "wu"], default="kmeans"
    )
    reduce.add_argument(
        "-m", "--mode", choices=["replace", "dither", "meld"], default="replace"
    )
    reduce.add_argument(
        "--band-rows",
        type=validate_band_rows,
        default=None,
        help="process the image in row bands of this many rows "
        "(gigapixel images: device memory holds one band at a time; "
        "kmeans algorithm only)",
    )

    # Batched GIF pipelines beyond redwarp's CLI (all frames in one frames
    # launch); they need the native GIF codec.
    rgif = sub.add_parser(
        "reduce-gif", help="Quantize every frame of an animated GIF (batched)."
    )
    rgif.add_argument("-c", "--colorcount", type=validate_k, required=True)
    rgif.add_argument("-i", "--input", required=True)
    rgif.add_argument("-o", "--output")
    rgif.add_argument(
        "-m", "--mode", choices=["replace", "dither", "meld"], default="replace"
    )
    rgif.add_argument(
        "--palette-mode",
        choices=["frame", "global"],
        default="frame",
        help="frame: each frame trains its own palette (default); "
        "global: one palette trained jointly over all frames "
        "(consistent colors, no cross-frame flicker)",
    )

    fgif = sub.add_parser(
        "find-gif", help="Recolor every frame of an animated GIF with a fixed palette."
    )
    fgif.add_argument("-i", "--input", required=True)
    fgif.add_argument("-o", "--output")
    fgif.add_argument("-p", "--palette", type=validate_palette, required=True)
    fgif.add_argument(
        "-m", "--mode", choices=["replace", "dither", "meld"], default="replace"
    )

    return parser


def main(argv=None, device=None) -> int:
    """Run one subcommand (kmeans_tpu/cli.py:324). `device=None` runs on
    the CUDA card and raises without one, as `ImageProcessor` does;
    `device="cpu"` runs the plain PyTorch path."""
    logging.basicConfig(
        level=os.environ.get("KMEANS_TPU_LOG", "WARNING").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    try:
        processor = ImageProcessor(
            device=device, bucketing=args.bucketing, fast=args.fast, delta_e=args.delta_e,
            restarts=args.restarts, pipeline=args.pipeline,
            train_max_size=args.train_max_size, train_dtype=args.train_dtype,
        )
    except ValueError as exc:
        # e.g. --train-dtype with --bucketing: surface the API's rejection
        # as a clean CLI error, not a traceback
        raise SystemExit(str(exc)) from exc

    _run(args, processor)
    return 0


def _load(path: str) -> Image:
    with phase("decode"):
        return load_image(path)


def _save(image: Image, path: str) -> None:
    with phase("encode"):
        save_image(image, path)


def _run(args, processor: ImageProcessor) -> None:
    """The subcommand's body (kmeans_tpu/cli.py:346-434)."""
    if args.command == "palette":
        image = _load(args.input)
        if args.band_rows:
            if args.algo != "kmeans":
                raise SystemExit("--band-rows requires the kmeans algorithm")
            palette = processor.palette_streamed(
                args.colorcount, image, band_rows=args.band_rows
            )
        else:
            palette = processor.palette(
                args.colorcount, image, Algorithm(args.algo)
            )
        out_path = palette_file_path(
            args.colorcount, args.input, args.output, args.algo, args.size
        )
        swatch = render_swatch(palette, args.size)
        _save(Image((swatch.shape[1], swatch.shape[0]), swatch), out_path)
        print(f"Palette: {palette_hex(palette)}")
    elif args.command == "find":
        image = _load(args.input)
        if args.band_rows:
            result = processor.find_streamed(
                image, args.palette, ReduceMode(args.mode),
                band_rows=args.band_rows,
            )
        else:
            result = processor.find(image, args.palette, ReduceMode(args.mode))
        _save(result, find_file_path(args.mode, args.output, args.input))
    elif args.command == "reduce":
        image = _load(args.input)
        if args.band_rows:
            if args.algo != "kmeans":
                raise SystemExit("--band-rows requires the kmeans algorithm")
            result = processor.reduce_streamed(
                args.colorcount, image, ReduceMode(args.mode),
                band_rows=args.band_rows,
            )
        else:
            result = processor.reduce(
                args.colorcount, image, Algorithm(args.algo), ReduceMode(args.mode)
            )
        _save(
            result,
            reduce_file_path(
                args.colorcount, args.algo, args.mode, args.output, args.input
            ),
        )
    elif args.command == "reduce-gif":
        from kmeans_tpu_torch.utils.imageio import load_gif, save_gif

        if args.mode == "meld":
            raise SystemExit(
                "reduce-gif does not support meld: melded frames blend "
                "colors continuously and cannot be GIF-encoded (<=256 colors)"
            )
        if args.colorcount > 256:
            raise SystemExit("reduce-gif requires a color count <= 256")
        frames, delays = load_gif(args.input, with_delays=True)
        if args.palette_mode == "global":
            palette = processor.palette_images(frames, args.colorcount)
            outs = processor.find_batch(frames, palette, ReduceMode(args.mode))
        else:
            outs = processor.reduce_images(
                frames, args.colorcount, ReduceMode(args.mode)
            )
        out_path = args.output or _gif_out_path(
            args.input, f"reduce-c{args.colorcount}-{args.mode}"
        )
        save_gif(outs, out_path, delays=delays)
    elif args.command == "find-gif":
        from kmeans_tpu_torch.utils.imageio import load_gif, save_gif

        if args.mode == "meld":
            raise SystemExit(
                "find-gif does not support meld: melded frames blend colors "
                "continuously and cannot be GIF-encoded (<=256 colors)"
            )
        if len(args.palette) > 256:
            raise SystemExit("find-gif requires a palette of <= 256 colors")
        frames, delays = load_gif(args.input, with_delays=True)
        outs = processor.find_batch(frames, args.palette, ReduceMode(args.mode))
        out_path = args.output or _gif_out_path(args.input, f"find-{args.mode}")
        save_gif(outs, out_path, delays=delays)


def _gif_out_path(input_path: str, tag: str) -> str:
    parent = os.path.dirname(input_path)
    stem = os.path.splitext(os.path.basename(input_path))[0]
    return os.path.join(parent, f"{stem}-{tag}.gif")


if __name__ == "__main__":
    sys.exit(main())
