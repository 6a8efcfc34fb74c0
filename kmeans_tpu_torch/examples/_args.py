"""Argument handling shared by the examples."""

from __future__ import annotations

import argparse
import os
import sys


def parse(description: str, argv, add=None):
    """Parse `argv` (default `sys.argv[1:]`) with `add(parser)`'s arguments
    and `--cpu`. Returns `(args, device)`; `device` is "cpu" under `--cpu`
    and "cuda" otherwise, and an example never moves to the CPU by
    itself."""
    parser = argparse.ArgumentParser(description=description)
    if add is not None:
        add(parser)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return args, "cpu" if args.cpu else "cuda"


def require_file(path: str) -> bool:
    """True if `path` is a file; else says so on stderr. The examples take
    their input path as an argument and fetch nothing."""
    if os.path.isfile(path):
        return True
    print(f"error: no such file: {path}", file=sys.stderr)
    return False


def input_output(parser, suffix: str) -> None:
    parser.add_argument("input", help="input PNG")
    parser.add_argument("output", nargs="?", default=None,
                        help=f"output path (default: the input's name with {suffix})")


def output_path(args, suffix: str) -> str:
    if args.output:
        return args.output
    return os.path.splitext(os.path.basename(args.input))[0] + suffix
