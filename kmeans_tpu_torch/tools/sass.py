"""What the compiler made of the port's kernels: `ptxas` resources and SASS loops.

`ptxas_report(source)` compiles one `csrc/*.cu` file with the library's
flags and `-Xptxas -v` and returns, for each kernel instance, its
registers, stack frame and spill bytes. `centroid_loops(library)` reads the
SASS of a built library (`cuobjdump -sass`) and returns, for each kernel
instance, its centroid loop with its instruction counts by opcode: the
smallest loop around the first 16-byte shared load of a centroid
(`LDS.128`). The exact tiers' tiled loop reads one centroid an iteration,
so its length over the tile's pixel count is the instructions one
pixel-centroid pair costs. Both need the CUDA
toolkit (`nvcc`, `cuobjdump`); `chip_smoke.py` prints them on the card's
machine. `kernel_report(source, opcodes)` compiles one source alone and
gives, per kernel instance, its resources, the compiler's warnings, its
opcode counts and the loop around a given opcode; `same_sass(source,
other)` says, per kernel instance, whether two checkouts' copies of a
source compile to the same instructions;

    python -m kmeans_tpu_torch.tools.sass SOURCE ... [--include DIR] [--loop NAME=OPCODE]
    python -m kmeans_tpu_torch.tools.sass SOURCE ... --against OTHER ... [--against-include DIR]

prints either for any checkout's sources.
"""

from __future__ import annotations

import collections
import re
import subprocess
import tempfile
from pathlib import Path

from kmeans_tpu_torch.ops import _build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BACKWARD = re.compile(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")
_PTXAS = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads\n.*?Used (\d+) registers")


def short_name(mangled: str) -> str:
    """`kernel<template args>` of a mangled kernel name, e.g.
    `assign_exact_kernel<0,0>` (a name's length prefixes it; of the
    length-prefixed names that end in `_kernel`, the innermost, since a
    namespace's hash may end in digits too)."""
    found = None
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and len(name) == int(m.group(1)):
            rest = mangled[end + len(name):]
            head = rest[:rest.find("Ev") + 1] if rest.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", head)
            found = name + (f"<{','.join(args)}>" if args else "")
    return found or mangled


def _compile(source: Path, obj: Path, include: Path | None = None) -> str:
    """Compile `source` to `obj` with the library's flags and `-Xptxas -v`;
    return the compiler's output."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(include or _build.CSRC), "-c", "-o", str(obj), str(source)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(cmd)}\n{done.stdout}")
    return done.stdout


def ptxas_rows(output: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel instance in
    `-Xptxas -v` output."""
    return [
        {"kernel": short_name(m.group(1)), "registers": int(m.group(5)),
         "stack_bytes": int(m.group(2)), "spill_store_bytes": int(m.group(3)),
         "spill_load_bytes": int(m.group(4))}
        for m in _PTXAS.finditer(output)
    ]


def ptxas_warnings(output: str) -> list[str]:
    """The compiler's warnings and its notes of a lost overlap: a `wgmma`
    it serialized ("Potential Performance Loss") or a wait it injected."""
    keys = ("warning", "performance loss", "is injected")
    return [line.strip() for line in output.splitlines() if any(k in line.lower() for k in keys)]


def ptxas_report(source: Path) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel instance of
    `source`, compiled with the library's flags and `-Xptxas -v`."""
    with tempfile.TemporaryDirectory() as work:
        return ptxas_rows(_compile(source, Path(work) / "k.o"))


def _functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    out: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = short_name(m.group(1))
            out[current] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            out[current].append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(instruction: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", instruction).split()[0]


def _sass(binary: Path) -> str:
    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(binary)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True, timeout=600).stdout


def centroid_loops(library: Path, pattern: str = "_kernel",
                   require: dict[str, str] | None = None) -> dict[str, dict]:
    """`centroid_loop` of each kernel instance of `library` (`cuobjdump
    -sass`) whose name holds `pattern`; `require` maps a name prefix to
    the opcode prefix its loop must hold."""
    require = require or {}
    return {name: centroid_loop(instructions, next(
                (op for prefix, op in require.items() if name.startswith(prefix)), None))
            for name, instructions in _functions(_sass(library)).items() if pattern in name}


def loop_with(instructions: list[tuple[int, str]], opcode: str) -> dict | None:
    """The smallest loop (a backward branch and its target) that holds, for
    each of the `+`-separated prefixes of `opcode`, an instruction whose
    opcode starts with it (`PREFIX*N`: N of them), with its instruction
    count and its counts by opcode; None without one."""
    wants = [(w.partition("*")[0], int(w.partition("*")[2] or 1)) for w in opcode.split("+")]
    spans = []
    for addr, ins in instructions:
        m = _BACKWARD.search(ins)
        if not (m and m.group(1)):
            continue
        lo = int(m.group(1), 16)
        inside = [_opcode(i) for a, i in instructions if lo <= a <= addr]
        if all(sum(op.startswith(want) for op in inside) >= n for want, n in wants):
            spans.append((lo, addr))
    if not spans:
        return None
    lo, hi = min(spans, key=lambda span: span[1] - span[0])
    ops = collections.Counter(_opcode(ins) for addr, ins in instructions if lo <= addr <= hi)
    return {"start": hex(lo), "instructions": sum(ops.values()), "opcodes": dict(ops.most_common())}


def kernel_report(source: Path, opcodes: dict[str, str],
                  include: Path | None = None) -> list[dict]:
    """For each kernel instance of `source` (compiled alone, with the
    library's flags): its `ptxas` resources, the compiler's warnings, the
    count of every opcode in the whole kernel, and `loop_with` of the
    opcode that `opcodes` maps its name's prefix to (e.g. the round loop
    of the threshold kernel by its `VOTE`, the chunk loop of factor-mxu by
    its `HGMMA`)."""
    with tempfile.TemporaryDirectory() as work:
        obj = Path(work) / "k.o"
        output = _compile(source, obj, include)
        functions = _functions(_sass(obj))
    rows = {row["kernel"]: row for row in ptxas_rows(output)}
    warnings = ptxas_warnings(output)
    out = []
    for name, instructions in functions.items():
        op = next((v for prefix, v in opcodes.items() if name.startswith(prefix)), None)
        out.append({**rows.get(name, {"kernel": name}), "warnings": warnings,
                    "kernel_opcodes": dict(collections.Counter(
                        _opcode(i) for _, i in instructions).most_common()),
                    "loop_opcode": op, "loop": loop_with(instructions, op) if op else None})
    return out


def sass_by_kernel(source: Path, include: Path | None = None) -> dict[str, list[str]]:
    """Each kernel instance of `source` (compiled alone, with the library's
    flags) as its SASS instructions in order, without their addresses."""
    with tempfile.TemporaryDirectory() as work:
        obj = Path(work) / "k.o"
        _compile(source, obj, include)
        return {name: [ins for _, ins in instructions]
                for name, instructions in _functions(_sass(obj)).items()}


def same_sass(source: Path, other: Path, include: Path | None = None,
              other_include: Path | None = None) -> list[dict]:
    """For each kernel instance of `source` or `other` (say, the same file
    of two checkouts; each includes the headers beside it first): whether
    both compile it to the same instructions, and how many each has."""
    mine, theirs = sass_by_kernel(source, include), sass_by_kernel(other, other_include)
    return [{"kernel": name, "same_sass": mine.get(name) == theirs.get(name),
             "instructions": len(mine.get(name, [])),
             "other_instructions": len(theirs.get(name, []))}
            for name in sorted(set(mine) | set(theirs))]


def main(argv=None) -> int:
    """`python -m kmeans_tpu_torch.tools.sass SOURCE [SOURCE ...] [--include
    DIR] [--loop PREFIX=OPCODE ...] [--against OTHER ...]`: one JSON line of
    `kernel_report` per kernel instance of each source; with `--against`
    (one OTHER a SOURCE), one line of `same_sass` per instance instead."""
    import argparse
    import json

    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+", type=Path)
    parser.add_argument("--include", type=Path, default=None)
    parser.add_argument("--loop", action="append", default=[],
                        help="kernel name prefix=opcode prefix of its loop")
    parser.add_argument("--against", action="append", default=[], type=Path,
                        help="the same source in another checkout, to compare SASS with")
    parser.add_argument("--against-include", type=Path, default=None,
                        help="the other checkout's csrc, for sources outside it")
    args = parser.parse_args(argv)
    if args.against:
        if len(args.against) != len(args.sources):
            parser.error("give one --against for each source")
        for source, other in zip(args.sources, args.against):
            for row in same_sass(source, other, args.include, args.against_include):
                print(json.dumps({"source": str(source), "against": str(other), **row}),
                      flush=True)
        return 0
    opcodes = dict(item.split("=", 1) for item in args.loop)
    for source in args.sources:
        for row in kernel_report(source, opcodes, args.include):
            print(json.dumps({"source": str(source), **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


def centroid_loop(instructions: list[tuple[int, str]], require: str | None = None) -> dict | None:
    """The smallest loop (a backward branch and its target) around the
    kernel's first 16-byte shared load (`LDS.128`, a staged centroid), with
    its instruction count and its counts by opcode; None without one. With
    `require`, the smallest loop that holds an `LDS.128` and an opcode
    starting with `require` (the pruned screen's loop: its warp vote)."""
    loads = [addr for addr, ins in instructions if _opcode(ins) == "LDS.128"]
    if not loads:
        return None
    spans = []
    for addr, ins in instructions:
        m = _BACKWARD.search(ins)
        if not (m and m.group(1)):
            continue
        lo = int(m.group(1), 16)
        if require is None:
            if lo <= loads[0] < addr:
                spans.append((lo, addr))
        elif any(lo <= a <= addr for a in loads) and any(
                lo <= a <= addr and _opcode(i).startswith(require) for a, i in instructions):
            spans.append((lo, addr))
    if not spans:
        return None
    lo, hi = min(spans, key=lambda span: span[1] - span[0])
    ops = collections.Counter(_opcode(ins) for addr, ins in instructions if lo <= addr <= hi)
    return {"start": hex(lo), "instructions": sum(ops.values()),
            "lds128": ops.get("LDS.128", 0), "opcodes": dict(ops.most_common())}
