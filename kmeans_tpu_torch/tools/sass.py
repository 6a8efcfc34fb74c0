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
machine.
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
    `assign_exact_kernel<0,0>` (a name's length prefixes it)."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel"):
            rest = mangled[end + len(name):]
            head = rest[:rest.find("Ev") + 1] if rest.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", head)
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_report(source: Path) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel instance of
    `source`, compiled with the library's flags and `-Xptxas -v`."""
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as work:
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
               "-o", str(Path(work) / "k.o"), str(source)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(cmd)}\n{done.stdout}")
    return [
        {"kernel": short_name(m.group(1)), "registers": int(m.group(5)),
         "stack_bytes": int(m.group(2)), "spill_store_bytes": int(m.group(3)),
         "spill_load_bytes": int(m.group(4))}
        for m in _PTXAS.finditer(done.stdout)
    ]


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


def centroid_loops(library: Path, pattern: str = "_kernel") -> dict[str, dict]:
    """`centroid_loop` of each kernel instance of `library` (`cuobjdump
    -sass`) whose name holds `pattern`."""
    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True, timeout=600).stdout
    return {name: centroid_loop(instructions)
            for name, instructions in _functions(sass).items() if pattern in name}


def centroid_loop(instructions: list[tuple[int, str]]) -> dict | None:
    """The smallest loop (a backward branch and its target) around the
    kernel's first 16-byte shared load (`LDS.128`, a staged centroid), with
    its instruction count and its counts by opcode; None without one."""
    first = next((addr for addr, ins in instructions if _opcode(ins) == "LDS.128"), None)
    if first is None:
        return None
    spans = []
    for addr, ins in instructions:
        m = _BACKWARD.search(ins)
        if m and m.group(1) and int(m.group(1), 16) <= first < addr:
            spans.append((int(m.group(1), 16), addr))
    if not spans:
        return None
    lo, hi = min(spans, key=lambda span: span[1] - span[0])
    ops = collections.Counter(_opcode(ins) for addr, ins in instructions if lo <= addr <= hi)
    return {"start": hex(lo), "instructions": sum(ops.values()),
            "lds128": ops.get("LDS.128", 0), "opcodes": dict(ops.most_common())}
