"""The meld kernel's sRGB encode by step points, checked on the card.

The meld kernel writes each blended channel as the byte of
`csrc/colorspace.cuh::linear_to_srgb8_pow` (`powf(c, 1 / 2.4)`, the sRGB
curve, `rint(255 x)`), found by an 8-step search of 255 committed step
points (`KM_SRGB8_STEPS`) instead of a `powf`. `csrc/srgb_steps.cu` runs
the definition on all 2^32 float32 inputs and counts where it decreases
or gives NaN or a negative input a byte other than 0, and where the
search over the committed points differs from it; it also finds the step
points anew. Both counts 0 and the points equal to the committed ones
prove the search exact on every input.

    python -m kmeans_tpu_torch.tools.srgb_steps

prints one JSON line: the two counts, whether the points equal the
committed ones, and the seconds the check took, and, if they differ, the
recomputed points as the `KM_SRGB8_STEPS` lines to commit. It needs a
card.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from kmeans_tpu_torch.ops import _build

_STEPS = re.compile(r"#define KM_SRGB8_STEPS\s*\\\n(.*?)\nstatic", re.S)


def committed_steps() -> list[int]:
    """The 256 committed entries of `KM_SRGB8_STEPS` (entry 0 unused), as
    int32 values, read from `csrc/colorspace.cuh`."""
    body = _STEPS.search((_build.CSRC / "colorspace.cuh").read_text()).group(1)
    return [int(v, 16) if v.startswith("0x") else int(v)
            for v in re.findall(r"0x[0-9a-f]+|\b\d+\b", body.replace("\\", ""))]


def macro_lines(steps: list[int]) -> str:
    """`steps` as the body of the `KM_SRGB8_STEPS` macro."""
    words = [f"0x{v:08x}" if v else "0" for v in steps]
    rows = [", ".join(words[i:i + 8]) for i in range(0, len(words), 8)]
    return " \\\n".join("  " + row + ("," if i + 1 < len(rows) else "")
                        for i, row in enumerate(rows))


def check_on_card(device: torch.device) -> dict:
    """Run `csrc/srgb_steps.cu` once: `{"broken": inputs breaking the
    encode's rules, "differ": inputs the committed points map to another
    byte, "steps": the recomputed points (entry 0 is 0), "seconds"}`."""
    lib = _build.load_library()
    steps = torch.zeros(256, dtype=torch.int32, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = lib.kmeans_srgb8_steps(steps.data_ptr(), counts.data_ptr(),
                                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"srgb8_steps launch failed: CUDA error {err} "
                               f"({lib.kmeans_error_string(err).decode()})")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    broken, differ = (int(v) for v in counts.cpu().tolist())
    return {"broken": broken, "differ": differ, "steps": steps.cpu().tolist(),
            "seconds": seconds}


def search_model(x: np.ndarray, steps: list[int]) -> np.ndarray:
    """The kernel's search (`colorspace.cuh::linear_to_srgb8`) in numpy:
    `x` float32, the byte each maps to under `steps`."""
    x = np.asarray(x, np.float32)
    bits = np.where(x >= 0, x.view(np.int32), 0)
    table = np.asarray(steps, np.int64)
    pos = np.zeros(x.shape, np.int64)
    for s in (128, 64, 32, 16, 8, 4, 2, 1):
        pos += np.where(bits >= table[pos + s], s, 0)
    return pos


def main() -> int:
    if not torch.cuda.is_available():
        print("srgb_steps: no CUDA device available", file=sys.stderr)
        return 1
    out = check_on_card(torch.device("cuda", 0))
    same = out["steps"][1:] == committed_steps()[1:]
    print(json.dumps({"broken": out["broken"], "differ": out["differ"],
                      "steps_equal_committed": same, "seconds": out["seconds"]}), flush=True)
    if not same:
        print(macro_lines(out["steps"]), flush=True)
    return 0 if same and out["broken"] == 0 and out["differ"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
