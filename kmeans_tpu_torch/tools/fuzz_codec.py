"""Mutation fuzzer for the port's native codec (`kmeans_tpu_torch/runtime/`).

Port of `tools/fuzz_codec.py`. The serving daemon decodes untrusted request
bytes with this codec, so a crash (segfault, abort) in the libpng / libjpeg
glue or the hand-written GIF / LZW decoder is a denial of service. This
harness:

1. builds small valid PNG (RGBA and palette), JPEG and GIF payloads with
   the codec itself (PNG and JPEG with the runtime's libpng / libjpeg unit
   where the host has it; without it the PNG seeds come from, and decode
   through, `utils/png_py.py`, and there is no JPEG),
2. applies random mutations (bit flips, truncations, corrupted 4-byte
   length or dimension fields, spliced blocks, appended junk),
3. decodes each mutant with every decoder in a forked worker, a batch of
   mutants a worker (a crash kills the worker, not the harness), and
   reports any batch whose worker died, then the mutants that crash alone.

`ValueError` (and `MemoryError`) are expected of the native decoders for
invalid data, any exception of the pure-Python one; a worker that dies, on
a signal or another exception, is the failure. The runtime
is built before the first fork, so the workers share the loaded library.
Run:

    python -m kmeans_tpu_torch.tools.fuzz_codec [iterations] [seed]

It exits 1 when a batch crashed, and writes each crashing mutant to
`fuzz_crash_<n>.bin` in the working directory.
"""

from __future__ import annotations

import os
import signal
import struct
import sys

import numpy as np

from kmeans_tpu_torch import runtime
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils import png_py
from kmeans_tpu_torch.utils.imageio import encode_gif_bytes, encode_png_bytes


def seed_corpus() -> list[bytes]:
    """The valid payloads that mutants start from (the reference's)."""
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    img = Image((17, 13), rgba)
    indexed = Image((16, 16), np.tile(rgba[:2, :2], (8, 8, 1)))
    corpus = [
        encode_png_bytes(img),
        encode_png_bytes(indexed),  # palette PNG path
        encode_gif_bytes([indexed, indexed], delays=[5, 7]),
    ]
    if runtime.codec_available():
        corpus.append(runtime.encode_jpeg(17, 13, rgba, 85))
    return corpus


def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    buf = bytearray(data)
    op = rng.integers(0, 5)
    if op == 0 and len(buf) > 1:  # bit flips
        for _ in range(int(rng.integers(1, 8))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= 1 << int(rng.integers(0, 8))
    elif op == 1:  # truncate
        buf = buf[: int(rng.integers(0, len(buf) + 1))]
    elif op == 2 and len(buf) > 8:  # corrupt a 4-byte length/dimension field
        i = int(rng.integers(0, len(buf) - 4))
        buf[i : i + 4] = struct.pack(
            ">I", int(rng.choice([0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 1 << 20]))
        )
    elif op == 3 and len(buf) > 2:  # splice a random block
        i = int(rng.integers(0, len(buf)))
        j = int(rng.integers(0, len(buf)))
        n = int(rng.integers(1, 64))
        buf[i : i + n] = buf[j : j + n]
    else:  # append junk
        buf += bytes(rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8))
    return bytes(buf)


def decode_all(data: bytes) -> None:
    native = [runtime.decode_gif]
    if runtime.codec_available():
        native += [runtime.decode_png, runtime.decode_jpeg]
    else:
        try:
            png_py.decode_png(data)
        except Exception:
            pass  # pure Python: any exception is a clean refusal
    for fn in native:
        try:
            fn(data)
        except (ValueError, MemoryError):
            pass  # raising is the correct behaviour for bad input


def _crashed(mutants: list[bytes]) -> str | None:
    """Decode `mutants` in a forked worker: how it died (the signal, or an
    exception other than the decoders' `ValueError`), if it did."""
    pid = os.fork()
    if pid == 0:  # worker: never returns into the harness
        code = 0
        try:
            for m in mutants:
                decode_all(m)
        except BaseException:
            code = 3
        finally:
            os._exit(code)
    _, status = os.waitpid(pid, 0)
    if os.WIFSIGNALED(status):
        return signal.Signals(os.WTERMSIG(status)).name
    return "an unexpected exception" if os.WEXITSTATUS(status) else None


def run(iterations: int = 2000, seed: int = 0, batch: int = 100) -> int:
    """Fuzz `iterations` mutants from `seed`; return the number of batches
    whose worker died."""
    runtime.load()
    if runtime.codec_available():
        runtime.load_codec()
    corpus = seed_corpus()
    rng = np.random.default_rng(seed)
    failures = 0
    done = 0
    while done < iterations:
        n = min(batch, iterations - done)
        mutants = [mutate(corpus[int(rng.integers(0, len(corpus)))], rng) for _ in range(n)]
        how = _crashed(mutants)
        if how is not None:
            failures += 1
            print(f"CRASH: batch at iteration {done} died on {how}", flush=True)
            for i, m in enumerate(mutants):  # isolate, each in its own fork
                if _crashed([m]) is not None:
                    path = f"fuzz_crash_{done + i}.bin"
                    with open(path, "wb") as f:
                        f.write(m)
                    print(f"  reproducer written to {path}", flush=True)
        done += n
    print(f"fuzz: {done} mutants, {failures} crashing batch(es)")
    return failures


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    its = int(argv[0]) if argv else 2000
    sd = int(argv[1]) if len(argv) > 1 else 0
    return 1 if run(its, sd) else 0


if __name__ == "__main__":
    sys.exit(main())
