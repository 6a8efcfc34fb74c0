"""Serving load test: N parallel clients on POST /reduce, /find or /palette.

Port of `tools/load_serve.py`. It measures end-to-end requests per second
twice, micro-batching off (window 0: every request serialized behind the
device lock) and on, and prints one JSON line with both, each with its
latency percentiles and the batcher's launch counters. The server runs in
this process over `ImageProcessor(bucketing=True)` on the CUDA card (or on
`--cpu`, the plain path), so the card's host-to-device copy rates are
measured beside it and carried in the line.

    python -m kmeans_tpu_torch.tools.load_serve [clients=8] [requests_per_client=4] \\
        [window_ms=25] [endpoint=reduce|find|palette|mixed] [size=320x240] \\
        [train=default|256|full] [k=8] [open_rate=0] [max_pending=0] [--cpu]

`mixed` gives each client one of the three endpoints in turn (concurrent
traffic under different batcher keys). `open_rate > 0` replaces the
closed loop (each client fires its next request when the last returns)
with an open one: start times from a Poisson process at `open_rate`
requests/s in all, split across the clients, latency counted from the
scheduled arrival. `max_pending > 0` measures the server's backpressure
limit under overload: 503s are counted as shed, not as errors, and the
rate is the goodput of 200s.

`run()` is the measurement, reused by `chip_smoke.py`'s serving slice; it
can keep every response for checking. The /find workload recolours with
16 colours (`FIND_COLORS`).
"""

from __future__ import annotations

import http.client
import json
import random
import sys
import threading
import time

import numpy as np
import torch

from kmeans_tpu_torch.api import ImageProcessor, ReduceMode
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.serve import create_server
from kmeans_tpu_torch.utils.bucketing import bucket_frames
from kmeans_tpu_torch.utils.imageio import decode_image_bytes, encode_png_bytes

FIND_COLORS = ("dc3228,28c846,3c46dc,f0f0f0,101010,c8a028,28b4b4,9632c8,"
               "e67814,5a5a5a,a0d2f0,f0a0c8,1e6e3c,783c14,c8c8a0,3c1e78")


def workload_image(width: int = 320, height: int = 240) -> Image:
    """The load test's image (3 noisy colour blobs, seed 7), the
    reference's `tools/load_serve.py::test_image`."""
    rng = np.random.default_rng(7)
    base = np.array([[220, 50, 40], [40, 200, 70], [60, 70, 220]], np.int32)
    idx = rng.integers(0, 3, (height, width))
    rgb = np.clip(base[idx] + rng.integers(-8, 9, (height, width, 3)), 0, 255)
    rgba = np.concatenate(
        [rgb.astype(np.uint8), np.full((height, width, 1), 255, np.uint8)], -1
    )
    return Image((width, height), rgba)


def find_palette() -> np.ndarray:
    """`FIND_COLORS` as `[16, 4]` RGBA8."""
    return np.asarray([[int(c[0:2], 16), int(c[2:4], 16), int(c[4:6], 16), 255]
                       for c in FIND_COLORS.split(",")], np.uint8)


def paths(endpoint: str, k: int) -> list[str]:
    """Request path(s) for an endpoint; `mixed` gives all three."""
    table = {
        "reduce": f"/reduce?k={k}",
        "find": f"/find?colors={FIND_COLORS}",
        "palette": f"/palette?k={k}",
    }
    if endpoint == "mixed":
        return [table["reduce"], table["palette"], table["find"]]
    return [table[endpoint]]


def post(addr, body: bytes, path: str) -> tuple[int, dict, bytes]:
    """`(status, headers, body)` of one POST."""
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request("POST", path, body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def warm(processor, body: bytes, endpoint: str, k: int, max_batch: int = 16) -> None:
    """Run every path the timed phase can take once, out of band: the solo
    calls and the `*_many` calls of every frame-count bucket a batch of up
    to `max_batch` reaches."""
    img = decode_image_bytes(body)
    eps = ("reduce", "palette", "find") if endpoint == "mixed" else (endpoint,)
    for fb in [1] + sorted({bucket_frames(n) for n in range(2, max_batch + 1)}):
        if "reduce" in eps:
            processor.reduce_many([img] * fb, k, ReduceMode.REPLACE)
        if "palette" in eps:
            processor.palette_many([img] * fb, k)
        if "find" in eps:
            processor.find_many([img] * fb, find_palette(), ReduceMode.REPLACE)
    if "reduce" in eps:
        processor.reduce(k, img)
    if "palette" in eps:
        processor.palette(k, img)
    if "find" in eps:
        processor.find(img, find_palette(), ReduceMode.REPLACE)


def run(processor, window_s: float, body: bytes, clients: int, per_client: int,
        endpoint: str = "reduce", k: int = 8, open_rate: float = 0.0, max_pending: int = 0,
        responses: list | None = None) -> dict:
    """Serve `processor` on an ephemeral port with batching window
    `window_s` and time `clients * per_client` requests of `body`; return
    the counts, rates and latency percentiles. `max_pending=0` measures the
    batcher (no backpressure limit); above 0, the limit. With `responses`,
    every timed response is appended as `(path, status, headers, body)`."""
    request_paths = paths(endpoint, k)
    srv = create_server(port=0, processor=processor, batch_window_s=window_s,
                        max_pending=max_pending)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    try:
        errors: list = []
        latencies: list[float] = []
        shed: list[float] = []
        lock = threading.Lock()
        schedule = None
        if open_rate > 0:
            rand = random.Random(417)
            t = 0.0
            schedule = []
            for _ in range(clients * per_client):
                t += rand.expovariate(open_rate)
                schedule.append(t)

        def client(ci):
            path = request_paths[ci % len(request_paths)]
            for ri in range(per_client):
                if schedule is not None:
                    due = t0 + schedule[ri * clients + ci]
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    # Latency counts from the scheduled arrival: a request
                    # fired late waited on the server (no coordinated
                    # omission).
                    ts = due
                else:
                    ts = time.perf_counter()
                status, headers, data = post(addr, body, path)
                with lock:
                    if responses is not None:
                        responses.append((path, status, headers, data))
                    if status == 200:
                        latencies.append(time.perf_counter() - ts)
                    elif status == 503 and max_pending > 0:
                        shed.append(time.perf_counter() - ts)
                    else:
                        errors.append(status)

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(clients)]
        b = srv.service.batcher
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"load_serve: non-200 responses {errors}")
        n = clients * per_client
        lat = sorted(latencies)
        if not lat:
            raise RuntimeError("load_serve: every request was shed")
        result = {
            "window_ms": window_s * 1e3,
            "requests": n,
            "seconds": elapsed,
            "rps": n / elapsed,
            "batched_calls": b.batches if window_s > 0 else n,
            "requests_batched": b.batched_requests,
            "batch_size_hist": dict(sorted(b.batch_sizes.items())),
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p95_ms": lat[min(len(lat) - 1, int(len(lat) * 0.95))] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            "max_ms": lat[-1] * 1e3,
        }
        if open_rate > 0:
            result["offered_rps"] = open_rate
        if max_pending > 0:
            # Latency percentiles above are of accepted requests only;
            # goodput counts the 200s.
            result.update(max_pending=max_pending, accepted=len(lat), shed_503=len(shed),
                          shed_fraction=len(shed) / n, goodput_rps=len(lat) / elapsed,
                          overload_rejections=srv.service.overload_rejections,
                          pending_after=srv.service._pending_count)
            result["rps"] = result["goodput_rps"]
        return result
    finally:
        srv.shutdown()
        srv.server_close()


def copy_rates(device) -> dict:
    """Host-to-device and device-to-host copy rates of 64 MB from pageable
    memory (MB/s), the transport context of the rates (the reference
    measures its tunnel's here)."""
    n = 64 << 20
    host = torch.empty(n, dtype=torch.uint8)
    dev = host.to(device)
    torch.cuda.synchronize(device)
    rates = {}
    for name, fn in (("up", lambda: host.to(device)), ("down", lambda: dev.cpu())):
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize(device)
        rates[f"{name}_mb_s"] = 3 * n / (time.perf_counter() - t0) / 1e6
    return rates


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    if cpu:
        argv.remove("--cpu")

    def arg(i, default):
        return argv[i] if len(argv) > i else default

    clients, per_client = int(arg(0, 8)), int(arg(1, 4))
    window_ms = float(arg(2, 25.0))
    endpoint = arg(3, "reduce")
    if endpoint not in ("reduce", "find", "palette", "mixed"):
        raise SystemExit(f"unknown endpoint {endpoint!r}")
    size = arg(4, "320x240")
    w, _, h = size.lower().partition("x")
    train = arg(5, "default")
    k = int(arg(6, 8))
    open_rate = float(arg(7, 0.0))
    max_pending = int(arg(8, 0))

    kwargs = {} if train == "default" else {
        "train_max_size": None if train == "full" else int(train)}
    processor = ImageProcessor(device="cpu" if cpu else None, bucketing=True, **kwargs)
    body = encode_png_bytes(workload_image(int(w), int(h)))
    warm(processor, body, endpoint, k)
    rates = {} if cpu else copy_rates(processor.device)
    serial = run(processor, 0.0, body, clients, per_client, endpoint, k, open_rate, max_pending)
    print(f"serialized: {serial}", file=sys.stderr)
    batched = run(processor, window_ms / 1e3, body, clients, per_client, endpoint, k,
                  open_rate, max_pending)
    print(f"batched:    {batched}", file=sys.stderr)
    device = "cpu" if cpu else torch.cuda.get_device_name(processor.device)
    print(json.dumps({
        "endpoint": endpoint, "clients": clients, "size": size, "train": train, "k": k,
        "open_rate": open_rate, "device": device, **rates,
        "serialized_rps": serial["rps"], "batched_rps": batched["rps"],
        "speedup": batched["rps"] / serial["rps"], "serial": serial, "batched": batched,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
