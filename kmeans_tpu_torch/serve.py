"""HTTP serving daemon: quantization as a service on one CUDA card.

Port of `kmeans_tpu/serve.py`: a threaded stdlib HTTP server around a
bucketed `ImageProcessor`, so concurrent requests of any size coalesce by
shape bucket into the `*_many` calls' batched launches.

    python -m kmeans_tpu_torch.serve --port 8080 \\
        --warmup 1920x1080,1280x720 --warmup-k 8

Endpoints (request body = PNG or JPEG bytes, sniffed):

    GET  /healthz[?deep=1]                      -> 200 "ok" (deep: a device round trip)
    GET  /stats                                 -> JSON counters
    POST /reduce?k=8&mode=replace&algo=kmeans   -> PNG
    POST /palette?k=8&algo=kmeans               -> JSON {"palette": ["#RRGGBB", ...]}
    POST /find?colors=RRGGBB,RRGGBB&mode=dither -> PNG
    POST /reduce-gif?k=8&mode=replace&palette_mode=frame|global  (body: GIF) -> GIF
    POST /find-gif?colors=RRGGBB,...&mode=replace                (body: GIF) -> GIF

Design notes (the reference's):
- IO, decoding and encoding run per connection (ThreadingHTTPServer; the
  native codec releases the interpreter lock); device work is serialized
  behind one lock, which covers every launch a handler thread makes.
- Concurrent same-key k-means requests coalesce into one batched call
  (`_MicroBatcher`); past `max_pending` queued device-bound requests, new
  ones get 503 with Retry-After.
- A failed request returns 4xx/500 with the error text; the server stays
  up.

The processor runs on the CUDA card unless the caller passes a CPU one
(`create_server(processor=ImageProcessor(device="cpu", ...))`) or
`main(argv, device="cpu")`, as `cli.main` does. Nothing here reads or sets
a process-wide torch flag: `torch.cuda.set_sync_debug_mode`, for one, must
stay off while a server runs, since it would act on every handler thread.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from kmeans_tpu_torch.api import Algorithm, ImageProcessor, ReduceMode
from kmeans_tpu_torch.cli import palette_hex
from kmeans_tpu_torch.utils.bucketing import bucket_frames
from kmeans_tpu_torch.utils.imageio import (
    decode_gif_bytes,
    decode_image_bytes,
    encode_gif_bytes,
    encode_png_bytes,
)

log = logging.getLogger("kmeans_tpu_torch.serve")

_HEX_RE = re.compile(r"^[0-9a-fA-F]{6}$")
MAX_BODY = 256 * 1024 * 1024  # 256 MB: a 8192x8192 RGBA PNG fits comfortably

# Stats are keyed by this fixed endpoint set; anything else records under
# "other" so a client POSTing unique random paths can't grow the stats
# dict without bound in a long-lived daemon.
POST_ENDPOINTS = ("/reduce", "/palette", "/find", "/reduce-gif", "/find-gif")


class ServiceOverloaded(RuntimeError):
    """Raised when `max_pending` device-bound requests are already queued;
    the handler answers 503 with Retry-After (kmeans_tpu/serve.py:50).
    Enforced at the service level (`_device_slot`), so it covers every
    path that queues on the device lock: batched k-means traffic, the
    window=0 serialized paths, host-algorithm /reduce and the GIF
    endpoints alike."""

    retry_after_s = 2


class _MicroBatcher:
    """Coalesce concurrent same-parameter k-means /reduce (same k, mode),
    /find (same palette, mode) and /palette (same k, algo) requests into one
    `reduce_many` / `find_many` / `palette_many` call each
    (kmeans_tpu/serve.py:62).

    The first thread to arrive for a key leads the batch: it sleeps the
    collection window, queues on the device lock, and only once the device
    is its (so everything that arrived while an earlier launch held it has
    joined the still-open batch: continuous batching) drains the batch and
    runs it. Followers wait on an event and encode their own results in
    their own handler threads, so only the device section is shared.
    `window_s=0` disables batching; batches close at `max_batch`."""

    def __init__(self, service, window_s: float = 0.005, max_batch: int = 16):
        self.service = service
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: dict[tuple, list] = {}
        # Launches against requests, and a histogram of batch sizes (mostly
        # 1s under concurrency means the batcher is fragmenting).
        self.batches = 0
        self.batched_requests = 0
        self.batch_sizes: dict[int, int] = {}

    def reduce(self, image, k: int, mode):
        if self.window_s <= 0:
            with self.service._device_slot(), self.service._lock:
                return self.service.processor.reduce(k, image, Algorithm.KMEANS, mode)
        return self._submit(
            ("reduce", int(k), mode.value),
            image,
            lambda imgs: self.service.processor.reduce_many(imgs, k, mode),
        )

    def find(self, image, palette, mode, palette_key: str):
        """`palette_key` is the normalized hex string: the coalescing key
        for "same palette"."""
        if self.window_s <= 0:
            with self.service._device_slot(), self.service._lock:
                return self.service.processor.find(image, palette, mode)
        return self._submit(
            ("find", palette_key, mode.value),
            image,
            lambda imgs: self.service.processor.find_many(imgs, palette, mode),
        )

    def palette(self, image, k: int, algo):
        if self.window_s <= 0:
            with self.service._device_slot(), self.service._lock:
                return self.service.processor.palette(k, image, algo)
        return self._submit(
            ("palette", int(k), algo.value),
            image,
            lambda imgs: self.service.processor.palette_many(imgs, k, algo),
        )

    def _submit(self, key, image, batch_fn):
        entry = {"image": image, "event": threading.Event(), "result": None, "error": None}
        # The slot is taken before the entry joins a batch and released in
        # this submitter's own thread on success, error or timeout (the
        # backpressure count must never leak).
        with self.service._device_slot():
            with self._lock:
                batch = self._pending.get(key)
                leader = batch is None
                if leader:
                    batch = []
                    self._pending[key] = batch
                batch.append(entry)
                if len(batch) >= self.max_batch and self._pending.get(key) is batch:
                    del self._pending[key]  # close: next arrival starts fresh
            return self._run(key, entry, batch, leader, batch_fn)

    def _run(self, key, entry, batch, leader, batch_fn):
        if leader:
            time.sleep(self.window_s)
            # Close the batch only once the device is ours: while an earlier
            # launch holds the device lock, later arrivals keep joining this
            # batch, so one launch drains everything queued behind it.
            self.service._lock.acquire()
            items = batch  # wake everyone even if the close below raises
            try:
                with self._lock:
                    if self._pending.get(key) is batch:
                        del self._pending[key]
                    items = list(batch)  # append-safe: key is gone
                outs = batch_fn([e["image"] for e in items])
            except Exception as ex:
                # A failure before the close completed would leave the key
                # pointing at this leaderless batch, and later arrivals would
                # join it and hang: close again and wake every entry, those
                # that joined in the gap included, with the error.
                with self._lock:
                    if self._pending.get(key) is batch:
                        del self._pending[key]
                    items = list(batch)
                for e in items:
                    e["error"] = ex
            else:
                for e, o in zip(items, outs):
                    e["result"] = o
                with self._lock:  # leaders of other keys race these
                    self.batches += 1
                    self.batched_requests += len(items)
                    self.batch_sizes[len(items)] = self.batch_sizes.get(len(items), 0) + 1
            finally:
                self.service._lock.release()
                for e in items:
                    e["event"].set()
        if not entry["event"].wait(timeout=600):
            raise RuntimeError("batched device request timed out")
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]


def _device_probe(device) -> str:
    """A tiny computation on `device`, read back: "ok" when it gives the
    expected value."""
    v = int((torch.arange(4, device=device) + 1).sum().item())
    return "ok" if v == 10 else f"bad value {v}"


class QuantizeService:
    """Protocol-independent request handlers around one `ImageProcessor`
    (kmeans_tpu/serve.py:212). Without a processor it makes
    `ImageProcessor(bucketing=True)`, on the CUDA card."""

    def __init__(self, processor=None, batch_window_s: float = 0.005, max_pending: int = 64):
        if processor is None:
            processor = ImageProcessor(bucketing=True)
        self.processor = processor
        self._lock = threading.Lock()
        # Past `max_pending` device-bound requests `_device_slot` raises
        # ServiceOverloaded (503 + Retry-After) instead of queueing without
        # bound. 0 = unlimited.
        self.max_pending = max_pending
        self.overload_rejections = 0
        self._pending_count = 0
        self._pending_lock = threading.Lock()
        self.batcher = _MicroBatcher(self, window_s=batch_window_s)
        # Per-endpoint request counters and latency sums (GET /stats).
        # deep_health bypasses _device_slot: the health probe must keep
        # answering while the service sheds load.
        self._stats_lock = threading.Lock()
        self._stats: dict[str, dict] = {}
        self._started = time.time()

    @contextlib.contextmanager
    def _device_slot(self):
        """Occupy one of the `max_pending` device-queue slots for a
        device-bound request (its wait on the device lock included); raise
        ServiceOverloaded when none is free (kmeans_tpu/serve.py:247)."""
        with self._pending_lock:
            if self.max_pending and self._pending_count >= self.max_pending:
                self.overload_rejections += 1
                raise ServiceOverloaded(f"{self._pending_count} requests already pending")
            self._pending_count += 1
        try:
            yield
        finally:
            with self._pending_lock:
                self._pending_count -= 1

    def record(self, endpoint: str, seconds: float, ok: bool) -> None:
        with self._stats_lock:
            e = self._stats.setdefault(
                endpoint,
                {"requests": 0, "errors": 0, "seconds_total": 0.0, "seconds_max": 0.0},
            )
            e["requests"] += 1
            if not ok:
                e["errors"] += 1
            e["seconds_total"] += seconds
            e["seconds_max"] = max(e["seconds_max"], seconds)

    def stats(self) -> bytes:
        with self._stats_lock:
            snapshot = {
                name: {**e, "seconds_avg": e["seconds_total"] / e["requests"] if e["requests"]
                       else 0.0}
                for name, e in self._stats.items()
            }
        return json.dumps(
            {"uptime_s": round(time.time() - self._started, 1),
             "endpoints": snapshot,
             "batching": {
                 "window_ms": self.batcher.window_s * 1e3,
                 "launches": self.batcher.batches,
                 "requests_batched": self.batcher.batched_requests,
                 "batch_size_hist": {
                     str(size): n for size, n in sorted(self.batcher.batch_sizes.items())
                 },
             },
             # Service-wide (batched and direct device paths).
             "backpressure": {
                 "max_pending": self.max_pending,
                 "pending": self._pending_count,
                 "overload_rejections": self.overload_rejections,
             }},
            indent=2,
        ).encode()

    # -- request implementations (raise ValueError for 400s) -- #

    def reduce(self, body: bytes, k: int, mode: str, algo: str) -> bytes:
        image = _decode_image(body)
        if algo == "kmeans":
            out = self.batcher.reduce(image, k, ReduceMode(mode))
        else:
            with self._device_slot(), self._lock:
                out = self.processor.reduce(k, image, Algorithm(algo), ReduceMode(mode))
        return encode_png_bytes(out)

    def palette(self, body: bytes, k: int, algo: str) -> bytes:
        image = _decode_image(body)
        pal = self.batcher.palette(image, k, Algorithm(algo))
        return json.dumps({"palette": palette_hex(pal).split(",")}).encode()

    def find(self, body: bytes, colors: str, mode: str) -> bytes:
        image = _decode_image(body)
        palette = _parse_colors(colors)
        # The normalized hex form is the key, so "#FF0000" and "ff0000"
        # share a batch.
        palette_key = ",".join(f"{r:02x}{g:02x}{b:02x}" for r, g, b, _ in palette)
        out = self.batcher.find(image, palette, ReduceMode(mode), palette_key)
        return encode_png_bytes(out)

    def reduce_gif(self, body: bytes, k: int, mode: str, palette_mode: str) -> bytes:
        if mode == "meld":
            raise ValueError("GIF output cannot encode meld's continuous blends")
        if k > 256:
            raise ValueError("GIF output requires k <= 256")
        frames, delays = _decode_gif(body)
        with self._device_slot(), self._lock:
            if palette_mode == "global":
                palette = self.processor.palette_images(frames, k)
                outs = self.processor.find_batch(frames, palette, ReduceMode(mode))
            else:
                outs = self.processor.reduce_images(frames, k, ReduceMode(mode))
        return encode_gif_bytes(outs, delays=delays)

    def deep_health(self, timeout_s: float = 10.0) -> tuple[bool, str]:
        """Round-trip a tiny computation through the processor's device
        under a timeout (kmeans_tpu/serve.py:373): a probe that hangs (a
        wedged device or driver) reports unhealthy instead of hanging the
        health check."""
        result: list[str] = []

        def probe():
            try:
                result.append(_device_probe(self.processor.device))
            except Exception as e:  # device-dependent
                result.append(f"device error: {e}")

        # The device lock may be held by a request that is itself wedged:
        # a timed acquire keeps the health check from inheriting the hang.
        if not self._lock.acquire(timeout=timeout_s):
            return False, f"device busy/unresponsive (lock held > {timeout_s:.0f}s)"
        try:
            t = threading.Thread(target=probe, daemon=True)
            t.start()
            t.join(timeout_s)
        finally:
            self._lock.release()
        if not result:
            return False, f"device unresponsive after {timeout_s:.0f}s"
        return result[0] == "ok", result[0]

    def find_gif(self, body: bytes, colors: str, mode: str) -> bytes:
        if mode == "meld":
            raise ValueError("GIF output cannot encode meld's continuous blends")
        palette = _parse_colors(colors)
        if palette.shape[0] > 256:
            raise ValueError("GIF output requires a palette of <= 256 colors")
        frames, delays = _decode_gif(body)
        with self._device_slot(), self._lock:
            outs = self.processor.find_batch(frames, palette, ReduceMode(mode))
        return encode_gif_bytes(outs, delays=delays)


def _decode_image(body: bytes):
    """Decode request bytes; any decoder failure (truncated file, codec
    error) is a client error, not a 500."""
    try:
        return decode_image_bytes(body)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"could not decode image: {e}")


def _decode_gif(body: bytes):
    try:
        return decode_gif_bytes(body, with_delays=True)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"could not decode GIF: {e}")


def _parse_colors(colors: str):
    rgba = []
    for p in colors.split(",") if colors else []:
        p = p.lstrip("#")
        if not _HEX_RE.match(p):
            raise ValueError(f"bad color {p!r}: want RRGGBB hex")
        rgba.append((int(p[0:2], 16), int(p[2:4], 16), int(p[4:6], 16), 255))
    if not rgba:
        raise ValueError("need colors=RRGGBB[,RRGGBB...]")
    return np.asarray(rgba, np.uint8)


def _make_handler(service: QuantizeService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.info("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: bytes, ctype: str, headers: dict | None = None):
            self._last_code = code
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str, headers: dict | None = None):
            # Error paths may leave the request body unread; closing the
            # connection keeps HTTP/1.1 keep-alive streams in sync.
            self.close_connection = True
            self._reply(code, (msg + "\n").encode(), "text/plain", headers)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                if q.get("deep", "").lower() in ("1", "true", "yes"):
                    healthy, msg = service.deep_health()
                    return self._reply(200 if healthy else 503, (msg + "\n").encode(),
                                       "text/plain")
                self._reply(200, b"ok\n", "text/plain")
            elif url.path == "/stats":
                self._reply(200, service.stats(), "application/json")
            else:
                self._error(404, "unknown endpoint")

        def do_POST(self):
            url = urlparse(self.path)
            t0 = time.perf_counter()
            self._last_code = 500  # overwritten by _reply; a crash counts as error
            try:
                self._do_post(url)
            finally:
                endpoint = url.path if url.path in POST_ENDPOINTS else "other"
                service.record(endpoint, time.perf_counter() - t0, self._last_code < 400)

        def _do_post(self, url):
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            algos = ("kmeans", "octree", "mediancut", "wu")
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    return self._error(400, "missing request body")
                if length > MAX_BODY:
                    return self._error(413, "request body too large")
                body = self.rfile.read(length)
                if url.path == "/reduce":
                    out = service.reduce(
                        body,
                        k=_parse_k(q.get("k", "8")),
                        mode=_parse_choice(q, "mode", "replace", ("replace", "dither", "meld")),
                        algo=_parse_choice(q, "algo", "kmeans", algos),
                    )
                    return self._reply(200, out, "image/png")
                if url.path == "/palette":
                    out = service.palette(
                        body,
                        k=_parse_k(q.get("k", "8")),
                        algo=_parse_choice(q, "algo", "kmeans", algos),
                    )
                    return self._reply(200, out, "application/json")
                if url.path == "/find":
                    out = service.find(
                        body,
                        colors=q.get("colors", ""),
                        mode=_parse_choice(q, "mode", "replace", ("replace", "dither", "meld")),
                    )
                    return self._reply(200, out, "image/png")
                if url.path == "/reduce-gif":
                    out = service.reduce_gif(
                        body,
                        k=_parse_k(q.get("k", "8")),
                        mode=_parse_choice(q, "mode", "replace", ("replace", "dither")),
                        palette_mode=_parse_choice(q, "palette_mode", "frame",
                                                   ("frame", "global")),
                    )
                    return self._reply(200, out, "image/gif")
                if url.path == "/find-gif":
                    out = service.find_gif(
                        body,
                        colors=q.get("colors", ""),
                        mode=_parse_choice(q, "mode", "replace", ("replace", "dither")),
                    )
                    return self._reply(200, out, "image/gif")
                return self._error(404, "unknown endpoint")
            except ValueError as e:
                return self._error(400, str(e))
            except ServiceOverloaded as e:
                # Bounded backpressure: shed load with an honest signal
                # instead of queueing without bound behind the device.
                return self._error(503, f"overloaded: {e}",
                                   headers={"Retry-After": str(e.retry_after_s)})
            except Exception as e:  # keep the server alive on device errors
                log.exception("request failed")
                return self._error(500, f"internal error: {e}")

    return Handler


def _parse_k(value: str) -> int:
    try:
        k = int(value)
    except ValueError:
        raise ValueError("k must be an integer higher than 0.")
    if k < 1:
        raise ValueError("k must be an integer higher than 0.")
    return k


def _parse_choice(q: dict, key: str, default: str, choices) -> str:
    v = q.get(key, default)
    if v not in choices:
        raise ValueError(f"{key} must be one of {', '.join(choices)}")
    return v


def create_server(host: str = "127.0.0.1", port: int = 8080, processor=None,
                  batch_window_s: float = 0.005, max_pending: int = 64):
    """Build (but don't start) the HTTP server (kmeans_tpu/serve.py:593);
    `server.server_address[1]` holds the bound port (port=0 for an
    ephemeral one), `server.service` the QuantizeService (stats,
    batcher). Without a processor it serves `ImageProcessor(bucketing=True)`
    on the CUDA card."""
    service = QuantizeService(processor, batch_window_s=batch_window_s, max_pending=max_pending)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service
    return server


def main(argv=None, device=None) -> int:
    """Parse the reference's flags (kmeans_tpu/serve.py:611), warm the
    processor and serve until SIGTERM or ^C. `device=None` runs on the CUDA
    card and raises without one; `device="cpu"` serves the plain PyTorch
    path."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="kmeans-tpu-torch-serve", description=__doc__.splitlines()[0]
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--warmup", default="",
        help="comma-separated WxH sizes to warm buckets for, e.g. 1920x1080,1280x720",
    )
    parser.add_argument(
        "--warmup-k", default="8", help="comma-separated k values used for warmup (default 8)"
    )
    parser.add_argument(
        "--train-size", default=None,
        help="training-shrink cap in px (default 256, the reference's), "
        "or 'full' to train on every pixel",
    )
    parser.add_argument(
        "--exact", action="store_true",
        help="disable shape bucketing (requests of different sizes do not coalesce)",
    )
    parser.add_argument(
        "--fast", action="store_true",
        help="fast kernel tiers for 16 < k <= 512 (not bit-equal to the exact path)",
    )
    parser.add_argument(
        "--pipeline", action="store_true",
        help="transfer-pipelined paths: /palette uploads the host-shrunk training strip "
        "instead of the full image (~200x fewer bytes at 4K), /reduce streams bands",
    )
    parser.add_argument(
        "--delta-e", choices=["94", "2000"], default="94",
        help="color-difference metric (CIEDE2000 runs in the kernels too)",
    )

    def _positive_int(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    parser.add_argument(
        "--restarts", type=_positive_int, default=1,
        help="independent k-means++ seedings per request (lowest-inertia palette wins)",
    )
    parser.add_argument(
        "--batch-window-ms", type=float, default=5.0,
        help="micro-batching collection window: concurrent same-(k, mode) /reduce and "
        "same-(palette, mode) /find requests within this window coalesce into one "
        "batched call (0 disables)",
    )
    parser.add_argument(
        "--warmup-find", default="",
        help="comma-separated palette sizes to warm /find for (sizes bucket to powers "
        "of two, so one size per bucket suffices)",
    )
    parser.add_argument(
        "--max-pending", type=int, default=64,
        help="bounded backpressure: past this many queued-but-unfinished device-bound "
        "requests, new ones get 503 + Retry-After (0 = unlimited)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    kwargs = {}
    if args.train_size is not None:
        kwargs["train_max_size"] = (
            None if args.train_size.lower() == "full" else int(args.train_size)
        )
    try:
        processor = ImageProcessor(
            device=device, bucketing=not args.exact, fast=args.fast, delta_e=args.delta_e,
            restarts=args.restarts, pipeline=args.pipeline, **kwargs,
        )
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc
    find_sizes = [int(s) for s in args.warmup_find.split(",")] if args.warmup_find else ()
    if find_sizes and not args.warmup:
        log.warning("--warmup-find has no effect without --warmup (no image sizes to warm "
                    "buckets for)")
    if args.batch_window_ms > 0 and processor.device.type == "cpu":
        # Micro-batching amortizes per-launch costs, which the plain CPU
        # path does not have (docs/serving.md).
        log.warning("micro-batching is enabled on the CPU; it only pays where device "
                    "launches are expensive: consider --batch-window-ms 0")

    server = create_server(args.host, args.port, processor,
                           batch_window_s=args.batch_window_ms / 1e3,
                           max_pending=args.max_pending)
    if args.warmup:
        sizes = []
        for part in args.warmup.split(","):
            w, _, h = part.lower().partition("x")
            sizes.append((int(w), int(h)))
        ks = [int(k) for k in args.warmup_k.split(",")]
        # With micro-batching on, coalesced requests run the *_many calls:
        # warm every frame-count bucket the batcher can produce.
        batch_sizes = (sorted({bucket_frames(n) for n in range(2, 17)})
                       if args.batch_window_ms > 0 else ())
        log.info("warming %d size(s) x %d k value(s) (+%d batch bucket(s), "
                 "%d find palette size(s))...", len(sizes), len(ks), len(batch_sizes),
                 len(find_sizes))
        with server.service._lock:
            n = processor.warmup(sizes, ks, batch_sizes=batch_sizes,
                                 find_palette_sizes=find_sizes)
        log.info("warmup done: %d call(s)", n)
    log.info("serving on %s:%d", *server.server_address)

    def _on_term(signum, frame):
        # Orchestrators send SIGTERM; shutdown() must run off the serve thread.
        log.info("SIGTERM: shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
