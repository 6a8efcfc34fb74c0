"""PyTorch port vs the JAX package: the HTTP serving daemon.

The 27 cases of the reference's `tests/test_serve.py` against
`kmeans_tpu_torch.serve`: a real server on an ephemeral port over a CPU
processor (`ImageProcessor(device="cpu", bucketing=True)`), real requests
through http.client, the micro-batcher and the backpressure limit with fake
processors, the deep health probe (a torch computation on the processor's
device here, `jnp` in the reference), the dimension-bomb GIF answering 400
with "decode limit" and the GIF endpoints, which run on the port's native
codec. Then one request per endpoint against the reference's
`QuantizeService` method called directly (its native runtime built for
these tests and injected, `_torch_reference_runtime.py`): the same response
bytes.
"""

import http.client
import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from _torch_reference_runtime import ref_runtime  # noqa: F401 (fixture)
from kmeans_tpu_torch import serve as serve_mod
from kmeans_tpu_torch.api import Algorithm, ReduceMode
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.serve import QuantizeService, ServiceOverloaded
from kmeans_tpu_torch.utils import imageio as iio
from kmeans_tpu_torch.utils.imageio import decode_image_bytes, encode_png_bytes

torch.set_num_threads(2)


def create_server(**kwargs):
    """The port's server over a CPU processor (the port's default is the
    card)."""
    return serve_mod.create_server(
        processor=kt.ImageProcessor(device="cpu", bucketing=True), **kwargs)


@pytest.fixture(scope="module")
def server():
    srv = create_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def png_body():
    rng = np.random.default_rng(31)
    base = np.array([[220, 50, 40], [40, 200, 70], [60, 70, 220]], np.int32)
    idx = rng.integers(0, 3, (40, 56))
    rgb = np.clip(base[idx] + rng.integers(-8, 9, (40, 56, 3)), 0, 255)
    rgba = np.concatenate(
        [rgb.astype(np.uint8), np.full((40, 56, 1), 255, np.uint8)], -1
    )
    return encode_png_bytes(Image((56, 40), rgba))


def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_healthz(server):
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.read() == b"ok\n"
    conn.close()


def test_reduce_endpoint(server, png_body):
    status, ctype, data = _post(server, "/reduce?k=3", png_body)
    assert status == 200 and ctype == "image/png"
    out = decode_image_bytes(data)
    assert out.dimensions == (56, 40)
    assert len(np.unique(out.pixels.reshape(-1, 4), axis=0)) <= 3


def test_reduce_other_size_same_bucket(server, png_body):
    # A different size in the same bucket reuses the compiled executable.
    rng = np.random.default_rng(32)
    rgba = rng.integers(0, 256, (38, 50, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    body = encode_png_bytes(Image((50, 38), rgba))
    status, _, data = _post(server, "/reduce?k=3&mode=dither", body)
    assert status == 200
    assert decode_image_bytes(data).dimensions == (50, 38)


def test_palette_endpoint(server, png_body):
    status, ctype, data = _post(server, "/palette?k=3&algo=wu", png_body)
    assert status == 200 and ctype == "application/json"
    pal = json.loads(data)["palette"]
    assert 1 <= len(pal) <= 3
    assert all(p.startswith("#") and len(p) == 7 for p in pal)


def test_find_endpoint(server, png_body):
    status, ctype, data = _post(
        server, "/find?colors=ff0000,00ff00,0000ff", png_body
    )
    assert status == 200 and ctype == "image/png"
    out = decode_image_bytes(data)
    assert len(np.unique(out.pixels.reshape(-1, 4), axis=0)) <= 3


def test_errors(server, png_body):
    status, _, data = _post(server, "/reduce?k=0", png_body)
    assert status == 400 and b"k must be" in data
    status, _, _ = _post(server, "/reduce?mode=bogus", png_body)
    assert status == 400
    status, _, _ = _post(server, "/find?colors=zzz", png_body)
    assert status == 400
    status, _, data = _post(server, "/reduce?k=3", b"not an image")
    assert status == 400 and b"unrecognized" in data
    status, _, _ = _post(server, "/nope", png_body)
    assert status == 404
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("POST", "/reduce?k=3")  # no body
    assert conn.getresponse().status == 400
    conn.close()


def test_gif_endpoints(server):
    rng = np.random.default_rng(33)
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230]], np.int32)
    frames = []
    for _ in range(3):
        idx = rng.integers(0, 3, (16, 16))
        rgb = np.clip(base[idx] + rng.integers(-9, 10, (16, 16, 3)), 0, 255)
        rgba = np.concatenate(
            [rgb.astype(np.uint8), np.full((16, 16, 1), 255, np.uint8)], -1
        )
        frames.append(Image((16, 16), rgba))
    gif = iio.encode_gif_bytes(frames, delays=[5, 10, 15])

    status, ctype, data = _post(
        server, "/reduce-gif?k=3&palette_mode=global", gif
    )
    assert status == 200 and ctype == "image/gif"
    back, delays = iio.decode_gif_bytes(data, with_delays=True)
    assert len(back) == 3 and delays == [5, 10, 15]
    union = np.unique(
        np.concatenate([f.pixels.reshape(-1, 4) for f in back]), axis=0
    )
    assert len(union) <= 3

    status, ctype, data = _post(server, "/find-gif?colors=ff0000,00ff00", gif)
    assert status == 200 and ctype == "image/gif"
    assert len(iio.decode_gif_bytes(data)) == 3

    status, _, _ = _post(server, "/reduce-gif?k=3&mode=meld", gif)
    assert status == 400


def test_concurrent_requests(server, png_body):
    # Burst of parallel clients: the device lock serializes compute; every
    # request must still succeed with a correct result.
    import concurrent.futures

    def one(i):
        status, _, data = _post(server, "/reduce?k=3", png_body)
        assert status == 200
        out = decode_image_bytes(data)
        return len(np.unique(out.pixels.reshape(-1, 4), axis=0))

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        counts = list(ex.map(one, range(12)))
    assert all(c <= 3 for c in counts)


def test_deep_health(server):
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("GET", "/healthz?deep=1")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.read() == b"ok\n"
    conn.close()


def test_deep_health_unresponsive_device(monkeypatch):
    # Simulate a wedged transport: the device round-trip blocks past the
    # timeout; deep_health must report unhealthy instead of hanging.
    svc = QuantizeService.__new__(QuantizeService)
    svc._lock = threading.Lock()
    svc.processor = kt.ImageProcessor(device="cpu")

    def hang(device):
        time.sleep(5.0)
        return "ok"

    monkeypatch.setattr(serve_mod, "_device_probe", hang)
    ok, message = QuantizeService.deep_health(svc, timeout_s=0.2)
    assert ok is False
    assert "unresponsive" in message


def test_corrupt_png_with_valid_magic_is_400(server):
    body = b"\x89PNG\r\n\x1a\n" + b"garbage" * 20
    status, _, data = _post(server, "/reduce?k=3", body)
    assert status == 400
    assert b"could not decode" in data or b"invalid PNG" in data


def test_deep_param_strictness(server):
    # deep=0 / deep=false must NOT trigger the device probe path (it holds
    # the device lock); they behave as the shallow check.
    for v in ("0", "false"):
        conn = http.client.HTTPConnection(*server, timeout=30)
        conn.request("GET", f"/healthz?deep={v}")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read() == b"ok\n"
        conn.close()


def test_deep_health_lock_held_by_wedged_request():
    svc = QuantizeService.__new__(QuantizeService)
    svc._lock = threading.Lock()
    svc._lock.acquire()  # simulate a wedged request holding the device
    try:
        ok, message = QuantizeService.deep_health(svc, timeout_s=0.2)
        assert ok is False and "busy/unresponsive" in message
    finally:
        svc._lock.release()


def test_main_flags_parsing(monkeypatch):
    """main() parses every flag and wires it into the processor/server —
    driven through the real argparse, with the server stubbed out."""
    captured = {}

    class DummyServer:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_create(host, port, processor, batch_window_s, max_pending):
        captured["proc"] = processor
        captured["window"] = batch_window_s
        captured["max_pending"] = max_pending
        return DummyServer()

    monkeypatch.setattr(serve_mod, "create_server", fake_create)
    # main() installs a process-wide SIGTERM handler that calls the
    # server's shutdown(): record the install instead, so that the handler
    # of this process stays the one it had before.
    before = signal.getsignal(signal.SIGTERM)
    installed = []
    monkeypatch.setattr(signal, "signal", lambda signum, handler: installed.append(signum))
    rc = serve_mod.main([
        "--port", "0", "--fast", "--delta-e", "2000",
        "--restarts", "2", "--train-size", "128",
        "--batch-window-ms", "7.5",
    ], device="cpu")
    assert rc == 0
    p = captured["proc"]
    assert p.fast is True and p.device.type == "cpu"
    assert p.delta_e == "cie2000" and p.restarts == 2
    assert p.train_max_size == 128 and p.bucketing is True
    assert captured["window"] == 0.0075
    assert captured["max_pending"] == 64  # default reaches create_server
    assert p.pipeline is False
    # --pipeline (ROADMAP A.13, ported) reaches ImageProcessor(pipeline=True).
    assert serve_mod.main(["--port", "0", "--pipeline"], device="cpu") == 0
    p = captured["proc"]
    assert p.pipeline is True and p.bucketing is True and p.device.type == "cpu"
    assert installed == [signal.SIGTERM, signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) is before


def test_dimension_bomb_request_is_400(server):
    """A tiny GIF claiming a 65535x65535 canvas must be rejected by the
    decode budget as a clean client error — not an OOM or a 500."""
    import struct

    h = b"GIF89a" + struct.pack("<HH", 65535, 65535) + bytes([0x00, 0, 0])
    desc = b"\x2c" + struct.pack("<HHHH", 0, 0, 1, 1) + bytes([0x80])
    lct = bytes(6)
    lzw = bytes([2, 1, 0x44, 0])
    bomb = h + desc[:10] + lct + desc[10:] + lzw + b"\x3b"
    status, _ctype, body = _post(server, "/reduce-gif?k=2", bomb)
    assert status == 400, (status, body[:200])
    assert b"decode limit" in body


def test_stats_endpoint(server, png_body):
    _post(server, "/reduce?k=3", png_body)
    _post(server, "/reduce-gif?k=2", b"notagif")  # 400 -> counted as error
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/stats")
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert data["uptime_s"] >= 0
    red = data["endpoints"]["/reduce"]
    assert red["requests"] >= 1 and red["seconds_avg"] > 0
    gif = data["endpoints"]["/reduce-gif"]
    assert gif["errors"] >= 1


def test_micro_batcher_coalesces_unit():
    """_MicroBatcher: concurrent submits with one key produce one
    reduce_many launch covering all of them; results map back per-entry."""
    class FakeProcessor:
        def __init__(self):
            self.calls = []

        def reduce_many(self, images, k, mode):
            self.calls.append(len(images))
            return [f"out-{id(im)}" for im in images]

    svc = QuantizeService(processor=FakeProcessor(), batch_window_s=0.2)

    results = {}

    def worker(i):
        img = object()
        results[i] = (img, svc.batcher.reduce(img, 3, ReduceMode.REPLACE))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 5
    for img, out in results.values():
        assert out == f"out-{id(img)}"  # each caller got ITS result
    # All five coalesced into far fewer launches than requests.
    assert sum(svc.processor.calls) == 5
    assert len(svc.processor.calls) < 5
    assert svc.batcher.batched_requests == 5


def test_micro_batcher_accumulates_while_device_busy():
    """Continuous batching: requests arriving while a launch holds the
    device coalesce into ONE follow-up batch instead of fragmenting into
    single-entry launches (the pre-fix shape measured on the heavy
    full-res buckets: 24 requests -> 19 launches)."""
    release = threading.Event()
    first_started = threading.Event()

    class SlowProcessor:
        def __init__(self):
            self.calls = []

        def reduce_many(self, images, k, mode):
            self.calls.append(len(images))
            if len(self.calls) == 1:  # hold the device on the first launch
                first_started.set()
                assert release.wait(10)
            return ["out"] * len(images)

    svc = QuantizeService(processor=SlowProcessor(), batch_window_s=0.02)

    def submit():
        svc.batcher.reduce(object(), 3, ReduceMode.REPLACE)

    t0 = threading.Thread(target=submit)
    t0.start()
    assert first_started.wait(10)  # launch 1 in flight, device lock held
    laggards = [threading.Thread(target=submit) for _ in range(6)]
    for t in laggards:
        t.start()
    time.sleep(0.3)  # every laggard has joined; all windows expired
    release.set()
    t0.join(10)
    for t in laggards:
        t.join(10)
    # One solo first launch, then ONE batch holding all six laggards.
    assert svc.processor.calls == [1, 6]
    assert svc.batcher.batch_sizes == {1: 1, 6: 1}
    assert json.loads(svc.stats())["batching"]["batch_size_hist"] == {
        "1": 1, "6": 1,
    }


def test_micro_batcher_backpressure_rejects_past_max_pending():
    """Bounded backpressure (round 4): with max_pending queued-but-
    unfinished requests, the next submit raises ServiceOverloaded
    (mapped to HTTP 503 + Retry-After) instead of joining; once the
    queue drains, submits succeed again and the pending count returns
    to zero (no leaked slots)."""
    release = threading.Event()
    first_started = threading.Event()

    class SlowProcessor:
        def reduce_many(self, images, k, mode):
            first_started.set()
            assert release.wait(10)
            return ["out"] * len(images)

    svc = QuantizeService(
        processor=SlowProcessor(), batch_window_s=0.02, max_pending=2
    )
    results = []

    def submit():
        results.append(svc.batcher.reduce(object(), 3, ReduceMode.REPLACE))

    threads = [threading.Thread(target=submit) for _ in range(2)]
    for t in threads:
        t.start()
    assert first_started.wait(10)  # device held; both entries pending
    time.sleep(0.1)
    with pytest.raises(ServiceOverloaded):
        svc.batcher.reduce(object(), 3, ReduceMode.REPLACE)
    assert svc.overload_rejections == 1
    release.set()
    for t in threads:
        t.join(10)
    assert results == ["out", "out"]
    assert svc._pending_count == 0  # every slot returned
    # drained queue accepts again
    assert svc.batcher.reduce(object(), 3, ReduceMode.REPLACE) == "out"
    assert json.loads(svc.stats())["backpressure"]["overload_rejections"] == 1
    assert json.loads(svc.stats())["backpressure"]["max_pending"] == 2


def test_backpressure_covers_direct_device_paths():
    """The pending bound lives at the SERVICE level (round-4 review
    finding): non-batched device paths — CPU-algorithm /reduce, the GIF
    endpoints, and the window=0 serialized routes — must shed load with
    ServiceOverloaded too, not queue unboundedly behind the device lock
    while only batched kmeans traffic is protected."""
    release = threading.Event()
    started = threading.Event()

    class SlowProcessor:
        def find_batch(self, frames, palette, mode):
            started.set()
            assert release.wait(10)
            return frames

    svc = QuantizeService(
        processor=SlowProcessor(), batch_window_s=0.0, max_pending=1
    )
    # Occupy the single slot with a direct device-path request
    # (find_gif goes straight to the device lock, no batcher).
    palette = np.asarray([[255, 0, 0, 255]], np.uint8)
    frames = ["f0"]
    errors = []

    def gif_request():
        try:
            with svc._device_slot(), svc._lock:
                svc.processor.find_batch(frames, palette, ReduceMode.REPLACE)
        except Exception as e:  # pragma: no cover - should not happen
            errors.append(e)

    t = threading.Thread(target=gif_request)
    t.start()
    assert started.wait(10)
    # Slot taken: a batcher submit AND another direct request both shed.
    with pytest.raises(ServiceOverloaded):
        svc.batcher.reduce(object(), 3, ReduceMode.REPLACE)  # window=0 path
    with pytest.raises(ServiceOverloaded):
        with svc._device_slot():
            pass
    assert svc.overload_rejections == 2
    release.set()
    t.join(10)
    assert not errors
    assert svc._pending_count == 0


def test_micro_batcher_failed_close_never_leaves_zombie_batch():
    """If the leader's close raises BEFORE the key is removed from
    _pending (simulated: the close's lock acquire raises), the except
    path must still unregister the batch — otherwise later arrivals for
    the key join a leaderless zombie and hang until the 600 s timeout
    (round-3 ADVICE finding). The leader's own waiter gets the injected
    error; the NEXT submit must start a fresh batch and complete."""
    class FakeProcessor:
        def reduce_many(self, images, k, mode):
            return ["out"] * len(images)

    svc = QuantizeService(processor=FakeProcessor(), batch_window_s=0.01)

    class FlakyLock:
        """Raises on exactly one acquire (the leader's close), passing
        every other acquisition through to the real lock."""

        def __init__(self, inner, fail_at):
            self.inner, self.fail_at, self.n = inner, fail_at, 0
            self._count_lock = threading.Lock()

        def __enter__(self):
            with self._count_lock:
                self.n += 1
                inject = self.n == self.fail_at
            if inject:
                raise RuntimeError("injected close failure")
            return self.inner.__enter__()

        def __exit__(self, *a):
            return self.inner.__exit__(*a)

    # Acquire #1 is the submit-side join; #2 is the close inside the
    # try block — the window the ADVICE finding targets.
    svc.batcher._lock = FlakyLock(svc.batcher._lock, fail_at=2)

    with pytest.raises(RuntimeError, match="injected"):
        svc.batcher.reduce(object(), 3, ReduceMode.REPLACE)
    # The key must NOT still point at the dead leader's batch.
    assert svc.batcher._pending == {}

    # A follow-up request for the same key must complete promptly (a
    # zombie join would block on the 600 s event wait).
    out = {}

    def follow_up():
        out["v"] = svc.batcher.reduce(object(), 3, ReduceMode.REPLACE)

    t = threading.Thread(target=follow_up, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), "follow-up request hung on a zombie batch"
    assert out["v"] == "out"


def test_micro_batcher_find_coalesces_unit():
    """_MicroBatcher.find: concurrent same-(palette, mode) submits produce
    one find_many launch; different palettes stay in separate batches."""
    class FakeProcessor:
        def __init__(self):
            self.calls = []

        def find_many(self, images, palette, mode):
            self.calls.append((list(images), palette))
            return [f"out-{id(im)}" for im in images]

    svc = QuantizeService(processor=FakeProcessor(), batch_window_s=0.2)
    results = {}
    owner = {}  # id(image) -> the palette its submitter requested

    def worker(i, key):
        img = object()
        owner[id(img)] = key
        results[i] = (
            img, svc.batcher.find(img, key, ReduceMode.REPLACE, key)
        )

    threads = [
        threading.Thread(target=worker, args=(i, "aabbcc" if i < 4 else "112233"))
        for i in range(6)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 6
    for img, out in results.values():
        assert out == f"out-{id(img)}"  # each caller got ITS result
    calls = svc.processor.calls
    assert sum(len(imgs) for imgs, _ in calls) == 6
    # No cross-contamination: every launch contains only images whose
    # submitters asked for exactly that launch's palette.
    for imgs, pal in calls:
        assert all(owner[id(im)] == pal for im in imgs)
    assert sum(len(imgs) for imgs, p in calls if p == "aabbcc") == 4
    assert sum(len(imgs) for imgs, p in calls if p == "112233") == 2
    assert len(calls) < 6  # at least one real coalesced batch
    assert svc.batcher.batched_requests == 6


def test_micro_batcher_palette_coalesces_unit():
    """_MicroBatcher.palette: concurrent same-(k, algo) submits produce
    one palette_many launch; each caller gets its own palette back."""
    class FakeProcessor:
        def __init__(self):
            self.calls = []

        def palette_many(self, images, k, algo):
            self.calls.append((len(images), k, algo))
            return [f"pal-{id(im)}" for im in images]

    svc = QuantizeService(processor=FakeProcessor(), batch_window_s=0.2)
    results = {}

    def worker(i):
        img = object()
        results[i] = (img, svc.batcher.palette(img, 5, Algorithm.KMEANS))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 5
    for img, out in results.values():
        assert out == f"pal-{id(img)}"
    calls = svc.processor.calls
    assert sum(n for n, _, _ in calls) == 5
    assert len(calls) < 5
    assert all(k == 5 and a is Algorithm.KMEANS for _, k, a in calls)


def test_concurrent_palette_requests_batched(png_body):
    """End-to-end: N parallel clients on /palette coalesce into fewer
    device launches; every client gets a valid JSON palette."""
    srv = create_server(port=0, batch_window_s=0.25)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = srv.server_address
        _post(addr, "/palette?k=3", png_body)  # warm
        launches0 = srv.service.batcher.batches

        out = {}

        def client(i):
            out[i] = _post(addr, "/palette?k=3", png_body)

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        palettes = set()
        for i, (status, ctype, data) in out.items():
            assert status == 200 and ctype == "application/json", (i, status)
            pal = json.loads(data)["palette"]
            assert len(pal) == 3
            assert all(len(c) == 7 and c.startswith("#") for c in pal)
            palettes.add(tuple(pal))
        assert len(palettes) == 1  # same image -> same palette for all
        b = srv.service.batcher
        assert b.batched_requests >= 5
        assert b.batches - launches0 < 4  # at least one real batch
    finally:
        srv.shutdown()
        srv.server_close()


def test_concurrent_find_requests_batched(png_body):
    """End-to-end: N parallel clients on /find with one palette coalesce
    into fewer device launches; every client gets a correct PNG whose
    pixels all come from the requested palette."""
    srv = create_server(port=0, batch_window_s=0.25)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = srv.server_address
        path = "/find?colors=ff0000,00ff00,0000ff"
        _post(addr, path, png_body)  # warm: steady-state burst below
        launches0 = srv.service.batcher.batches

        out = {}

        def client(i):
            out[i] = _post(addr, path, png_body)

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        palette = {(255, 0, 0, 255), (0, 255, 0, 255), (0, 0, 255, 255)}
        for i, (status, ctype, data) in out.items():
            assert status == 200 and ctype == "image/png", (i, status)
            img = decode_image_bytes(data)
            assert img.dimensions == (56, 40)
            got = {tuple(px) for px in np.unique(
                img.pixels.reshape(-1, 4), axis=0)}
            assert got <= palette
        b = srv.service.batcher
        assert b.batched_requests >= 5
        assert b.batches - launches0 < 4  # at least one real batch
    finally:
        srv.shutdown()
        srv.server_close()


def test_concurrent_reduce_requests_batched(png_body):
    """End-to-end: N parallel clients on /reduce coalesce into fewer
    device launches; every client gets a correct PNG back."""
    srv = create_server(port=0, batch_window_s=0.25)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = srv.server_address
        # warm the executables so the measured burst is steady-state
        _post(addr, "/reduce?k=3", png_body)

        out = {}

        def client(i):
            out[i] = _post(addr, "/reduce?k=3", png_body)

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (status, ctype, data) in out.items():
            assert status == 200 and ctype == "image/png", (i, status)
            img = decode_image_bytes(data)
            assert img.dimensions == (56, 40)
            assert len(np.unique(img.pixels.reshape(-1, 4), axis=0)) <= 3
        b = srv.service.batcher
        assert b.batched_requests >= 5
        assert b.batches < b.batched_requests  # at least one real batch
    finally:
        srv.shutdown()
        srv.server_close()


def test_stats_unknown_paths_bounded(server, png_body):
    # Unknown POST paths must collapse into one "other" key, not grow the
    # stats dict per unique path (unbounded memory in a long-lived daemon).
    for i in range(3):
        _post(server, f"/bogus-{i}", b"x")
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/stats")
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    eps = data["endpoints"]
    assert not any(name.startswith("/bogus") for name in eps)
    assert eps["other"]["requests"] >= 3 and eps["other"]["errors"] >= 3


@pytest.fixture(scope="module")
def gif_body():
    """The reference's test_gif_endpoints GIF: 3 frames of 16x16, delays 5,
    10 and 15 cs."""
    rng = np.random.default_rng(33)
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230]], np.int32)
    frames = []
    for _ in range(3):
        idx = rng.integers(0, 3, (16, 16))
        rgb = np.clip(base[idx] + rng.integers(-9, 10, (16, 16, 3)), 0, 255)
        rgba = np.concatenate([rgb.astype(np.uint8), np.full((16, 16, 1), 255, np.uint8)], -1)
        frames.append(Image((16, 16), rgba))
    return iio.encode_gif_bytes(frames, delays=[5, 10, 15])


@pytest.mark.parametrize("method,args", [
    ("reduce", (3, "replace", "kmeans")),
    ("reduce", (3, "dither", "kmeans")),
    ("reduce", (3, "replace", "wu")),
    ("palette", (3, "kmeans")),
    ("find", ("ff0000,00ff00,0000ff", "replace")),
    ("reduce_gif", (3, "replace", "frame")),
    ("reduce_gif", (3, "replace", "global")),
    ("find_gif", ("ff0000,00ff00", "dither")),
])
def test_responses_equal_reference_service(method, args, png_body, gif_body, ref_runtime):
    """Each endpoint's response bytes (PNG, JSON or GIF) equal those of the
    reference's `QuantizeService` method on the same body, both services
    bucketed on the CPU with batching off."""
    from kmeans_tpu.serve import QuantizeService as RefService

    body = gif_body if method.endswith("gif") else png_body
    ref = RefService(kmeans_tpu.ImageProcessor(bucketing=True), batch_window_s=0)
    port = QuantizeService(kt.ImageProcessor(device="cpu", bucketing=True), batch_window_s=0)
    want = getattr(ref, method)(body, *args)
    got = getattr(port, method)(body, *args)
    assert got == want
    if method.endswith("gif"):
        frames, delays = iio.decode_gif_bytes(got, with_delays=True)
        assert len(frames) == 3 and delays == [5, 10, 15]
