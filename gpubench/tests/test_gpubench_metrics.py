"""The metric readers on a hand-made run: the frozen roofline counts at the
cells' shapes, the end-to-end arithmetic, the trace reduction, and the
result line's shape."""

from __future__ import annotations

import json

import pytest

from gpubench import harness, peaks
from gpubench.tests._cells import full_cell
from gpubench.trace import CALL, Trace, read_events, top

BENCH = harness.load_benchmark()


def _run(name: str, **kw) -> harness.Run:
    run = harness.Run(cell=full_cell(name))
    for key, value in kw.items():
        setattr(run, key, value)
    return run


def test_accumulator_count_at_4k_k256():
    from gpubench.metrics.accum_roofline_pct import step_bound_s, training_pixels

    cell = full_cell("photo4k-k256-full-dither")
    n = training_pixels(cell)
    assert n == 3840 * 2160
    ops = n * (9 + 18 * 256 + 8)
    assert step_bound_s(n, 256) == pytest.approx(ops / 67e12)
    assert step_bound_s(n, 256) == pytest.approx(0.573e-3, rel=1e-3)  # operations bound it
    # one step of 2.31 ms would be 24.8% of it
    run = _run("photo4k-k256-full-dither",
               trace=Trace(1e6, 5e5, 1, {"void lloyd_tile_kernel<0, 0, 0>(x)": [10, 23000.0],
                                          "sum_blocks_kernel(y)": [10, 100.0]}))
    got = harness.load_reader("accum_roofline_pct")(run)
    assert got == pytest.approx(100 * 10 * step_bound_s(n, 256) / 0.0231)


def test_accumulator_reads_nothing_without_launches():
    run = _run("gif1080p-16f-k256-dither", trace=Trace(1e6, 5e5, 1, {"assign_kernel": [1, 5.0]}))
    assert harness.load_reader("accum_roofline_pct")(run) is None


@pytest.mark.parametrize("name,pixels,frames,mode", [
    ("photo4k-k256-full-dither", 3840 * 2160, 1, "dither"),
    ("gif1080p-16f-k256-dither", 16 * 1920 * 1080, 16, "dither"),
])
def test_assign_count_at_cell_shapes(name, pixels, frames, mode):
    from gpubench.metrics.assign_roofline_pct import pass_bound_s

    ops = pixels * (33 + 9 + (4 if mode == "dither" else 0) + 18 * 256)
    bytes_moved = 3 * pixels + pixels + 1024 + frames * 12 * 256
    assert pass_bound_s(pixels, frames, 256, mode) == pytest.approx(
        max(ops / 67e12, bytes_moved / 3.35e12))
    run = _run(name, profiled_pixels=2 * pixels,
               trace=Trace(1e6, 5e5, 2, {"void assign_kernel<0, 8>(z)": [2, 20000.0]}))
    got = harness.load_reader("assign_roofline_pct")(run)
    assert got == pytest.approx(100 * 2 * pass_bound_s(pixels, frames, 256, mode) / 0.02)


def test_end_to_end_readers():
    calls = [(i % 4, 0.1 + 0.001 * i, 8294400) for i in range(100)]
    run = _run("photo4k-k256-full-dither", calls=calls, window_s=12.0,
               window_peak_bytes=3 * 2**30, setup_s=9.5)
    assert harness.load_reader("mpix_s")(run) == pytest.approx(100 * 8294400 / 12.0 / 1e6)
    assert harness.load_reader("image_ms_p90")(run) == pytest.approx(189.1, rel=1e-3)
    assert harness.load_reader("peak_device_gib")(run) == 3.0
    assert harness.load_reader("setup_s")(run) == 9.5


def test_layer_readers():
    run = _run("gif1080p-16f-k256-dither", calls=[(0, 0.1, 1)] * 4,
               phases={"host_prep": 0.04, "unpack": 0.06, "device": 1.0},
               iterations=[16, 24, 24, 32])
    assert harness.load_reader("host_ms")(run) == pytest.approx(25.0)
    assert harness.load_reader("lloyd_iterations")(run) == 24.0
    run.trace = Trace(2e6, 1.5e6, 4, {"void at::native::reduce_kernel<x>": [100, 3000.0],
                                       "void assign_kernel<0, 8>(z)": [4, 9000.0],
                                       "Memcpy HtoD (Pageable -> Device)": [4, 800.0]})
    assert harness.load_reader("aten_ms")(run) == pytest.approx(0.75)
    assert harness.load_reader("idle_pct")(run) == pytest.approx(25.0)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": CALL, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::argmax", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 70, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 20},
    ]
    t = read_events(ev)
    assert (t.window_us, t.busy_us, t.calls) == (100, 50, 1)
    assert t.device_ops == {"k1": [2, 50.0], "Memcpy DtoH": [1, 20.0]}
    assert t.idle_by_host == {"aten::argmax": 20.0, "aten::copy_": 30.0}
    assert top(t.idle_by_host, 1) == [["aten::copy_", 30e-6]]


def test_result_line_shape():
    line = harness.result_line(True, 10, 0, {"mpix_s": {"value": 1.5, "unit": "Mpix/s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 1},
                               {"pixels_differing": {"value": 0, "limit": 0}},
                               {"device_ops": [], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert json.loads(json.dumps(line)) == line
    untraced = harness.result_line(False, 1, 1, {}, {}, {})
    assert list(untraced)[-1] == "checks" and "breakdown" not in untraced


def test_peaks():
    assert peaks.bound_s(67e12, 0) == 1.0 and peaks.bound_s(0, 3.35e12) == 1.0


def test_sample_is_seeded_and_uniform():
    a, b = harness.Sample(2, 7), harness.Sample(2, 7)
    for i in range(50):
        a.offer(i % 4, [i])
        b.offer(i % 4, [i])
    assert [e[0] for e in a.kept] == [e[0] for e in b.kept] and len(a.kept) == 2
