"""Tiny copies of the benchmark's cells that a CPU test run can hold: the
same configuration, traffic and limits files, with the image shrunk and
the colour count cut. `gif1080p-16f-k256-dither` is parked (its files stay
in `gpubench/`, its workload entry is not in `BENCHMARK.json`); its tiny
copy still exercises the frames path of the reference and the program."""

from __future__ import annotations

from gpubench import harness

# workload -> (config, traffic, image overrides, traffic overrides)
TINY = {
    "photo4k-k256-full-dither": ("photo-4k-cie94", "reduce-k256-dither-full",
                                 {"width": 160, "height": 96}, {"colors": 16}),
    "gif1080p-16f-k256-dither": ("gif-1080p-16f-cie94", "frames16-k256-dither-shrunk",
                                 {"width": 64, "height": 40, "frames": 4},
                                 {"colors": 8, "processor": {"train_max_size": 32}}),
}


def full_cell(name: str) -> harness.Cell:
    config, traffic, _, _ = TINY[name]
    return harness.Cell(name, 1, harness.load_config(config), harness.load_traffic(traffic),
                        harness.load_limits(name))


def tiny_cell(name: str) -> harness.Cell:
    cell = full_cell(name)
    _, _, image, traffic = TINY[name]
    cell.config = {**cell.config, "image": {**cell.config["image"], **image}}
    cell.traffic = {**cell.traffic, **traffic}
    return cell
