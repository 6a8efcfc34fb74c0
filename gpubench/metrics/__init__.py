"""One reader a metric: `metrics/<name>.py` defines `read(run) -> float |
None`, where `run` is a `gpubench.harness.Run`. None means the run holds
nothing for it to read, and the harness leaves the metric out of the line.
The harness loads each by file name (`harness.load_reader`), so a new
metric is a new file and an entry in `BENCHMARK.json`."""
