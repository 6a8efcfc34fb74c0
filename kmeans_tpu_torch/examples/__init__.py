"""The JAX package's examples (`examples/*.py`) on the port: each one
makes its original's calls on `kmeans_tpu_torch` and runs as `python -m
kmeans_tpu_torch.examples.<name> [args]`, on the card unless `--cpu` is
given. Each has a `main(argv=None)` that returns an exit code."""
