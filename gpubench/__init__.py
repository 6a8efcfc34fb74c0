"""The benchmark of `kmeans_tpu_torch` on CUDA (`python3 -m gpubench.run`);
see `gpubench/README.md`."""
