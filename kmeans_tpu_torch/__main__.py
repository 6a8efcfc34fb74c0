"""`python -m kmeans_tpu_torch` is the port's command line (`cli.py`)."""

import sys

from kmeans_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
