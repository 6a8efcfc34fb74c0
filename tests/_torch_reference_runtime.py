"""The reference's native runtime, built for the port's tests.

`kmeans_tpu/runtime/_imagio.c` is the JAX package's CPython extension
(libpng, libjpeg, GIF, the unpacks and the alpha strip). It is not built in
the tree, so the reference runs its fallbacks. The port's tests that hold
the port's runtime to it compile it here, with the flags of `setup.py`,
into pytest's temporary directory (never into `kmeans_tpu/runtime/`, where
the reference's own tests would find it), load it with
`importlib.machinery.ExtensionFileLoader`, and put it into the reference's
modules with `monkeypatch` for the tests that need it. No file of the JAX
package changes.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import subprocess
import sysconfig
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "kmeans_tpu" / "runtime" / "_imagio.c"

_built: dict = {}


def build_reference_runtime(tmp_path_factory):
    """The reference extension module, compiled once per process."""
    if "module" not in _built:
        out = tmp_path_factory.mktemp("ref_imagio") / (
            "_imagio" + sysconfig.get_config_var("EXT_SUFFIX"))
        cmd = ["cc", "-O2", "-fPIC", "-shared", f"-I{sysconfig.get_paths()['include']}",
               "-o", str(out), str(SOURCE), "-lpng", "-ljpeg", "-lz"]
        done = subprocess.run(cmd, capture_output=True, text=True)
        assert done.returncode == 0, done.stderr
        loader = importlib.machinery.ExtensionFileLoader("kmeans_tpu.runtime._imagio", str(out))
        spec = importlib.util.spec_from_file_location(loader.name, str(out), loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        _built["module"] = module
    return _built["module"]


def inject(mp: pytest.MonkeyPatch, module) -> None:
    """Run the reference with its runtime, as a tree built with
    `python setup.py build_ext` does: its codec, unpacks and strip."""
    from kmeans_tpu import api as ref_api
    from kmeans_tpu.utils import imageio as ref_imageio
    from kmeans_tpu.utils import packing as ref_packing

    mp.setattr(ref_imageio, "_imagio", module)
    mp.setattr(ref_imageio, "HAVE_NATIVE", True)
    mp.setattr(ref_packing, "_native", module)
    mp.setattr(ref_api, "_native", module)


@pytest.fixture
def ref_runtime(tmp_path_factory, monkeypatch):
    """The reference extension (built once a process), put into the
    reference's modules for the test."""
    module = build_reference_runtime(tmp_path_factory)
    inject(monkeypatch, module)
    return module
