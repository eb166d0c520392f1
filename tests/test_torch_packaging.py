"""An installed port can build what it builds at run time: every
non-Python source under ``pandepth_tpu_torch/`` (the CUDA kernels, the
native feed's C++, any header) is matched by a ``package-data`` glob of
its own package in ``pyproject.toml``, so a non-editable install ships
it."""

import fnmatch
import os
import tomllib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pandepth_tpu_torch"
SOURCES = ("*.cu", "*.cuh", "*.cpp", "*.h")


def _sources():
    for d, dirs, files in os.walk(os.path.join(ROOT, PKG)):
        dirs[:] = [x for x in dirs if not x.startswith(("_", "."))]
        for f in files:
            if any(fnmatch.fnmatch(f, g) for g in SOURCES):
                yield os.path.relpath(os.path.join(d, f), ROOT)


def _packaged(rel: str, package_data) -> bool:
    """Whether a glob of ``rel``'s package, or of a package above it
    (its globs are relative to that package's directory), matches it."""
    parts = rel.split(os.sep)
    for k in range(1, len(parts)):
        pkg = ".".join(parts[:k])
        if not os.path.exists(os.path.join(ROOT, *parts[:k],
                                           "__init__.py")):
            continue
        tail = "/".join(parts[k:])
        if any(fnmatch.fnmatch(tail, g) for g in package_data.get(pkg, [])):
            return True
    return False


def test_every_runtime_source_of_the_port_is_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    found = sorted(_sources())
    assert "pandepth_tpu_torch/csrc/sweep_kernels.cu" in found
    assert "pandepth_tpu_torch/io/native/pancov_io.cpp" in found
    missing = [f for f in found if not _packaged(f, data)]
    assert not missing, f"not in [tool.setuptools.package-data]: {missing}"
