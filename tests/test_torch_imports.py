"""The port stands alone: a fresh process imports every module of
pandepth_tpu_torch (the multi-process modules of ``sharding/`` among
them) and runs its CLI on the CPU, on one device, on four rows and
through the multi-process launcher (a job of one gloo rank), with
neither ``pandepth_tpu`` (or any of its modules) nor jax in
``sys.modules``; and ``chip_smoke.py``, its set-up subprocess's source
and its worker mode included, imports nothing of pandepth_tpu, bench,
bench3gb or tests.fixtures."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import importlib, pkgutil, sys, tempfile
import pandepth_tpu_torch
from pandepth_tpu_torch import synth
from pandepth_tpu_torch.cli import main

names = [m.name for m in pkgutil.walk_packages(pandepth_tpu_torch.__path__,
                                               "pandepth_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("distributed", "launch", "mesh", "multihost"):
    assert f"pandepth_tpu_torch.sharding.{name}" in names, name
d = tempfile.mkdtemp()
synth.make_bam(d + "/t.bam", n=300, seed=5)
rc = main(["pandepth", "-i", d + "/t.bam", "-o", d + "/o"], device="cpu")
rc |= main(["pandepth", "-i", d + "/t.bam", "-o", d + "/s"],
           device=["cpu"] * 4)
from pandepth_tpu_torch.sharding.launch import main as launch
rc |= launch(["launch", "--coordinator", "file://" + d + "/store",
              "--nprocs", "1", "--rank", "0", "--device", "cpu",
              "-i", d + "/t.bam", "-o", d + "/m"])
import gzip
assert gzip.open(d + "/o.chr.stat.gz").read() == \
    gzip.open(d + "/m.chr.stat.gz").read(), "the launcher's table differs"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("pandepth_tpu", "jax", "jaxlib"))
print(len(names), bad)
sys.exit(rc or bool(bad))
"""


def test_port_imports_nothing_of_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", CODE], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules, bad = r.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_modules) >= 30 and bad == "[]"


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """Its module, its SETUP source and its worker mode (a function of the
    module, so covered by the module's imports)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "worker"
               for n in tree.body)
    setup = [n.value.value for n in ast.walk(tree)
             if isinstance(n, ast.Assign)
             and any(getattr(t, "id", "") == "SETUP" for t in n.targets)]
    assert len(setup) == 1
    names = set(_imports(tree)) | set(_imports(ast.parse(setup[0])))
    assert "pandepth_tpu_torch.synth" in names or \
        "pandepth_tpu_torch" in names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("pandepth_tpu", "bench", "bench3gb", "tests",
                           "jax"), name
