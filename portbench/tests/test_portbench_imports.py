"""No process of a run imports JAX or the JAX package: the harness's
process (every module of it), and the program's modules that a run
loads. Top-level names are compared whole, since the program's name
begins with the JAX package's."""

import subprocess
import sys

import pytest

FORBIDDEN = ("jax", "jaxlib", "flax", "pandepth_tpu")

HARNESS = ("import portbench.run, portbench.spec, portbench.judge, "
           "portbench.trace, portbench.nvml, portbench.daemon, "
           "portbench.loadgen.warm_daemon, "
           "portbench.inputs.cache; from portbench import spec; "
           "import json; b = json.load(open('BENCHMARK.json')); "
           "[spec.reader(m['name']) for m in b['end_to_end'] + "
           "b['per_layer']]")
PROGRAM = ("import pandepth_tpu_torch.boot, pandepth_tpu_torch.serve, "
           "pandepth_tpu_torch.cli, pandepth_tpu_torch.run, "
           "pandepth_tpu_torch.feed, pandepth_tpu_torch.stats.tables")


@pytest.mark.parametrize("code", [HARNESS, PROGRAM],
                         ids=["harness", "program"])
def test_no_jax_in_a_fresh_process(root, code):
    check = (f"{code}; import sys; bad = sorted(m for m in sys.modules if "
             f"m.split('.')[0] in {FORBIDDEN!r}); print(bad); "
             f"sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", check], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "pandepth_tpu_torch_x", sys)
    assert "pandepth_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()
