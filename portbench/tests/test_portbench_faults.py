"""Whole runs of the harness on the CPU, the look for a card skipped:
with the program (the port on the CPU, through its daemon) ``correct``
comes out true and the result line has its keys; with a fault planted under the timed path it comes out false,
once for each fault that these cells can have (their runs hold no
exchange between chips)."""

import os

import pytest

from portbench import daemon, run
from portbench.tests.small import CPU_ENV, faulty, small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(root, tmp_path, config, program, traced=False, seconds=1):
    return run.run_cell(small_cell(root, config), 2**31 + 9, seconds, traced,
                        root, program=program, extra_env=CPU_ENV,
                        cache_dir=str(tmp_path / "cache"))


@pytest.mark.parametrize("config,traced", [
    ("capsicum_chr", False), ("capsicum_exon", True),
    ("capsicum_chr", True)])
def test_sound_run(root, tmp_path, config, traced):
    res = _run(root, tmp_path, config, faulty("none"), traced)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    cell = run.spec.load_cell(root, "chr_skim8m_warm")
    names = {m.name for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not traced:
        assert "setup_s" in res["metrics"]
        assert len(res["metrics"]) == len(names)
    for c in res["checks"].values():
        assert c == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "exit"])
@pytest.mark.parametrize("config", ["capsicum_chr", "capsicum_exon"])
def test_fault_is_caught(root, tmp_path, config, fault):
    res = _run(root, tmp_path, config, faulty(fault))
    if fault == "exit":  # the set-up's own samples fail: no result at all
        assert res is None
        return
    assert res["correct"] is False and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_no_process_is_left(root, tmp_path, monkeypatch):
    """The daemon, which detaches from the harness, has ended when the run
    returns, and the run's directory is gone."""
    stopped = []
    stop = daemon.stop

    def watched(program, env, workdir, pids, **kw):
        stopped.extend(pids)
        return stop(program, env, workdir, pids, **kw)

    monkeypatch.setattr(daemon, "stop", watched)
    _run(root, tmp_path, "capsicum_chr", faulty("none"))
    assert stopped
    assert all(daemon._state(p) in ("", "Z") for p in stopped)
    assert not [d for d in os.listdir(tmp_path) if d.startswith("portbench-")]
