"""The command as a benchmark check runs it: its argument forms, and
what it does where there is no card or no program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run


@pytest.mark.parametrize("argv", [
    ["--workload", "chr_skim8m_warm", "--seed", "3", "--seconds", "10",
     "--trace", "0"],
    ["--trace", "1", "--seconds", "10", "--seed", "3", "--workload",
     "chr_skim8m_warm"],
    ["--workload=chr_skim8m_warm", "--seed=2147483659", "--seconds=30",
     "--trace=1"],
])
def test_check_argument_forms(argv):
    a = run.parse_args(argv)
    assert a.trace in (0, 1) and isinstance(a.trace, int)
    assert isinstance(a.seconds, int) and a.seconds in (10, 30)
    assert a.seed in (3, 2147483659)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, 2**31 + 5, 2**33 + 1,
                                  2**64 + 7])
def test_large_seeds_are_taken(seed):
    assert run.parse_args(["--workload", "w", "--seed", str(seed),
                           "--seconds", "10", "--trace", "0"]).seed == seed


@pytest.mark.parametrize("bad", [
    ["--workload", "w", "--seed", "3", "--seconds", "10", "--trace", "2"],
    ["--workload", "w", "--seed", "3", "--seconds", "10"],
    ["--workload", "w", "--seed", "x", "--seconds", "10", "--trace", "0"],
])
def test_refused_arguments_exit_64_not_2(bad, capsys):
    with pytest.raises(SystemExit) as e:
        run.parse_args(bad)
    assert e.value.code == run.EXIT_USAGE != 2
    assert "portbench:" in capsys.readouterr().err


def _command(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)["command"]


def _literal(root, cwd, workload="chr_skim8m_warm"):
    cmd = _command(root)
    if cmd[0] in ("python3", "python"):
        cmd = [sys.executable, *cmd[1:]]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    return subprocess.run(
        cmd + ["--workload", workload, "--seed", "3", "--seconds", "10",
               "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_literal_command_without_a_card(root):
    """From the checkout's root, with no card: the harness's own message,
    no result line, and an exit code that is neither 0 nor 2."""
    r = _literal(root, root)
    assert r.returncode not in (0, 2), r.stderr
    assert "portbench: no CUDA device" in r.stderr
    assert '"correct"' not in r.stdout


def test_command_names_only_files_under_paths(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    assert os.path.exists(os.path.join(root, "portbench", "run.py"))


def test_without_the_program_no_result(root, tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths``: no result, and a non-zero exit."""
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = _literal(root, str(tmp_path))
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
