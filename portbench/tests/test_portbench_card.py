"""On a card: the literal command of BENCHMARK.json, one short run of a
cell, prints a result line with ``correct`` true. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest


@pytest.mark.card
def test_literal_command_on_the_card(card, root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        cmd = json.load(fh)["command"]
    r = subprocess.run([sys.executable, *cmd[1:], "--workload",
                        "chr_skim8m_warm", "--seed", "2147483701",
                        "--seconds", "5", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["kind"] == card
