#!/usr/bin/env python3
"""Time a fresh ``pandepth_tpu_torch`` chr process's start-up order, on
one NVIDIA GPU, on bench.py's 8M-read chr fixture
(``synth.bench_bam``, written into ``_smoke/`` or reused):

- ``overlap``: ``python -m pandepth_tpu_torch.cli -v``, as a user runs
  it: the start-up (torch, the CUDA context, the kernel library) on the
  main thread while a thread stashes the first file's encoded windows;
- ``serial``: ``chip_smoke.SERIAL``, which runs ``boot.start_up()``
  before ``cli.main``, so that nothing overlaps;
- with ``--sharded``, ``overlap_sharded`` and ``serial_sharded``: the
  same on the sharded engine (``PANDEPTH_SHARDED=1``), whose overlapped
  run decodes the stash and the rest of the stream on the host where the
  serial one takes the native ``take32`` pairs;
- with ``--parent DIR``, ``parent``: ``python -m pandepth_tpu_torch.cli
  -v`` from another checkout (``git archive`` of the parent commit,
  unpacked into a directory that ``.gitignore`` lists), on this
  checkout's ``libpancov_io``.

Usage::

    python3 tools/boot_ab.py [--rounds N] [--sharded] [--parent DIR]
                             [--out FILE]

The runs are ``chip_smoke.fresh_chr``'s. One untimed round warms every
way up (the parent's kernels build then); then each round runs the ways
in turns, the order rotating by one a round; every table must be
byte-equal to the first. Prints one line a process (its wall on the
host clock and its RunStats line), each way's median and each way's
wins against ``serial`` round by round, then one JSON line with every
wall, appended to ``--out`` if given. The port's ``libpancov_io`` is
rebuilt with zlib alone where the libdeflate it linked does not load
(as ``chip_smoke.py``'s set-up does).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 8_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("boot_ab: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import fresh_chr
    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.io import native

    kernels.library()
    try:
        native.load_library()
    except OSError as e:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", "-o", native._LIB, native._SRC,
                        "-lz", "-lpthread"], check=True)
        print(f"libpancov_io did not load ({e}); rebuilt with zlib alone",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    bam = synth.bench_bam(os.path.join(ROOT, "_smoke"), N_READS)
    ways = ["overlap", "serial"]
    if a.sharded:
        ways += ["overlap_sharded", "serial_sharded"]
    if a.parent:
        ways.append("parent")
    env = {"sharded": dict(os.environ, PANDEPTH_SHARDED="1"),
           "parent": dict(os.environ, PANDEPTH_NATIVE_BUILD=os.path.dirname(
               native._LIB))}

    def one(way: str, out: str):
        if way == "parent":
            return fresh_chr("overlap", bam, out, a.parent, env["parent"])
        base = way.removesuffix("_sharded")
        return fresh_chr(base, bam, out,
                         env=env["sharded"] if base != way else None)

    walls = {w: [] for w in ways}
    want = None
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(-1, a.rounds):
            step = k % len(ways)
            for way in ways[step:] + ways[:step]:
                wall, _, line, tab = one(way, os.path.join(tmp, way))
                want = want or tab
                if tab != want:
                    raise SystemExit(f"{way}: the table differs")
                if k >= 0:
                    walls[way].append(wall)
                print(f"{way} round {k}: {wall:.3f} s; {line}", flush=True)
    for way in ways:
        ref = "serial_sharded" if way.endswith("_sharded") else "serial"
        wins = sum(w < r for w, r in zip(walls[way], walls[ref]))
        print(f"{way}: median {statistics.median(walls[way]):.3f} s; "
              f"faster than {ref} in {wins} of {a.rounds} rounds",
              flush=True)
    got = {"card": smi.stdout.strip(), "reads": N_READS, "walls": walls}
    print(json.dumps(got), flush=True)
    if a.out:
        with open(a.out, "a") as fh:
            fh.write(json.dumps(got) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
