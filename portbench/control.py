"""The control of a cell's comparison, at the cell's own size:

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

For each seed it puts the plain reference in the program's place with
one guarantee of the configuration broken (the FLAG filter's duplicate
bit, so duplicate reads count), judges its table as a run judges the
program's, and prints the numbers compared beside their limits, one JSON
line a seed. A comparison that could not tell it from a sound run would
print zeros. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time

from portbench import judge, spec
from portbench.inputs import cache, synth
from portbench.jobs import Job


def control_numbers(cell: spec.Cell, seed: int, cache_dir: str) -> dict:
    cfg = cell.config
    inputs = cache.ensure(cache_dir, cell.config_name, cell.config_text,
                          cfg, seed)
    want = cache.reference(cfg, seed, inputs)
    t0 = time.perf_counter()
    ctl = cache.reference_text(cfg, seed, inputs,
                               exclude=cfg["pandepth"]["exclude_flags"]
                               & ~synth.DUP_FLAG).encode()
    seconds = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        job = Job(0, "control", os.path.join(work, "out"), rc=0)
        table = cfg["pandepth"]["table"]
        with open(f"{job.prefix}.{table}.stat.gz", "wb") as fh:
            fh.write(gzip.compress(ctl))
        numbers, _ = judge.judge([job], table, want)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"workload": cell.name, "seed": seed, "control": "duplicates "
            "counted (-x without 1024)", "seconds": seconds,
            "rows": want.count(b"\n"),
            "checks": {k: {"value": v, "limit": judge.LIMITS[k]}
                       for k, v in numbers.items()},
            "failed_the_comparison": not judge.passed(numbers)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = spec.load_cell(os.getcwd(), a.workload)
    ok = True
    for seed in a.seeds:
        line = control_numbers(cell, seed,
                               os.path.join(spec.HERE, "cache"))
        ok &= line["failed_the_comparison"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
