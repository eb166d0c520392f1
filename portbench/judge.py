"""Whether every job wrote the table that the reference wrote.

Each job ran in a directory of its own, so a table at its prefix is its
own. A job fails when it exits non-zero or leaves no readable gzip
table; a table is wrong when its decompressed bytes differ from the
reference's. The numbers compared, each with the limit 0 (an exact
comparison): ``jobs_failed``, ``tables_wrong`` and ``rows_wrong`` (lines
that differ, or that one side lacks, summed over the tables).
"""

from __future__ import annotations

import gzip
import zlib
from typing import Dict, List, Tuple

from portbench.jobs import Job, stderr_tail

LIMITS = {"jobs_failed": 0, "tables_wrong": 0, "rows_wrong": 0}


def rows_differing(got: bytes, want: bytes) -> int:
    a, b = got.split(b"\n"), want.split(b"\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def judge(jobs: List[Job], table: str, want: bytes
          ) -> Tuple[Dict[str, int], List[str]]:
    """(numbers, notes): the numbers compared, and a line for each job
    at fault, with the tail of its standard error."""
    n = {k: 0 for k in LIMITS}
    notes = []
    for job in jobs:
        path = f"{job.prefix}.{table}.stat.gz"
        if job.rc != 0:
            n["jobs_failed"] += 1
            notes.append(f"job {job.index} ({job.stage}) exited "
                         f"{job.rc}: {stderr_tail(job)}")
            continue
        try:
            with gzip.open(path, "rb") as fh:
                got = fh.read()
        except (OSError, EOFError, zlib.error) as e:
            n["jobs_failed"] += 1
            notes.append(f"job {job.index} ({job.stage}) left no readable "
                         f"table {path}: {e}; {stderr_tail(job)}")
            continue
        if got != want:
            n["tables_wrong"] += 1
            rows = rows_differing(got, want)
            n["rows_wrong"] += rows
            notes.append(f"job {job.index} ({job.stage}): {rows} rows "
                         f"differ from the reference's")
    return n, notes


def passed(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
