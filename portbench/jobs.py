"""One sample as one client process of the program, and what a run kept of
its samples.

Each job is ``<program> -i <bam> -o <prefix> <flags>`` in a process of
its own, its standard output and error in files beside its prefix, timed
by the host's clock from just before the spawn to its reaping. With
``PANDEPTH_VERBOSE=1`` the program prints its RunStats: ``INFO: phase
<name>: <s>s`` for each phase and ``INFO: wall=<s>s ...`` at the end,
which :func:`read_stats` takes back.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import time
from typing import Dict, List, Optional

_PHASE = re.compile(r"^INFO: phase (\S+): ([0-9.]+)s$")
_WALL = re.compile(r"^INFO: wall=([0-9.]+)s")


@dataclasses.dataclass
class Job:
    index: int
    stage: str            # "setup", "window" or "profiled"
    prefix: str
    t0: float = 0.0       # host clock (perf_counter) at the spawn
    t1: float = 0.0       # ... at the reaping
    rc: Optional[int] = None
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    stats_wall: Optional[float] = None

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def stderr_path(self) -> str:
        return self.prefix + ".stderr"

    @property
    def stdout_path(self) -> str:
        return self.prefix + ".stdout"


@dataclasses.dataclass
class Run:
    """What a load generator hands back: its jobs, the window's start
    (host clock), the set-up's seconds, and for ``warm_daemon`` the daemon's
    ``stat`` replies around the window and after a fixed number of its
    samples, the daemon's pids, and the host's readings
    (:func:`portbench.hoststat.reading`) at the window's start and after
    each of its samples."""
    loadgen: str
    reads_per_sample: int
    jobs: List[Job] = dataclasses.field(default_factory=list)
    window_start: float = 0.0
    setup_s: Optional[float] = None
    stat_before: dict = dataclasses.field(default_factory=dict)
    stat_after: dict = dataclasses.field(default_factory=dict)
    stat_rss: dict = dataclasses.field(default_factory=dict)
    host: list = dataclasses.field(default_factory=list)
    daemon_pids: set = dataclasses.field(default_factory=set)

    def stage(self, name: str) -> List[Job]:
        return [j for j in self.jobs if j.stage == name]


def run_job(job: Job, argv: List[str], env: dict, cwd: str) -> Job:
    """Run ``argv`` to its end as ``job`` and fill in its times, exit code
    and RunStats."""
    os.makedirs(os.path.dirname(job.prefix), exist_ok=True)
    with open(job.stdout_path, "wb") as out, \
            open(job.stderr_path, "wb") as err:
        job.t0 = time.perf_counter()
        proc = subprocess.Popen(argv, env=env, cwd=cwd, stdout=out,
                                stderr=err, stdin=subprocess.DEVNULL)
        try:
            job.rc = proc.wait()
        except BaseException:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            raise
        job.t1 = time.perf_counter()
    read_stats(job)
    return job


def read_stats(job: Job) -> None:
    try:
        with open(job.stderr_path, errors="replace") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return
    for line in lines:
        m = _PHASE.match(line)
        if m:
            job.phases[m.group(1)] = job.phases.get(m.group(1), 0.0) + \
                float(m.group(2))
            continue
        m = _WALL.match(line)
        if m:
            job.stats_wall = float(m.group(1))


def stderr_tail(job: Job, limit: int = 1200) -> str:
    try:
        with open(job.stderr_path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - limit))
            return fh.read().decode(errors="replace")
    except OSError:
        return "(no standard error)"


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
