"""Load generators: one module a kind of traffic, named by a mix's
``loadgen``; each has ``drive(ctx) -> jobs.Run``.

:class:`Context` is what a load generator gets: how to start the
program on one sample, the environment and directory of its processes,
the window's length and whether this run is traced.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

from portbench.jobs import Job, run_job


@dataclasses.dataclass
class Context:
    program: List[str]  # [python, -m, pandepth_tpu_torch]
    sample_args: Callable[[str], List[str]]  # prefix -> -i ... -o prefix
    env: dict
    workdir: str
    seconds: float
    trace: bool
    traffic: dict
    reads_per_sample: int
    profile_dir: str
    _n: int = 0

    def job(self, stage: str, env: dict = None) -> Job:
        """Run the next sample to its end as a ``stage`` job."""
        prefix = os.path.join(self.workdir, "jobs", f"j{self._n:05d}",
                              "out")
        job = Job(self._n, stage, prefix)
        self._n += 1
        return run_job(job, [*self.program, *self.sample_args(prefix)],
                       env or self.env, self.workdir)


def window(ctx: Context, env: dict,
           after: Optional[Callable[[int], None]] = None
           ) -> Tuple[float, List[Job]]:
    """(the window's start, its jobs): samples back to back, one client,
    closed loop; a new sample starts while the window is open, and the
    one in flight when it closes runs to its end and counts. ``after(n)``
    is called once the window's ``n``-th sample has completed."""
    if int(ctx.traffic.get("clients", 1)) != 1:
        raise ValueError("the load generators run one client; a mix of "
                         "several needs one that runs them")
    start = time.perf_counter()
    deadline = start + ctx.seconds
    done = []
    while time.perf_counter() < deadline:
        done.append(ctx.job("window", env))
        if after is not None:
            after(len(done))
    return start, done


def verbose(env: dict) -> dict:
    """``env`` with the program's RunStats lines switched on."""
    return dict(env, PANDEPTH_VERBOSE="1")


def profiled(env: dict, ctx: Context) -> dict:
    """``env`` with RunStats and the program's profiler hook on."""
    return dict(verbose(env), PANDEPTH_PROFILE=ctx.profile_dir)
