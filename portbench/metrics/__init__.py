"""Metric readers: ``portbench/metrics/<metric name>.py`` holds
``read(run) -> float | None`` for the metric of that name in
BENCHMARK.json. A reader that finds nothing to read returns None, and
the metric is left out of the run's line. The helpers below are shared.
"""

from portbench.jobs import mean


def window_span(run):
    """Seconds from the window's start to its last completion (host
    clock), or None when no sample of the window completed."""
    jobs = run.stage("window")
    return max(j.t1 for j in jobs) - run.window_start if jobs else None


def phase_mean(run, name):
    """The mean over the window's samples of one RunStats phase, or None
    where the samples printed none."""
    return mean(j.phases[name] for j in run.stage("window")
                if name in j.phases)
