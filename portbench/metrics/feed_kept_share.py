"""The share of the records the native feed decoded that its filters kept:
the program's ``feed.kept`` counter (libpancov_io's records that passed
``-x``, ``-q`` and the region filter, over the records its walk decoded),
the mean over the window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.kept") if run.loadgen == "warm_daemon" \
        else None
