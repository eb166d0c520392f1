"""The native feed of a sample through the daemon: the mean of RunStats'
``feed`` phase over the window's samples."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed") if run.loadgen == "warm_daemon" else None
