"""The share of the native feed's records walked in index-cut splits: the
program's ``feed.split`` counter (libpancov_io's records handed out from
splits that ended on their cut, over the stream's records), the mean over
the window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.split") if run.loadgen == "warm_daemon" \
        else None
