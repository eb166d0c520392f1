"""The share of the BAM's compressed bytes that the native feed's walk
consumed: the program's ``feed.read`` counter (libpancov_io's bytes walked,
or read past a range's end and dropped, over the file's size; 1.0 for a
whole-file stream), the mean over the window's samples through the
daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.read") if run.loadgen == "warm_daemon" \
        else None
