"""The native feed's BGZF inflate: the program's ``feed.inflate`` counter
(libpancov_io's nanoseconds inside its inflate of each block, summed over
the stream's threads and read as the stream closes), the mean over the
window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.inflate") \
        if run.loadgen == "warm_daemon" else None
