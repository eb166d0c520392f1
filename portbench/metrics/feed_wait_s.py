"""The native feed's calling thread waiting on its producer thread: the
program's ``feed.wait`` counter (libpancov_io's nanoseconds blocked on the
stream's queue, read as the stream closes), the mean over the window's
samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.wait") if run.loadgen == "warm_daemon" \
        else None
