"""The feed's host staging of encoded windows: the program's
``feed.stage`` span (``add_encoded_window``'s host work and the stacking
of each block of windows, without the copy), the mean over the window's
samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "feed.stage") if run.loadgen == "warm_daemon" \
        else None
