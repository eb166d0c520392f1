"""Stats and writers (the finalize on the card, the tables' formatting
and gzip): the mean of RunStats' ``stats+write`` phase over the window's
samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "stats+write") if run.loadgen == "warm_daemon" \
        else None
