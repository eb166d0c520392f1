"""The regions' statistics on the card: the mean of RunStats' ``segstats``
phase (``segment_stats`` over every region's segments and the sum into
its rows) over the window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "segstats") if run.loadgen == "warm_daemon" \
        else None
