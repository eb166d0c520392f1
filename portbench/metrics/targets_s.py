"""The targets layer (GFF parse and the merge of its lines into genes;
chromosome mode's default tiling): the mean of RunStats' ``targets``
phase over the window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "targets") if run.loadgen == "warm_daemon" \
        else None
