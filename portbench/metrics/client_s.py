"""The client's side of a sample's round trip through the daemon: the
program's ``client.boot`` span (from the client process's start, to a
clock tick, through its imports, token and connect until its request is
sent), the mean over the window's samples."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "client.boot") if run.loadgen == "warm_daemon" \
        else None
