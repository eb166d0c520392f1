"""Host-to-device copies: the program's ``h2d`` span (the host's seconds
inside the engine's copies from pageable memory, which return once the
copy is done), the mean over the window's samples through the daemon."""

from portbench.metrics import phase_mean


def read(run):
    return phase_mean(run, "h2d") if run.loadgen == "warm_daemon" else None
