"""Calls to the kernel library a sample: the change over the window in
the daemon's ``stat`` count ``launches``, over the window's samples.
That count goes up by one each time a Python wrapper of
``device/kernels.py`` is called, not each time a kernel starts: one
call of ``sort_pairs`` launches a memset, a histogram and four to eight
passes. So a change inside one wrapper does not move it."""

from portbench import daemon


def read(run):
    n = len(run.stage("window"))
    if run.loadgen != "warm_daemon" or not n or not run.stat_after:
        return None
    return (daemon.launches(run.stat_after)
            - daemon.launches(run.stat_before)) / n
