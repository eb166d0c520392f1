"""What the launcher and the daemon add to a sample: the client
process's wall (host clock) less the RunStats ``wall`` of the same run,
the mean over the window's samples."""

from portbench.jobs import mean


def read(run):
    if run.loadgen != "warm_daemon":
        return None
    jobs = [j for j in run.stage("window") if j.stats_wall is not None]
    return mean(j.wall - j.stats_wall for j in jobs)
