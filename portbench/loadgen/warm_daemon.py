"""A campaign of samples through the program's resident daemon.

Each sample is a fresh client process (``PANDEPTH_DAEMON=1``,
``PANDEPTH_DAEMON_REQUIRE=1``: a daemon that cannot be reached fails the
sample) that ships its run to the daemon over the run's own socket.
Set-up is the first client, which spawns the daemon (``import torch``,
the CUDA context, the kernel library: compiled on a checkout's first
run) and runs a sample, and one warm sample more. The daemon's ``stat``
is read before and after the window (its pid and its count of kernel
library calls) and once the window's ``rss_after_samples``-th sample has
completed (its peak resident memory; after the window where fewer
completed), and the host's readings (``hoststat``) at the window's start
and after each of its samples. A traced run prints RunStats in its
set-up and window, and adds the mix's ``profiled_samples`` after the
window with the program's profiler on. The daemon is stopped, and
waited for, whatever happens.
"""

from __future__ import annotations

import time

from portbench import daemon, hoststat
from portbench.loadgen import Context, profiled, verbose, window
from portbench.jobs import Run


def drive(ctx: Context) -> Run:
    t = ctx.traffic
    sock = daemon.sock_path(ctx.workdir)
    env = dict(ctx.env, PANDEPTH_DAEMON="1", PANDEPTH_DAEMON_REQUIRE="1",
               PANDEPTH_DAEMON_SOCK=sock,
               PANDEPTH_DAEMON_IDLE_S=str(t["daemon_idle_s"]))
    run = Run("warm_daemon", ctx.reads_per_sample)
    pids = set()
    rss_at = int(t["rss_after_samples"])

    def after(n: int) -> None:
        run.host.append(hoststat.reading(run.stat_before.get("pid")))
        if n == rss_at:
            run.stat_rss = daemon.stat(sock, ctx.workdir)

    try:
        senv = verbose(env) if ctx.trace else env
        t0 = time.perf_counter()
        for _ in range(2):
            run.jobs.append(ctx.job("setup", senv))
            if run.jobs[-1].rc != 0:
                return run
        run.setup_s = time.perf_counter() - t0
        run.stat_before = daemon.stat(sock, ctx.workdir)
        pids.add(run.stat_before.get("pid"))
        wenv = verbose(env) if ctx.trace else env
        run.host.append(hoststat.reading(run.stat_before.get("pid")))
        run.window_start, done = window(ctx, wenv, after)
        run.jobs += done
        run.stat_after = daemon.stat(sock, ctx.workdir)
        pids.add(run.stat_after.get("pid"))
        if not run.stat_rss:  # a window shorter than the mix's
            run.stat_rss = run.stat_after
        if ctx.trace:
            penv = profiled(env, ctx)
            for _ in range(int(t["profiled_samples"])):
                run.jobs.append(ctx.job("profiled", penv))
        return run
    finally:
        pids.add(daemon.stat(sock, ctx.workdir, timeout=5.0).get("pid"))
        run.daemon_pids = {p for p in pids if p}
        daemon.stop(ctx.program, env, ctx.workdir, run.daemon_pids)
