"""Peak resident memory (MiB) of the daemon that ran the samples: its own
``ru_maxrss``, the ``rss_mb`` of its ``stat`` reply once the window's
``rss_after_samples``-th sample (a number of the mix) has completed, so
that a program that serves more samples in the window does not read as
one that takes more memory (after the window, where fewer completed)."""


def read(run):
    rss = run.stat_rss.get("rss_mb")
    return None if rss is None else float(rss)
