"""The daemon's side of a sample's round trip: the program's spans
``daemon.recv`` (the accept until the request is decoded), ``daemon.pre``
(until the run's RunStats starts), ``daemon.post`` (its end until the
reply is ready) and ``client.drain`` (the reply's first bytes until the
daemon closes the connection, after its garbage collection), summed; the
mean over the window's samples that printed all four."""

from portbench.jobs import mean

SPANS = ("daemon.recv", "daemon.pre", "daemon.post", "client.drain")


def read(run):
    if run.loadgen != "warm_daemon":
        return None
    return mean(sum(j.phases[k] for k in SPANS) for j in run.stage("window")
                if all(k in j.phases for k in SPANS))
