"""The program's set-up (host clock): the daemon's spawn and first
sample plus one warm sample, or one warm-up process."""


def read(run):
    return run.setup_s
