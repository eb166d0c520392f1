"""Reads of every sample completed in the window over the seconds from
the window's start to the last completion (host clock); the sample in
flight when the window closed counts."""

from portbench.metrics import window_span


def read(run):
    span = window_span(run)
    return None if span is None else \
        len(run.stage("window")) * run.reads_per_sample / span
