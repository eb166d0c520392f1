"""The reader of the native feed's split counter (``feed_split_share``):
the mean of the program's ``feed.split`` lines over the window's samples,
and None where the samples print none (a program without the counter) or
the run is not through the daemon."""

import pytest

from portbench import spec
from portbench.tests.test_portbench_spans import BEFORE, STDERR, _run


def test_split_share_reader(tmp_path):
    one = STDERR + "INFO: phase feed.split: 1.000000s\n"
    half = STDERR + "INFO: phase feed.split: 0.500000s\n"
    assert spec.reader("feed_split_share")(_run(tmp_path, [one, half])) \
        == pytest.approx(0.75)


@pytest.mark.parametrize("texts,loadgen", [
    ([STDERR, BEFORE], "warm_daemon"),
    ([STDERR + "INFO: phase feed.split: 1.000000s\n"], "one_shot"),
])
def test_split_share_reader_finds_nothing(tmp_path, texts, loadgen):
    assert spec.reader("feed_split_share")(
        _run(tmp_path, texts, loadgen=loadgen)) is None
