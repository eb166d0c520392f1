"""The reader of the native feed's inflate counter (``feed_inflate_s``):
the mean of the program's ``feed.inflate`` lines over the window's
samples, and None where the samples print none (a program without the
counter) or the run is not through the daemon."""

import pytest

from portbench import spec
from portbench.tests.test_portbench_spans import BEFORE, STDERR, _run


def test_inflate_reader(tmp_path):
    one = STDERR + "INFO: phase feed.inflate: 0.610000s\n"
    two = STDERR + "INFO: phase feed.inflate: 0.550000s\n"
    assert spec.reader("feed_inflate_s")(_run(tmp_path, [one, two])) \
        == pytest.approx(0.58)


@pytest.mark.parametrize("texts,loadgen", [
    ([STDERR, BEFORE], "warm_daemon"),
    ([STDERR + "INFO: phase feed.inflate: 0.600000s\n"], "one_shot"),
])
def test_inflate_reader_finds_nothing(tmp_path, texts, loadgen):
    assert spec.reader("feed_inflate_s")(
        _run(tmp_path, texts, loadgen=loadgen)) is None
