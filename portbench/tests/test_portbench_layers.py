"""The readers of the exon cell's layers (``targets_s``, ``segstats_s``,
``feed_read_share``, ``feed_kept_share``): the mean of the program's
lines over the window's samples, and None where the samples print none
(a program without the span or counter) or the run is not through the
daemon."""

import pytest

from portbench import spec
from portbench.tests.test_portbench_spans import BEFORE, STDERR, _run

LINES = {"targets_s": ("targets", "0.190", "0.210"),
         "segstats_s": ("segstats", "0.420", "0.440"),
         "feed_read_share": ("feed.read", "0.982000", "0.990000"),
         "feed_kept_share": ("feed.kept", "0.080000", "0.100000")}


@pytest.mark.parametrize("metric", sorted(LINES))
def test_layer_reader(tmp_path, metric):
    name, a, b = LINES[metric]
    texts = [f"INFO: phase {name}: {v}s\n" + BEFORE for v in (a, b)]
    assert spec.reader(metric)(_run(tmp_path, texts)) == \
        pytest.approx((float(a) + float(b)) / 2)


@pytest.mark.parametrize("metric", ["feed_read_share", "feed_kept_share"])
def test_counter_reader_finds_nothing(tmp_path, metric):
    """A program without the counter (the chr cell's parent) prints no
    line: nothing to read."""
    assert spec.reader(metric)(_run(tmp_path, [STDERR, BEFORE])) is None


@pytest.mark.parametrize("metric", sorted(LINES))
def test_layer_reader_one_shot(tmp_path, metric):
    name = LINES[metric][0]
    text = f"INFO: phase {name}: 0.5s\n" + BEFORE
    assert spec.reader(metric)(_run(tmp_path, [text],
                                    loadgen="one_shot")) is None
