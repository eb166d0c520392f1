"""The readers of the program's round-trip and feed spans (``client_s``,
``daemon_s``, ``feed_wait_s``, ``feed_stage_s``, ``h2d_s``) on standard
error made up here: the right sums, and None where the lines are missing
(a program that prints no such span) or the run is not through the
daemon."""

import pytest

from portbench import spec
from portbench.jobs import Job, Run, read_stats

STDERR = """INFO: phase targets: 0.000s
INFO: phase start_up: 0.000s
INFO: phase feed: 0.845s
INFO: Input data read done
INFO: phase segstats: 0.005s
INFO: phase write: 0.004s
INFO: phase stats+write: 0.011s
INFO: phase start_up.torch: 0.000041s
INFO: phase feed.take: 0.401200s
INFO: phase feed.stage: 0.012000s
INFO: phase feed.wait: 0.390000s
INFO: phase h2d: 0.002500s
INFO: wall=0.8700s req=1f2e-a0b1c2 reads=8000000 feed=0.85s
INFO: phase client.boot: 0.210000s
INFO: phase daemon.recv: 0.000300s
INFO: phase daemon.pre: 0.004000s
INFO: phase daemon.post: 0.001000s
INFO: phase client.drain: 0.090000s
"""
#: the same sample from a program without the spans (the parent's)
BEFORE = """INFO: phase feed: 0.845s
INFO: phase stats+write: 0.011s
INFO: wall=0.87s reads=8000000 feed=0.85s
"""
NAMES = ("client_s", "daemon_s", "feed_wait_s", "feed_stage_s", "h2d_s")


def _run(tmp_path, texts, loadgen="warm_daemon"):
    run = Run(loadgen, 8_000_000, window_start=100.0, setup_s=12.5)
    for i, text in enumerate(texts):
        job = Job(i, "window", str(tmp_path / f"j{i}" / "out"),
                  100.0 + 1.5 * i, 101.3 + 1.5 * i, 0)
        (tmp_path / f"j{i}").mkdir()
        with open(job.stderr_path, "w") as fh:
            fh.write(text)
        read_stats(job)
        run.jobs.append(job)
    return run


def test_span_readers(tmp_path):
    second = STDERR.replace("client.boot: 0.210000", "client.boot: 0.230000") \
        .replace("daemon.pre: 0.004000", "daemon.pre: 0.006000") \
        .replace("feed.wait: 0.390000", "feed.wait: 0.410000")
    run = _run(tmp_path, [STDERR, second])
    assert spec.reader("client_s")(run) == pytest.approx(0.22)
    assert spec.reader("daemon_s")(run) == \
        pytest.approx(0.0003 + 0.005 + 0.001 + 0.09)
    assert spec.reader("feed_wait_s")(run) == pytest.approx(0.40)
    assert spec.reader("feed_stage_s")(run) == pytest.approx(0.012)
    assert spec.reader("h2d_s")(run) == pytest.approx(0.0025)
    # the metrics the benchmark had read what they read before
    assert spec.reader("feed_s.warm")(run) == pytest.approx(0.845)
    assert spec.reader("write_s")(run) == pytest.approx(0.011)
    assert spec.reader("roundtrip_s")(run) == pytest.approx(1.3 - 0.87)


def test_span_readers_without_the_lines(tmp_path):
    run = _run(tmp_path, [BEFORE, BEFORE])
    for name in NAMES:
        assert spec.reader(name)(run) is None, name
    assert spec.reader("feed_s.warm")(run) == pytest.approx(0.845)


def test_daemon_s_takes_the_samples_with_all_four(tmp_path):
    cut = "".join(ln + "\n" for ln in STDERR.splitlines()
                  if "client.drain" not in ln)
    run = _run(tmp_path, [cut, STDERR.replace("client.drain: 0.090000",
                                              "client.drain: 0.190000")])
    assert spec.reader("daemon_s")(run) == \
        pytest.approx(0.0003 + 0.004 + 0.001 + 0.19)
    (tmp_path / "alone").mkdir()
    assert spec.reader("daemon_s")(_run(tmp_path / "alone", [cut])) is None


def test_span_readers_of_another_load_generator(tmp_path):
    run = _run(tmp_path, [STDERR], loadgen="other")
    for name in NAMES:
        assert spec.reader(name)(run) is None, name
