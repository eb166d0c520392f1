"""The window's accounting, the readers of every metric, the judge and the
trace's reader, on runs made up here."""

import gzip
import json

import pytest

from portbench import judge, spec, trace
from portbench.jobs import Job, Run, read_stats

STDERR = """INFO: Input data read done
INFO: phase targets: 0.012s
INFO: phase start_up: 7.101s
INFO: phase feed: 0.845s
INFO: phase segstats: 0.020s
INFO: phase write: 0.030s
INFO: phase stats+write: 0.061s
INFO: wall=8.10s reads=8000000 reads/s=987654 stashed=3 engine_at=7.50s feed=0.85s
"""


def _job(tmp_path, i, stage, t0, t1, rc=0, text=STDERR):
    job = Job(i, stage, str(tmp_path / f"j{i}" / "out"), t0, t1, rc)
    (tmp_path / f"j{i}").mkdir()
    with open(job.stderr_path, "w") as fh:
        fh.write(text)
    read_stats(job)
    return job


def _run(tmp_path, loadgen):
    run = Run(loadgen, 8_000_000, window_start=100.0, setup_s=12.5)
    run.jobs = [_job(tmp_path, 0, "setup", 80.0, 92.0)]
    run.jobs += [_job(tmp_path, i + 1, "window", 100.0 + 2 * i,
                      101.5 + 2 * i) for i in range(5)]
    run.stat_before = {"pid": 7, "rss_mb": 4000.0,
                       "launches": {"sort_pairs": 10, "k": 3}}
    run.stat_rss = {"pid": 7, "rss_mb": 5120.0,
                    "launches": {"sort_pairs": 22, "k": 6}}
    run.stat_after = {"pid": 7, "rss_mb": 5300.0,
                      "launches": {"sort_pairs": 30, "k": 8}}
    return run


def test_runstats_lines(tmp_path):
    job = _job(tmp_path, 0, "window", 0.0, 8.3)
    assert job.phases["start_up"] == pytest.approx(7.101)
    assert job.phases["stats+write"] == pytest.approx(0.061)
    assert job.stats_wall == pytest.approx(8.10)


def test_warm_readers(tmp_path):
    run = _run(tmp_path, "warm_daemon")
    # last completion at 109.5: 5 samples of 8M reads in 9.5 s
    assert spec.reader("reads_per_s")(run) == pytest.approx(40e6 / 9.5)
    # the reading after the mix's fixed number of samples, not the last
    assert spec.reader("peak_rss_mib")(run) == 5120.0
    assert spec.reader("setup_s")(run) == 12.5
    assert spec.reader("feed_s.warm")(run) == pytest.approx(0.845)
    assert spec.reader("targets_s")(run) == pytest.approx(0.012)
    assert spec.reader("write_s")(run) == pytest.approx(0.061)
    assert spec.reader("roundtrip_s")(run) == pytest.approx(1.5 - 8.10)
    assert spec.reader("wrapper_calls_per_sample")(run) == 25 / 5


def test_readers_of_another_load_generator(tmp_path):
    run = _run(tmp_path, "other")
    run.stat_rss = {}
    for name in ("peak_rss_mib", "feed_s.warm", "targets_s", "write_s",
                 "roundtrip_s", "wrapper_calls_per_sample"):
        assert spec.reader(name)(run) is None, name


def test_readers_find_nothing_in_an_empty_window(tmp_path):
    run = Run("warm_daemon", 8_000_000, window_start=1.0, setup_s=3.0)
    for name in ("reads_per_s", "feed_s.warm", "peak_rss_mib",
                 "roundtrip_s", "wrapper_calls_per_sample"):
        assert spec.reader(name)(run) is None


def _table(job, text):
    with gzip.open(job.prefix + ".chr.stat.gz", "wb") as fh:
        fh.write(text)


def test_judge_counts(tmp_path):
    want = b"#h\nchr1\t5\t1\nchr2\t6\t2\n##f\n"
    jobs = [_job(tmp_path, i, "window", 0, 1) for i in range(5)]
    _table(jobs[0], want)
    _table(jobs[1], want.replace(b"\t6\t", b"\t7\t"))
    jobs[2].rc = 1
    # jobs[3] wrote nothing
    with open(jobs[4].prefix + ".chr.stat.gz", "wb") as fh:
        fh.write(b"not gzip")
    n, notes = judge.judge(jobs, "chr", want)
    assert n == {"jobs_failed": 3, "tables_wrong": 1, "rows_wrong": 1}
    assert len(notes) == 4 and not judge.passed(n)
    n, _ = judge.judge(jobs[:1], "chr", want)
    assert judge.passed(n)


def test_trace_reader(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "sort_pass", "ts": 100,
         "dur": 200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 250,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "sweep_scan", "ts": 600,
         "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "x", "ts": 0,
         "dur": 1000},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    busy, window, bd = trace.read([str(p)], 1, 2.0, {"feed": 0.5})
    assert busy == pytest.approx(300e-6)   # [100, 350) and [600, 650)
    assert window == 2.0
    ops = dict(bd["device_ops"])
    assert ops["sort_pass"] == pytest.approx(200e-6)
    gaps = dict(bd["idle_gaps"])
    assert gaps["host:feed"] == 0.5
    assert gaps["trace:aten::sort"] == pytest.approx(700e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    p.write_text(json.dumps({"traceEvents": ev[:1]}))
    assert trace.read([str(p)], 1, 1.0, {}) is None


def test_host_readings():
    import os

    from portbench import hoststat

    user, system, steal = hoststat.reading(os.getpid())
    assert user is not None and user > 0 and system >= 0
    assert steal is None or steal >= 0
    assert len(hoststat.NAMES) == 3
    assert hoststat.process_cpu_s(None) == (None, None)
    assert hoststat.process_cpu_s(2**22 + 12345) == (None, None)
