"""The port's start-up overlap on the CPU (``pandepth_tpu_torch.boot``'s
``start_up`` and ``run.prepare``'s pre-engine stash): importing the CLI,
the run and the feed loads no torch, and neither does the launcher's
argument parsing; ``cli.main`` with no device starts the first file's
native loader and a stashing thread before the start-up, which runs on
the calling thread, and makes the engine after both; a stash of k
encoded windows (k = 1, 3, and more than the file holds, the stash held
"not ready" for k pulls) gives tables byte-equal to ``pandepth_tpu.cli``'s
in chr, ``-b`` and ``-w 1500`` mode on one device and on 8 rows of the
sharded engine (which decodes the stash on the host), and RunStats
counts k; an explicit device, a start-up already done or an empty stash
leaves the stream to the engine's own feed; a failed start-up exits 1
with its error, writes no table and leaves no thread behind; and fresh
processes that fail early (a missing input, no GPU, a bad flag) exit
promptly with their messages."""

import itertools
import os
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

from pandepth_tpu.cli import main as jax_main
from tests.fixtures import gunzip_bytes, make_bam, make_bed

import pandepth_tpu_torch.run as port_run
from pandepth_tpu_torch import boot
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.cli import parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
# windows of 400 slots: the fixture's 4,065 pairs fill ten of them and
# leave an eleventh less than half full, which the engine decodes on the
# host
SMALL_ENC = {"PANDEPTH_ENC": "1", "PANDEPTH_ENC_CAP": "400",
             "PANDEPTH_ENC_EXC": "256"}
REAL_STASH = port_run._stash
MODES = {"chr": ([], "chr"), "bed": (["-b", "{bed}"], "bed"),
         "win": (["-w", "1500"], "win")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("boot")
    paths = {"bam": str(d / "t.bam"), "bed": str(d / "t.bed"), "dir": d}
    make_bam(paths["bam"], n=3000, seed=21)
    make_bed(paths["bed"])
    return paths


@pytest.fixture
def small_enc(monkeypatch):
    for k, v in SMALL_ENC.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def jax_tables(inputs, tmp_path_factory):
    """pandepth_tpu.cli's table per mode, at the same encoded windows."""
    cache = {}

    def get(mode):
        if mode not in cache:
            extra, table = MODES[mode]
            out = str(tmp_path_factory.mktemp("jax") / "j")
            with pytest.MonkeyPatch.context() as mp:
                for k, v in SMALL_ENC.items():
                    mp.setenv(k, v)
                assert jax_main(["pandepth", "-i", inputs["bam"],
                                 *(a.format(**inputs) for a in extra),
                                 "-o", out]) == 0
            cache[mode] = gunzip_bytes(f"{out}.{table}.stat.gz")
        return cache[mode]

    return get


def _not_ready_for(monkeypatch, k: int) -> None:
    """The stash pulls k windows (or the whole stream, if shorter),
    whatever the start-up does meanwhile: its ``ready`` reports "not
    ready" to its first k checks."""
    def held(puller, ready):
        calls = itertools.count()
        return REAL_STASH(puller, lambda: next(calls) >= k)

    monkeypatch.setattr(port_run, "_stash", held)


def _fresh(monkeypatch, devices) -> None:
    """This process has not started up yet, and its start-up (torch is
    imported already) decides ``devices``."""
    monkeypatch.setattr(boot, "_started", False)
    monkeypatch.setattr(boot, "_init_and_touch",
                        lambda: [torch.device(d) for d in devices])


def _engines(monkeypatch) -> list:
    made = []
    real = port_run.make_engine

    def make(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(port_run, "make_engine", make)
    return made


def _stash_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "pandepth-torch-stash"]


def _run(inputs, tmp_path, mode, device, capsys):
    """The port's table in ``mode`` on ``device`` with -v, and the windows
    RunStats reports stashed."""
    extra, table = MODES[mode]
    out = str(tmp_path / "p")
    capsys.readouterr()
    assert port_main(["pandepth", "-i", inputs["bam"],
                      *(a.format(**inputs) for a in extra), "-o", out,
                      "-v"], device=device) == 0
    err = capsys.readouterr().err
    stashed = int(re.search(r"stashed=(\d+)", err).group(1))
    return gunzip_bytes(f"{out}.{table}.stat.gz"), stashed


def test_cli_run_and_feed_import_no_torch():
    code = ("import sys\n"
            "import pandepth_tpu_torch.cli, pandepth_tpu_torch.run, "
            "pandepth_tpu_torch.feed, pandepth_tpu_torch.boot\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'torch'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("device", ["cpu", "rows8"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [1, 3, 1000])
def test_stash_matches_jax(inputs, jax_tables, tmp_path, capsys,
                           monkeypatch, small_enc, k, mode, device):
    made = _engines(monkeypatch)
    devices = ["cpu"] * 8 if device == "rows8" else ["cpu"]
    _fresh(monkeypatch, devices)
    _not_ready_for(monkeypatch, 1000)
    _, every = _run(inputs, tmp_path, mode, None, capsys)
    _fresh(monkeypatch, devices)
    _not_ready_for(monkeypatch, k)
    got, stashed = _run(inputs, tmp_path, mode, None, capsys)
    assert every > 3, "the fixture fills more windows than the stash takes"
    assert stashed == min(k, every)
    assert got == jax_tables(mode)
    assert [len(e.devices) if device == "rows8" else 1 for e in made] \
        == [len(devices)] * 2
    if device == "cpu":
        # every window of the stream, stashed or not, went through
        # add_encoded_window; the whole file's last, less than half full,
        # was decoded on the host there (-b's fetch windows keep fewer
        # pairs)
        assert [sum(e.n_windows.values()) for e in made] == [every] * 2
        assert made[-1].n_windows["raw"] == (mode != "bed")


@pytest.mark.parametrize("case", ["explicit", "started", "empty"])
def test_no_stash_leaves_the_native_feed(inputs, tmp_path, capsys,
                                         monkeypatch, small_enc, case):
    """An explicit device, a start-up already done in this process, and a
    stash that pulled nothing all leave the whole stream to the engine's
    own feed: on 8 rows, the native take32 pairs, no puller."""
    fed = []
    real = port_run.feed_stream

    def spy(engine, r, puller=None, stash=()):
        fed.append((puller, len(stash)))
        return real(engine, r, puller, stash)

    monkeypatch.setattr(port_run, "feed_stream", spy)
    device = None
    if case == "explicit":
        device = ["cpu"] * 8
    else:
        _fresh(monkeypatch, ["cpu"] * 8)
        if case == "started":
            monkeypatch.setattr(boot, "_started", True)
        else:
            _not_ready_for(monkeypatch, 0)
    _, stashed = _run(inputs, tmp_path, "chr", device, capsys)
    assert stashed == 0
    assert fed == [(None, 0)]


def test_loader_starts_before_the_start_up(inputs, tmp_path, monkeypatch,
                                          small_enc):
    """device=None: the run starts its loader and the stashing thread,
    then runs the start-up on the calling thread; the engine comes after
    both, and no stashing thread outlives the run."""
    _fresh(monkeypatch, ["cpu"])
    order = []
    real_load, real_make = port_run.try_native_load, port_run.make_engine
    real_init = boot._init_and_touch

    def load(*a, **kw):
        order.append("loader")
        return real_load(*a, **kw)

    def init():
        order.append(("start_up", threading.current_thread().name,
                      [t.name for t in threading.enumerate()
                       if t.name == "pandepth-torch-stash"]))
        return real_init()

    def make(*a, **kw):
        order.append("engine")
        return real_make(*a, **kw)

    monkeypatch.setattr(port_run, "try_native_load", load)
    monkeypatch.setattr(port_run, "make_engine", make)
    monkeypatch.setattr(boot, "_init_and_touch", init)
    out = str(tmp_path / "o")
    assert port_main(["pandepth", "-i", inputs["bam"], "-o", out]) == 0
    assert order == ["loader", ("start_up", "MainThread",
                                ["pandepth-torch-stash"]), "engine"]
    assert boot.started()
    assert not _stash_threads()
    assert os.path.exists(out + ".chr.stat.gz")


@pytest.mark.parametrize("error", [RuntimeError("no kernel library"),
                                   OSError("libpdt_kernels.so: cannot open"),
                                   ImportError("no torch")])
def test_failed_start_up_exits_1(inputs, tmp_path, capsys, monkeypatch,
                                 small_enc, error):
    def fail():
        time.sleep(0.2)  # the stashing thread is pulling meanwhile
        raise error

    monkeypatch.setattr(boot, "_started", False)
    monkeypatch.setattr(boot, "_init_and_touch", fail)
    out = str(tmp_path / "f")
    rc = port_main(["pandepth", "-i", inputs["bam"], "-o", out])
    assert rc == 1
    assert f"Error: {error}" in capsys.readouterr().err
    assert not os.path.exists(out + ".chr.stat.gz")
    assert not boot.started()
    assert not _stash_threads()


def test_stash_error_is_the_run_s(inputs, tmp_path, monkeypatch, small_enc):
    """A native error while stashing is raised by the run, after the
    start-up, as it would be by the engine's own feed."""
    _fresh(monkeypatch, ["cpu"])

    def broken(puller, ready):
        raise OSError("inflate failed")

    monkeypatch.setattr(port_run, "_stash", broken)
    with pytest.raises(OSError, match="inflate failed"):
        port_run.prepare(parse_args(["pandepth", "-i", inputs["bam"],
                                      "-o", str(tmp_path / "e")]))
    assert not _stash_threads()


@pytest.mark.parametrize("case", ["missing", "no_gpu"])
def test_fresh_process_fails_promptly(inputs, tmp_path, case):
    """A fresh ``python -m pandepth_tpu_torch.cli`` that fails early exits
    1 with its message, within the deadline."""
    if case == "no_gpu" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PANDEPTH_FORCE_PLATFORM", None)
    inp = str(tmp_path / "missing.bam") if case == "missing" \
        else inputs["bam"]
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch.cli",
                        "-i", inp, "-o", str(tmp_path / "x")], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert time.monotonic() - t0 < 60
    assert r.returncode == 1, r.stderr
    want = "Error: Failed to open the file" if case == "missing" \
        else "Error: no CUDA device is available"
    assert want in r.stderr
    assert "Traceback" not in r.stderr
    assert not os.path.exists(str(tmp_path / "x.chr.stat.gz"))


@pytest.mark.parametrize("argv,rc,want", [
    (["-h"], 0, "show this help"),
    (["-Z", "3"], 0, "Error UnKnow argument -Z"),
    (["-i", "missing.bam", "-o", "x"], 1, "Error: Failed to open the file")])
def test_launcher_fails_before_torch(tmp_path, argv, rc, want):
    """``PANDEPTH_DAEMON=0``: help, a bad flag and a missing input return
    their codes before anything imports torch."""
    code = ("import sys\n"
            "from pandepth_tpu_torch import boot\n"
            "rc = boot.main(sys.argv[1:])\n"
            "print('torch' in sys.modules)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PANDEPTH_DAEMON="0")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code, *argv], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert time.monotonic() - t0 < 30
    assert r.returncode == rc, r.stderr
    assert want in r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"
