"""The port's launcher and resident daemon on the CPU
(``pandepth_tpu_torch.boot``, ``pandepth_tpu_torch.serve``; the port of
tests/test_serve.py and tests/test_launcher.py): ``python -m
pandepth_tpu_torch`` through a foreground server matches a direct run's
table, stdout, stderr and exit code byte for byte, in the caller's cwd,
run after run and on malformed input; a verbose run prints each span of
its round trip and its feed once, and a quiet one none (the native
counter of the feed's waits lies within the feed); a stale token is
refused and the
next client spawns a fresh daemon; ``_run_one`` replaces the daemon's
environment, survives errors and leaves no engine alive; ``--daemon-stop``
stops the daemon; the client imports no torch; the default socket is not
the JAX package's; ``PANDEPTH_DAEMON=0`` runs in process; and
``PANDEPTH_PROFILE`` writes a trace of the whole run. Every daemon runs on the CPU through
``PANDEPTH_FORCE_PLATFORM=cpu``, every subprocess under a timeout, and
the fixtures stop the daemons they start."""

import gc
import gzip
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import pytest

from tests.fixtures import make_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "chr.chr.stat.gz.txt")
TIMEOUT = 120


def _env(sock):
    env = dict(os.environ, PYTHONPATH=ROOT, PANDEPTH_DAEMON_SOCK=sock,
               PANDEPTH_FORCE_PLATFORM="cpu", PANDEPTH_DAEMON_IDLE_S="120",
               PANDEPTH_ENC_CAP=str(1 << 14), PANDEPTH_ENC_EXC=str(1 << 11))
    env.pop("PANDEPTH_DAEMON", None)
    return env


def _launch(env, args, cwd, daemon="1"):
    env = dict(env, PANDEPTH_DAEMON=daemon)
    if daemon == "1":
        env["PANDEPTH_DAEMON_REQUIRE"] = "1"
    return subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                           *args], env=env, cwd=cwd, capture_output=True,
                          timeout=TIMEOUT)


def _wait_sock(path, proc=None, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            return
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the server exited {proc.returncode}")
        time.sleep(0.05)
    raise TimeoutError("the daemon's socket never appeared")


def _stop(env, proc=None):
    subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                    "--daemon-stop"], env=env, timeout=TIMEOUT)
    if proc is not None:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _serve(env):
    proc = subprocess.Popen([sys.executable, "-m", "pandepth_tpu_torch",
                             "--serve"], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    _wait_sock(env["PANDEPTH_DAEMON_SOCK"], proc)
    return proc


@pytest.fixture
def sock_dir():
    """A short directory for sockets (a unix socket's path is at most 107
    bytes)."""
    d = tempfile.mkdtemp(prefix="pdt")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve"))
    make_bam(os.path.join(d, "t.bam"), n=800, seed=11)
    with open(os.path.join(d, "bad.bam"), "wb") as fh:
        fh.write(b"\x1f\x8b" + bytes(range(256)) * 8)
    sd = tempfile.mkdtemp(prefix="pdt")
    env = _env(os.path.join(sd, "d.sock"))
    box = {"dir": d, "env": env, "srv": _serve(env)}
    yield box
    if box["srv"].poll() is None:
        _stop(env, box["srv"])
    shutil.rmtree(sd, ignore_errors=True)


def _table(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def test_daemon_run_matches_direct_run(served, tmp_path):
    """The same relative -o in two directories: through the daemon and in
    a fresh process, equal tables, stdout, stderr and exit codes."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    bam = os.path.join(served["dir"], "t.bam")
    via = _launch(served["env"], ["-i", bam, "-o", "x"], str(a))
    direct = _launch(served["env"], ["-i", bam, "-o", "x"], str(b), "0")
    assert via.returncode == direct.returncode == 0, via.stderr
    assert (via.stdout, via.stderr) == (direct.stdout, direct.stderr)
    assert _table(str(a / "x.chr.stat.gz")) == \
        _table(str(b / "x.chr.stat.gz"))
    with open(GOLDEN, "rb") as fh:
        assert _table(str(a / "x.chr.stat.gz")) == fh.read()
    assert served["srv"].poll() is None


def test_verbose_run_leaves_the_next_one_quiet(served, tmp_path):
    """-v is the run's own: after a verbose run through the daemon, a
    quiet one writes the direct run's stderr (no phase lines)."""
    bam = os.path.join(served["dir"], "t.bam")
    loud = _launch(served["env"], ["-i", bam, "-o", "v", "-v"],
                   str(tmp_path))
    assert loud.returncode == 0 and b"INFO: wall=" in loud.stderr
    via = _launch(served["env"], ["-i", bam, "-o", "q"], str(tmp_path))
    direct = _launch(served["env"], ["-i", bam, "-o", "q"], str(tmp_path),
                     "0")
    assert via.returncode == direct.returncode == 0
    assert (via.stdout, via.stderr) == (direct.stdout, direct.stderr)
    assert b"INFO: phase" not in via.stderr


ROUND_TRIP = ("client.boot", "daemon.recv", "daemon.pre", "daemon.post",
              "client.drain")
FEED = ("feed.wait", "feed.stage", "h2d")


def _phases(stderr: bytes) -> dict:
    """Each ``INFO: phase <name>: <s>s`` line's name: its seconds, as a
    list (a name printed twice has two)."""
    out = {}
    for line in stderr.decode().splitlines():
        m = re.match(r"^INFO: phase (\S+): ([0-9.]+)s$", line)
        if m:
            out.setdefault(m.group(1), []).append(float(m.group(2)))
    return out


def test_verbose_run_prints_each_span_once(served, tmp_path):
    """A verbose run through the daemon prints the round trip's five spans
    and the feed's, each once; with RunStats' wall they fit in the
    client's wall; the wall line carries the request's id. A quiet run
    prints none of them."""
    bam = os.path.join(served["dir"], "t.bam")
    t0 = time.perf_counter()
    loud = _launch(served["env"], ["-i", bam, "-o", "v", "-v"],
                   str(tmp_path))
    wall = time.perf_counter() - t0
    assert loud.returncode == 0, loud.stderr
    got = _phases(loud.stderr)
    for name in ROUND_TRIP + FEED + ("start_up.torch",):
        assert len(got.get(name, [])) == 1, (name, loud.stderr)
        assert got[name][0] >= 0.0
    assert all(len(v) == 1 for v in got.values()), got
    m = re.search(rb"^INFO: wall=([0-9.]+)s req=([0-9a-f]+-[0-9a-f]{6}) ",
                  loud.stderr, re.M)
    assert m, loud.stderr
    # client.boot is good to a clock tick (10 ms)
    assert sum(got[k][0] for k in ROUND_TRIP) + float(m.group(1)) <= \
        wall + 0.01
    assert got["feed.wait"][0] + got["feed.stage"][0] + got["h2d"][0] <= \
        got["feed"][0] + got["stats+write"][0]
    quiet = _launch(served["env"], ["-i", bam, "-o", "q"], str(tmp_path))
    assert quiet.returncode == 0 and not _phases(quiet.stderr)
    assert b"INFO: wall=" not in quiet.stderr


def test_native_wait_counter_within_the_feed(tmp_path):
    """libpancov_io's count of the seconds the consumer blocked on the
    stream's producer: feed_stream notes it as the run's ``feed.wait``,
    at least 0 and no longer than the feed; the count starts anew after
    each read."""
    from pandepth_tpu_torch.device.engine import CoverageEngine
    from pandepth_tpu_torch.device.layout import GenomeLayout
    from pandepth_tpu_torch.feed import feed_stream
    from pandepth_tpu_torch.io.native import NativeBamStream, load_library
    from pandepth_tpu_torch.utils.log import RunStats, phase, running

    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=3000, seed=3)
    for cap in (256, 1 << 14):
        r = NativeBamStream(bam, 1796, 0)
        eng = CoverageEngine(GenomeLayout(r.header.lengths), device="cpu")
        eng.enc_cap = cap
        stats = RunStats()
        with running(stats), phase(stats, "feed"):
            feed_stream(eng, r)
        wait = stats.phases["feed.wait"]
        assert 0.0 <= wait <= stats.phases["feed"]
        assert eng.n_reads_seen == 3000
    r = NativeBamStream(bam, 1796, 0)
    while r.wait() >= 0:
        r.take64(r.wait())
    assert r.wait_seconds() >= 0.0
    assert r.wait_seconds() == 0.0
    r.close()


def test_daemon_second_run_in_the_callers_cwd(served, tmp_path):
    """A warm daemon serves again, -a included, into the caller's cwd."""
    bam = os.path.join(served["dir"], "t.bam")
    for k in range(2):
        r = _launch(served["env"], ["-i", bam, "-a", "-o", f"y{k}"],
                    str(tmp_path))
        assert r.returncode == 0, r.stderr
    assert _table(str(tmp_path / "y0.SiteDepth.gz")) == \
        _table(str(tmp_path / "y1.SiteDepth.gz"))
    assert served["srv"].poll() is None


@pytest.mark.parametrize("inp", ["/nonexistent.bam", "bad.bam"])
def test_daemon_returns_the_exit_code(served, tmp_path, inp):
    """A missing and a malformed input: exit 1 and the direct run's
    stderr; the daemon survives."""
    args = ["-i", os.path.join(served["dir"], inp), "-o", "z"]
    via = _launch(served["env"], args, str(tmp_path))
    direct = _launch(served["env"], args, str(tmp_path), "0")
    assert via.returncode == direct.returncode == 1
    assert via.stderr == direct.stderr and b"Error" in via.stderr
    assert served["srv"].poll() is None


def test_stale_token_is_refused_and_the_daemon_respawned(served, tmp_path):
    """A request with another token gets ``stale`` and the daemon exits;
    the next client spawns a fresh daemon (a double fork), which runs
    it."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(served["env"]["PANDEPTH_DAEMON_SOCK"])
    payload = {"argv": ["-i", "x", "-o", "nope"], "cwd": str(tmp_path),
               "token": "0.0|", "env": {}}
    socket.send_fds(conn, [json.dumps(payload).encode()], [0, 1, 2])
    conn.shutdown(socket.SHUT_WR)
    reply = json.loads(conn.recv(65536).decode())
    conn.close()
    assert reply == {"error": "stale"}
    served["srv"].wait(timeout=30)
    r = _launch(served["env"], ["-i", os.path.join(served["dir"], "t.bam"),
                                "-o", "fresh"], str(tmp_path))
    try:
        assert r.returncode == 0, r.stderr
        assert os.path.exists(served["env"]["PANDEPTH_DAEMON_SOCK"])
        assert os.path.exists(str(tmp_path / "fresh.chr.stat.gz"))
    finally:
        _stop(served["env"])
    # the fixture's teardown stops a server of its own again
    served["srv"] = _serve(served["env"])


def test_daemon_stop_stops_the_daemon(sock_dir):
    env = _env(os.path.join(sock_dir, "s.sock"))
    proc = _serve(env)
    try:
        r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                            "--daemon-stop"], env=env, timeout=TIMEOUT)
        assert r.returncode == 0
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(env["PANDEPTH_DAEMON_SOCK"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_client_imports_no_torch(sock_dir, tmp_path):
    """The client's whole path (boot -> serve.client_main -> a spawned
    daemon, then the run through it) in a fresh process leaves torch out
    of its sys.modules: the daemon is forked from it, and CUDA does not
    survive a fork; numpy too, whose import is most of a client's
    start-up."""
    env = _env(os.path.join(sock_dir, "c.sock"))
    env.update(PANDEPTH_DAEMON="1", PANDEPTH_DAEMON_REQUIRE="1")
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=300, seed=5)
    code = ("import sys\n"
            "from pandepth_tpu_torch import boot\n"
            f"rc = boot.main(['-i', {bam!r}, '-o', 'c'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'numpy'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(rc)\n")
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           cwd=str(tmp_path), capture_output=True,
                           text=True, timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr
        assert "LOADED []" in r.stdout
        assert os.path.exists(str(tmp_path / "c.chr.stat.gz"))
        assert os.path.exists(env["PANDEPTH_DAEMON_SOCK"])
    finally:
        _stop(env)


def test_in_process_run_with_daemon_0(sock_dir, tmp_path):
    """PANDEPTH_DAEMON=0: the run in this process, no daemon spawned."""
    env = _env(os.path.join(sock_dir, "n.sock"))
    make_bam(str(tmp_path / "t.bam"), n=800, seed=11)
    r = _launch(env, ["-i", "t.bam", "-o", "n"], str(tmp_path), "0")
    assert r.returncode == 0, r.stderr
    assert not os.path.exists(env["PANDEPTH_DAEMON_SOCK"])
    with open(GOLDEN, "rb") as fh:
        assert _table(str(tmp_path / "n.chr.stat.gz")) == fh.read()


def test_default_socket_is_not_the_jax_packages(monkeypatch):
    from pandepth_tpu import serve as jax_serve
    from pandepth_tpu_torch import serve

    monkeypatch.delenv("PANDEPTH_DAEMON_SOCK", raising=False)
    assert serve.sock_path() != jax_serve.sock_path()
    assert os.path.basename(serve.sock_path()) != \
        os.path.basename(jax_serve.sock_path())


def test_token_covers_sources_and_device_env(monkeypatch):
    from pandepth_tpu_torch import serve

    monkeypatch.delenv("PANDEPTH_FORCE_PLATFORM", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    base = serve.code_token()
    monkeypatch.setenv("PANDEPTH_FORCE_PLATFORM", "cpu")
    cpu = serve.code_token()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert len({base, cpu, serve.code_token()}) == 3
    newest = float(base.split("|")[0])
    cu = os.path.join(ROOT, "pandepth_tpu_torch", "csrc",
                      "sweep_kernels.cu")
    assert newest >= os.stat(cu).st_mtime


def _devnull_fds():
    return [os.open(os.devnull, os.O_RDONLY),
            os.open(os.devnull, os.O_WRONLY),
            os.open(os.devnull, os.O_WRONLY)]


def test_run_one_replaces_env_and_survives_errors(tmp_path, monkeypatch):
    """_run_one replaces the daemon's PANDEPTH_* environment with the
    request's for the run and restores it; a dead cwd and a string
    SystemExit give exit codes, not a dead daemon."""
    from pandepth_tpu_torch import serve

    s = serve._Server(str(tmp_path / "x.sock"))
    monkeypatch.setenv("PANDEPTH_TEST_INHERITED", "1")
    seen = {}

    def fake_main(argv):
        seen["inherited"] = os.environ.get("PANDEPTH_TEST_INHERITED")
        seen["sent"] = os.environ.get("PANDEPTH_TEST_SENT")
        seen["cwd"] = os.getcwd()
        return 0

    monkeypatch.setattr("pandepth_tpu_torch.cli.main", fake_main)
    reply = s._run_one({"argv": ["-h"], "cwd": str(tmp_path),
                        "env": {"PANDEPTH_TEST_SENT": "yes"}},
                       _devnull_fds())
    assert reply["rc"] == 0 and reply["pid"] == os.getpid()
    assert seen == {"inherited": None, "sent": "yes", "cwd": str(tmp_path)}
    assert os.environ.get("PANDEPTH_TEST_INHERITED") == "1"
    assert "PANDEPTH_TEST_SENT" not in os.environ

    gone = tmp_path / "gone"
    gone.mkdir()
    gone.rmdir()
    reply = s._run_one({"argv": [], "cwd": str(gone), "env": {}},
                       _devnull_fds())
    assert reply["rc"] != 0

    def exit_main(argv):
        raise SystemExit("boom")

    monkeypatch.setattr("pandepth_tpu_torch.cli.main", exit_main)
    reply = s._run_one({"argv": [], "cwd": str(tmp_path), "env": {}},
                       _devnull_fds())
    assert reply["rc"] == 1


def test_run_one_keeps_no_engine_alive(tmp_path):
    """A real run through _run_one: afterwards no engine of it is alive,
    so the next request starts without its tensors."""
    from pandepth_tpu_torch import serve
    from pandepth_tpu_torch.device.engine import CoverageEngine
    from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=300, seed=5)
    s = serve._Server(str(tmp_path / "x.sock"))
    for extra in ([], ["-a"], ["-w", "100"]):
        reply = s._run_one({"argv": ["-i", bam, *extra, "-o", "e"],
                            "cwd": str(tmp_path),
                            "env": {"PANDEPTH_FORCE_PLATFORM": "cpu"}},
                           _devnull_fds())
        assert reply["rc"] == 0
        gc.collect()
        assert not [o for o in gc.get_objects()
                    if issubclass(type(o), (CoverageEngine,
                                            ShardedCoverageEngine))]


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    """PANDEPTH_PROFILE=<dir>: the whole of a CPU run under
    torch.profiler, a Chrome trace in <dir> whose annotations are the
    run's phases and spans; unset, none."""
    from pandepth_tpu_torch.cli import main as port_main

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=300, seed=5)
    assert port_main(["pandepth", "-i", bam, "-o", str(tmp_path / "u")],
                     device="cpu") == 0
    prof = tmp_path / "prof"
    monkeypatch.setenv("PANDEPTH_PROFILE", str(prof))
    assert port_main(["pandepth", "-i", bam, "-o", str(tmp_path / "p")],
                     device="cpu") == 0
    traces = sorted(prof.iterdir())
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"feed", "feed.take", "feed.stage", "stats+write"} <= spans
    assert _table(str(tmp_path / "p.chr.stat.gz")) == \
        _table(str(tmp_path / "u.chr.stat.gz"))
