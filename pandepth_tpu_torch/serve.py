"""Resident serve mode: a warm process answering the port's CLI runs; the
port of ``pandepth_tpu/serve.py``.

A fresh ``python -m pandepth_tpu_torch.cli`` process spends most of its
wall importing torch and starting CUDA before it reads a byte. One
resident daemon keeps torch, the CUDA context, the built kernels and
``libpancov_io`` loaded; each run becomes a round trip over a unix socket
that ships ``argv``, the caller's cwd, its ``PANDEPTH_*`` environment and
its stdin, stdout and stderr descriptors (``SCM_RIGHTS``) to the daemon,
which runs the CLI's ``main`` there. Tables, stdout and stderr bytes and
exit codes are a direct run's.

Surface (through :mod:`pandepth_tpu_torch.boot`, ``python -m
pandepth_tpu_torch`` or ``pandepth-torch``):

* ``--serve``              run a server in the foreground
* ``PANDEPTH_DAEMON=1`` (the default) runs through the daemon, spawning
  it on first use (double fork, detached; it exits after
  ``PANDEPTH_DAEMON_IDLE_S`` seconds without a request, default 900)
* ``--daemon-stop``        stop the daemon
* ``PANDEPTH_DAEMON_SOCK`` the socket's path; by default
  ``pandepth-torch-daemon-<uid>.sock`` in the temp directory, a name of
  its own, so that the port's client never takes the JAX package's
  daemon for a stale one of its own, nor the reverse
* ``PANDEPTH_DAEMON_REQUIRE=1`` makes a daemon that cannot be reached an
  error instead of a run in the client's process
* ``PANDEPTH_DAEMON_REQ_TIMEOUT_S`` how long the daemon waits on one
  client's request and reply (default 120 s): a client that stalls
  loses its connection, and the daemon goes on to the next
* a request with ``PANDEPTH_HOST_FINALIZE=1`` in its environment runs
  the host engine inside the daemon (the launcher sends such a run
  here only under an explicit ``PANDEPTH_DAEMON=1``)

Round trip: each request carries an id, which a verbose run prints in
its ``wall=`` line and names its profiler trace by. A verbose run's reply
carries the daemon's three spans of it (``daemon.recv``: from the accept
until the request is decoded; ``daemon.pre``: until the run's RunStats
starts; ``daemon.post``: from its end until the reply is ready), and the
client prints them after the reply beside its own two (``client.boot``:
from its process's start until the request is sent, to a clock tick;
``client.drain``: from the reply's first bytes until the daemon closes the
connection, after its garbage collection).

Staleness: each request carries a token of the port's newest source
mtime and the environment that decides the device
(``PANDEPTH_FORCE_PLATFORM``, ``CUDA_VISIBLE_DEVICES``); a daemon whose
token differs answers ``stale`` and exits, and the client spawns a fresh
one. CUDA does not survive ``fork``: the client side of this module and
:mod:`~pandepth_tpu_torch.boot` import no torch, and the daemon imports it
inside its first request.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import sys
import tempfile
import threading
import time

_REQ_LIMIT = 1 << 20
#: the environment, besides the sources, that decides what a daemon runs on
TOKEN_ENV = ("PANDEPTH_FORCE_PLATFORM", "CUDA_VISIBLE_DEVICES")


def sock_path() -> str:
    return os.environ.get(
        "PANDEPTH_DAEMON_SOCK",
        os.path.join(tempfile.gettempdir(),
                     f"pandepth-torch-daemon-{os.getuid()}.sock"))


def code_token() -> str:
    """The newest mtime of the port's ``.py``, ``.cpp`` and ``.cu``
    sources (build outputs excluded) and the device-deciding environment
    (:data:`TOKEN_ENV`)."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    newest = 0.0
    for root, _, files in os.walk(pkg):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith((".py", ".cpp", ".cu")):
                try:
                    newest = max(newest,
                                 os.stat(os.path.join(root, f)).st_mtime)
                except OSError:
                    continue
    env = "|".join(os.environ.get(k, "") for k in TOKEN_ENV)
    return f"{newest:.6f}|{env}"


def _close_all(fds) -> None:
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


def _recv_request(conn):
    """One request: (json dict, [fds]), or (None, []) for a request that
    is empty, too large, undecodable or cut by the socket's deadline. The
    client half-closes after sending, so this reads to EOF; the fds ride
    the first chunk and are closed on every failure."""
    fds = []
    try:
        msg, fds, _flags, _addr = socket.recv_fds(conn, _REQ_LIMIT, 3)
        fds = list(fds)
        if not msg:
            raise ValueError("empty request")
        buf = bytearray(msg)
        while len(buf) < _REQ_LIMIT:
            part = conn.recv(65536)
            if not part:
                break
            buf += part
        req = json.loads(bytes(buf).decode())
    except (OSError, ValueError):
        _close_all(fds)
        return None, []
    return req, fds


class _Server:
    def __init__(self, path: str):
        self.path = path
        self.token = code_token()
        self.lock = threading.Lock()

    def _run_one(self, req, fds, recv=None):
        """One CLI request under the caller's cwd, fds and ``PANDEPTH_*``
        environment, which replaces the daemon's for the run (a variable
        the daemon inherited but the request lacks is removed). Returns
        the reply; no exception escapes, so the daemon survives a dead
        cwd, bad fds and a string ``SystemExit``. ``recv``: the host
        clock at the request's accept and at its decode; with it, the
        reply of a verbose run that ended carries the daemon's spans
        (``spans``)."""
        from pandepth_tpu_torch.cli import main as cli_main
        from pandepth_tpu_torch.utils import log

        stats = log.RunStats(req=str(req.get("id") or log.request_id()))

        saved_fds = [os.dup(i) for i in range(3)]
        saved_cwd = os.getcwd()
        saved_env = {}
        rc = 1
        try:
            try:
                sys.stdout.flush()
                sys.stderr.flush()
                for i, fd in enumerate(fds[:3]):
                    os.dup2(fd, i)
                req_env = {k: v for k, v in (req.get("env") or {}).items()
                           if k.startswith("PANDEPTH_")}
                mine = [k for k in os.environ if k.startswith("PANDEPTH_")]
                for k in set(mine) | set(req_env):
                    saved_env[k] = os.environ.get(k)
                for k in mine:
                    if k not in req_env:
                        del os.environ[k]
                os.environ.update(req_env)
                os.chdir(req.get("cwd") or "/")
                with log.running(stats):
                    rc = int(cli_main(["pandepth"] + list(req["argv"])))
            except SystemExit as e:
                # as CPython: sys.exit(str) prints it and exits 1
                if e.code is None:
                    rc = 0
                elif isinstance(e.code, int):
                    rc = e.code
                else:
                    print(e.code, file=sys.stderr)
                    rc = 1
            except BaseException as e:  # never kill the daemon
                try:
                    print(f"Error: {e}", file=sys.stderr)
                except OSError:
                    pass
                rc = 1
        finally:
            try:
                sys.stdout.flush()
                sys.stderr.flush()
            except OSError:
                pass
            try:
                os.chdir(saved_cwd)
            except OSError:  # the daemon's cwd vanished
                os.chdir("/")
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for i, fd in enumerate(saved_fds):
                os.dup2(fd, i)
                os.close(fd)
            _close_all(fds)
        reply = {"rc": rc, **_usage()}
        if recv is not None and stats.t1 is not None and log.verbose():
            reply["spans"] = {"daemon.recv": recv[1] - recv[0],
                              "daemon.pre": stats.t0 - recv[1],
                              "daemon.post": time.perf_counter() - stats.t1}
        return reply

    def serve(self, idle_s: float, ready_fd: int = -1) -> int:
        """Answer requests until ``stop``, a stale token or ``idle_s``
        seconds without one. ``ready_fd`` gets one byte once the socket
        listens (the spawner waits on it)."""
        try:
            os.unlink(self.path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.path)
        os.chmod(self.path, 0o600)
        srv.listen(16)
        srv.settimeout(idle_s)
        # the inode this daemon bound: a replacement may have bound the
        # path again by the time this one exits, and must keep it
        try:
            bound = os.stat(self.path)
        except OSError:
            bound = None
        if ready_fd >= 0:
            os.write(ready_fd, b"R")
            os.close(ready_fd)
        # the client skipped numpy's switch to start fast; the runs here
        # allocate the large arrays
        from pandepth_tpu_torch.boot import disable_thp

        disable_thp()
        req_timeout = _request_s()
        try:
            while True:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    break  # idle: exit and free the card and the socket
                accepted = time.perf_counter()
                with conn:
                    # a stopped client must not wedge the daemon: the
                    # connection has a deadline (the run itself has none)
                    conn.settimeout(req_timeout)
                    req, fds = _recv_request(conn)
                    recv = (accepted, time.perf_counter())
                    if req is None:
                        continue

                    def send(obj) -> None:
                        try:
                            conn.sendall(json.dumps(obj).encode())
                        except OSError:
                            pass  # the client went away

                    cmd = req.get("cmd")
                    if cmd == "stop":
                        _close_all(fds)
                        send({"rc": 0})
                        break
                    if cmd == "stat":
                        _close_all(fds)
                        send({"rc": 0, **_usage()})
                        continue
                    if req.get("token") != self.token:
                        _close_all(fds)
                        send({"error": "stale"})
                        break  # exit: the client spawns fresh code
                    with self.lock:
                        reply = self._run_one(req, fds, recv)
                    send(reply)
                    # after the reply, before the next request: no tensor
                    # of this run outlives it in a reference cycle
                    gc.collect()
        finally:
            srv.close()
            try:
                if bound is not None:
                    st = os.stat(self.path)
                    if (st.st_ino, st.st_dev) == (bound.st_ino,
                                                  bound.st_dev):
                        os.unlink(self.path)
            except OSError:
                pass
        return 0


def _usage() -> dict:
    """This process's pid and peak resident memory (MiB); once it ran the
    kernels, their launches so far, and once it has a CUDA context, the
    bytes its tensors hold and its caching allocator reserves, the bytes
    in use on its card (every context's, this one's included) and its
    stack size."""
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    out = {"pid": os.getpid(), "rss_mb": round(rss, 1)}
    kernels = sys.modules.get("pandepth_tpu_torch.device.kernels")
    if kernels is not None:
        out["launches"] = dict(kernels.launches)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        out["cuda_allocated"] = torch.cuda.memory_allocated()
        out["cuda_reserved"] = torch.cuda.memory_reserved()
        free, total = torch.cuda.mem_get_info()
        out["cuda_used"] = total - free
        out["cuda_stack"] = _stack_limit()
    return out


def _stack_limit():
    """The CUDA context's per-thread stack size in bytes (CUDA grows it,
    and the local memory it reserves on the card, when a kernel needs
    more), or None where ``libcuda`` cannot say."""
    import ctypes

    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    v = ctypes.c_size_t()
    return v.value if cu.cuCtxGetLimit(ctypes.byref(v), 0) == 0 else None


def _idle_s() -> float:
    return float(os.environ.get("PANDEPTH_DAEMON_IDLE_S", "900"))


def _request_s() -> float:
    """How long the daemon waits on one client's request and on sending
    its reply: ``PANDEPTH_DAEMON_REQ_TIMEOUT_S`` seconds, default 120."""
    return float(os.environ.get("PANDEPTH_DAEMON_REQ_TIMEOUT_S", "120"))


def serve_foreground() -> int:
    return _Server(sock_path()).serve(_idle_s())


def _spawn_daemon() -> bool:
    """A detached daemon by double fork; True once its socket listens
    (the grandchild writes to a pipe after bind and listen, so a racing
    client never connects into the void)."""
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:
        try:
            os.close(rfd)
            os.setsid()
            if os.fork() > 0:
                os._exit(0)
            devnull = os.open(os.devnull, os.O_RDWR)
            for i in range(3):
                os.dup2(devnull, i)
            os.close(devnull)
            _Server(sock_path()).serve(_idle_s(), ready_fd=wfd)
        finally:
            os._exit(0)
    os.close(wfd)
    os.waitpid(pid, 0)  # the intermediate child
    try:
        return os.read(rfd, 1) == b"R"
    finally:
        os.close(rfd)


def _request(path: str, payload: dict, fds=(), times=None) -> dict:
    """One request and its reply; ``times`` gets the host clock once the
    request is sent (``sent``), at the reply's first bytes (``reply``)
    and at the end of the connection (``eof``)."""
    times = {} if times is None else times
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        conn.connect(path)
        msg = json.dumps(payload).encode()
        if fds:
            socket.send_fds(conn, [msg], list(fds))
        else:
            conn.sendall(msg)
        conn.shutdown(socket.SHUT_WR)
        times["sent"] = time.perf_counter()
        buf = b""
        while True:
            part = conn.recv(65536)
            if not part:
                break
            if not buf:
                times["reply"] = time.perf_counter()
            buf += part
        times["eof"] = time.perf_counter()
        return json.loads(buf.decode()) if buf else {"error": "closed"}
    finally:
        conn.close()


def _print_round_trip(spans: dict, times: dict) -> None:
    """The round trip's five spans as a verbose run's phase lines: the
    client's start until its request was sent, the daemon's three and the
    reply's first bytes until the end of the connection."""
    from pandepth_tpu_torch.boot import process_seconds

    now = time.perf_counter()
    lines = {"client.boot": process_seconds() - (now - times["sent"]),
             **spans, "client.drain": times["eof"] - times["reply"]}
    for name, sec in lines.items():
        print(f"INFO: phase {name}: {sec:.6f}s", file=sys.stderr)


def daemon_stat() -> dict:
    """The running daemon's usage (see ``_usage``: pid, peak resident
    memory, kernel launches, CUDA memory), or {} when none answers."""
    try:
        return _request(sock_path(), {"cmd": "stat"})
    except OSError:
        return {}


def stop_daemon() -> int:
    try:
        _request(sock_path(), {"cmd": "stop"})
    except OSError:
        pass
    return 0


def client_main(argv) -> int:
    """One CLI run through the daemon, spawning it when it is absent or
    stale; where none can be reached, the run in this process (or, with
    ``PANDEPTH_DAEMON_REQUIRE=1``, exit 1)."""
    path = sock_path()
    payload = {
        "argv": list(argv),
        "cwd": os.getcwd(),
        # utils.log.request_id's form, which the client does not import
        "id": f"{os.getpid():x}-{os.urandom(3).hex()}",
        "token": code_token(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("PANDEPTH_") and k != "PANDEPTH_DAEMON"},
    }
    sys.stdout.flush()
    sys.stderr.flush()
    times = {}
    for attempt in range(2):
        try:
            reply = _request(path, payload,
                             fds=[0, sys.stdout.fileno(),
                                  sys.stderr.fileno()], times=times)
            if "rc" in reply:
                if "spans" in reply:
                    _print_round_trip(reply["spans"], times)
                return int(reply["rc"])
        except OSError:
            pass
        if attempt == 0 and not _spawn_daemon():
            break
    if os.environ.get("PANDEPTH_DAEMON_REQUIRE") == "1":
        print("Error: pandepth daemon unavailable", file=sys.stderr)
        return 1
    from pandepth_tpu_torch.cli import main as cli_main

    return cli_main(["pandepth"] + list(argv))
