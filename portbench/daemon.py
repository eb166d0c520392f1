"""The harness's side of the program's resident daemon: its socket's path,
its ``stat`` reply, and its end.

The daemon speaks JSON over a unix socket: a request is one object, the
writer half-closes, the reply is one object (``{"cmd": "stat"}`` gives
its pid, ``rss_mb`` (peak resident MiB) and per-kernel ``launches``).
A unix socket's path has at most 107 bytes, so where the run's temporary
directory is deeper than that, the path is relative to the directory
that every client and the daemon run in.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import time
from typing import List

_MAX_PATH = 100


def sock_path(workdir: str) -> str:
    path = os.path.join(workdir, "pandepth.sock")
    return path if len(path.encode()) <= _MAX_PATH else "pandepth.sock"


@contextlib.contextmanager
def _in(workdir: str):
    here = os.getcwd()
    os.chdir(workdir)
    try:
        yield
    finally:
        os.chdir(here)


def stat(sock: str, workdir: str, timeout: float = 30.0) -> dict:
    """The daemon's ``stat`` reply, or {} when none answers."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        with _in(workdir):
            conn.connect(sock)
        conn.sendall(json.dumps({"cmd": "stat"}).encode())
        conn.shutdown(socket.SHUT_WR)
        buf = b""
        while part := conn.recv(65536):
            buf += part
        return json.loads(buf.decode()) if buf else {}
    except (OSError, ValueError):
        return {}
    finally:
        conn.close()


def launches(reply: dict) -> int:
    return sum(int(v) for v in (reply.get("launches") or {}).values())


def _state(pid: int) -> str:
    """``pid``'s state letter in ``/proc`` ("" when it is gone)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return ""


def stop(program: List[str], env: dict, workdir: str, pids,
         timeout: float = 30.0) -> None:
    """Ask the daemon to stop (``--daemon-stop``), then wait until each of
    ``pids`` has ended, killing what is left after ``timeout``."""
    with contextlib.suppress(subprocess.SubprocessError, OSError):
        subprocess.run([*program, "--daemon-stop"], env=env, cwd=workdir,
                       stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=timeout)
    pids = {int(p) for p in pids if p}
    for grace, sig in ((timeout, None), (10.0, signal.SIGKILL)):
        if sig is not None:
            for p in pids:
                with contextlib.suppress(OSError):
                    os.kill(p, sig)
        deadline = time.monotonic() + grace
        while pids and time.monotonic() < deadline:
            # the daemon detached by a double fork: not this process's
            # child, so it has ended once gone or a zombie
            pids = {p for p in pids if _state(p) not in ("", "Z")}
            if pids:
                time.sleep(0.05)
