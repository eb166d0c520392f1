"""The port's launcher and its start-up: ``python -m pandepth_tpu_torch``
or ``pandepth-torch``; the port of ``pandepth_tpu/boot.py``'s ``main``,
``disable_thp`` and the start-up of ``background``.

A run goes through the resident daemon (:mod:`pandepth_tpu_torch.serve`)
unless ``PANDEPTH_DAEMON=0``: a fresh process pays ``import torch`` and
CUDA's start-up before its run, the daemon once. A run that elects the
host engine (``PANDEPTH_HOST_FINALIZE=1``, :func:`want_host_finalize`)
pays neither and runs in this process, unless ``PANDEPTH_DAEMON=1`` asks
for the daemon. ``--serve`` runs a
daemon in the foreground, ``--daemon-stop`` stops it. ``python -m
pandepth_tpu_torch.cli`` stays a run in its own process, and the
multi-process launcher (:mod:`pandepth_tpu_torch.sharding.launch`) never
goes through the daemon.

A run in its own process overlaps that start-up with its native feed:
``pandepth_tpu_torch.run.prepare`` starts the first file's native loader
and a thread that stashes its encoded windows, then runs
:func:`start_up` (``import torch``, the devices, the CUDA context, the
kernel library) on the calling thread, and makes the engine on the
devices it returns. JAX's ``background`` runs the start-up on the
thread instead; on an H100's host that made a fresh process slower than
no overlap at all, since the start-up took 1.8 s longer on a thread than
on the main thread (``PERF.md``, ``tools/boot_ab.py``). A failed
start-up raises :class:`InitError`: there is no fallback onto the CPU.

This module and the client side of :mod:`~pandepth_tpu_torch.serve`
import no torch: the client forks the daemon, and CUDA does not survive a
fork. JAX's ``restore_site``, ``configure_jax`` and ``jax_cache_dir``
have no counterpart: they serve a ``python -S`` launcher and jax's
config.
"""

from __future__ import annotations

import os
import sys


class InitError(RuntimeError):
    """The start-up failed: no CUDA device, a kernel library that does not
    build or load, a failed ``import torch``. The message is the
    failure's, which is chained."""


_started = False


def _init_and_touch() -> list:
    """``import torch``; the devices of ``cli.resolve_devices(None)``
    (every visible card, or an error when there is none); and
    unless every device is the CPU, the CUDA context of the first card
    (one small allocation) and the kernel library (built with nvcc at its
    first use). The three are the run's spans ``start_up.torch``,
    ``start_up.cuda`` and ``start_up.kernels``."""
    from pandepth_tpu_torch.utils.log import span

    with span("start_up.torch"):
        import torch

        from pandepth_tpu_torch.cli import resolve_devices

        devs = resolve_devices(None)
    cuda = [d for d in devs if d.type == "cuda"]
    if cuda:
        with span("start_up.cuda"):
            torch.cuda.init()
            torch.empty(1, device=cuda[0])
        with span("start_up.kernels"):
            from pandepth_tpu_torch.device import kernels

            kernels.library()
    return devs


def start_up() -> list:
    """The devices of a run (``cli.resolve_devices(None)``), after torch,
    the CUDA context and the kernel library have started, on the calling
    thread; raises :class:`InitError` if any of them fails. Cheap once it
    has succeeded in this process."""
    global _started
    try:
        devs = _init_and_touch()
    except Exception as e:
        raise InitError(str(e)) from e
    _started = True
    return devs


def started() -> bool:
    """:func:`start_up` has succeeded in this process: a run has no
    start-up left to overlap with its feed."""
    return _started


def process_seconds() -> float:
    """Seconds since this process started: its start time in
    ``/proc/self/stat`` (clock ticks since boot) against
    ``/proc/uptime``, to a tick (10 ms)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def multihost_wanted() -> bool:
    """A rank of a multi-process job: a default process group of more
    than one rank, or ``PANDEPTH_MULTIHOST=1`` (the launcher sets it, so
    a world of one runs the same engine). Imports no torch: a process
    that has not imported ``torch.distributed`` has no process group."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return True
    return os.environ.get("PANDEPTH_MULTIHOST") == "1"


def want_host_finalize() -> bool:
    """The election of the host engine
    (``pandepth_tpu_torch.device.host_engine``), from the environment
    alone: ``PANDEPTH_HOST_FINALIZE=1`` elects it, on every coordinate
    tier and also inside the resident daemon; unset or anything else, the
    device engines run. A sharded run (``PANDEPTH_SHARDED`` set and not
    ``0``) and a rank of a multi-process job (:func:`multihost_wanted`)
    never take it. A missing card or a kernel library that does not build
    never elects it either: those still fail the start-up
    (:class:`InitError`). Imports no torch and no numpy, so that the
    launcher can route by it."""
    if os.environ.get("PANDEPTH_SHARDED") not in (None, "0"):
        return False
    if multihost_wanted():
        return False
    return os.environ.get("PANDEPTH_HOST_FINALIZE") == "1"


def disable_thp(numpy: bool = True) -> None:
    """Opt this process (and the daemon it forks) out of transparent huge
    pages, as the JAX package does: the prctl flag, glibc's mmap and trim
    thresholds at 1 GB, so that large short-lived numpy temporaries stay
    on the free list instead of being faulted in again, and with
    ``numpy`` numpy's own madvise switch (which imports numpy: the
    daemon's client skips it, and the daemon throws it itself).
    ``PANDEPTH_THP=1`` keeps THP."""
    if os.environ.get("PANDEPTH_THP") == "1":
        return
    import ctypes

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(41, 1, 0, 0, 0)  # PR_SET_THP_DISABLE
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except (OSError, AttributeError):  # tuning only
        pass
    if not numpy:
        return
    try:
        from numpy._core.multiarray import _set_madvise_hugepage
    except ImportError:
        try:
            from numpy.core.multiarray import _set_madvise_hugepage
        except ImportError:
            return
    _set_madvise_hugepage(False)


def main(argv=None) -> int:
    """The launcher: ``argv`` (default ``sys.argv[1:]``) holds pandepth's
    flags, or ``--serve`` / ``--daemon-stop``. With ``PANDEPTH_DAEMON``
    unset (or ``auto``), a run that elects the host engine
    (:func:`want_host_finalize`) runs in this process and never starts
    the daemon or the device; every other run goes through the daemon.
    An explicit ``PANDEPTH_DAEMON=1`` takes the daemon whatever the
    engine, ``0`` (or empty) this process."""
    args = list(sys.argv[1:] if argv is None else argv)
    daemon_env = os.environ.get("PANDEPTH_DAEMON", "auto")
    daemon = daemon_env not in ("0", "") and not (
        daemon_env == "auto" and want_host_finalize())
    disable_thp(numpy=not daemon or "--serve" in args)
    if "--serve" in args:
        from pandepth_tpu_torch.serve import serve_foreground

        return serve_foreground()
    if "--daemon-stop" in args:
        from pandepth_tpu_torch.serve import stop_daemon

        return stop_daemon()
    if daemon:
        from pandepth_tpu_torch.serve import client_main

        return client_main(args)
    from pandepth_tpu_torch.cli import main as cli_main

    # cli.main takes the reference's argv: [0] is the program name
    return cli_main(["pandepth"] + args)
