"""Structured run logging: the port of ``pandepth_tpu/utils/log.py``,
whose ``maybe_profile`` traces with ``torch.profiler`` where JAX's used
``jax.profiler``.

The reference emits three bare INFO lines (src/PanDepth.cpp:3454,
:4879); production deployments need more (SURVEY.md §5): per-phase
wall clock, reads in/filtered, events, and throughput.

A run's :class:`RunStats` times its phases and spans by dotted names
(``feed.wait`` is a child of ``feed``). :func:`phase` prints its line when
it closes; :func:`span` and :func:`note`, which time the layers below
``run.py`` (the engine, the feed, the start-up), record into the run in
progress on the calling thread (:func:`running`) and print once, at
:meth:`RunStats.emit`. Nothing prints unless the run is verbose. Under
:func:`maybe_profile` every phase and span is also a
``torch.profiler.record_function`` annotation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Set

_VERBOSE = os.environ.get("PANDEPTH_VERBOSE", "") not in ("", "0")
#: torch.profiler records (maybe_profile): phases and spans annotate it
_PROFILING = False
#: ``stats``: the RunStats of the run in progress on this thread
_local = threading.local()


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def verbose() -> bool:
    return _VERBOSE


def request_id() -> str:
    """A new id for one run: this process's pid and 24 random bits, in
    hex (the daemon's client makes its own the same way)."""
    return f"{os.getpid():x}-{os.urandom(3).hex()}"


def current() -> Optional[RunStats]:
    """The RunStats of the run in progress on this thread, or the one a
    caller made ready for the next run on it (:func:`running`)."""
    return getattr(_local, "stats", None)


@dataclasses.dataclass
class RunStats:
    reads_seen: int = 0
    events: int = 0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    t0: float = dataclasses.field(default_factory=time.perf_counter)
    #: encoded windows pulled before the engine existed (the pre-engine
    #: stash), and the seconds from the process's start until the engine
    #: was made
    stashed: int = 0
    engine_at: Optional[float] = None
    #: the run's id (through the daemon, its client's)
    req: str = dataclasses.field(default_factory=request_id)
    #: the host clock at :meth:`emit`
    t1: Optional[float] = None
    #: called once, when the run's start-up returns (:meth:`started_up`)
    on_start_up: Optional[Callable[[], None]] = None
    #: the names whose line :func:`phase` printed already
    printed: Set[str] = dataclasses.field(default_factory=set)

    def start(self) -> None:
        """The run starts now: its ``wall`` counts from here."""
        self.t0 = time.perf_counter()

    def note_phase(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def started_up(self) -> None:
        """The start-up (torch, the CUDA context, the kernel library) has
        returned: run :attr:`on_start_up`, once."""
        hook, self.on_start_up = self.on_start_up, None
        if hook is not None:
            hook()

    def summary(self) -> str:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        wall = end - self.t0
        parts = [f"wall={wall:.4f}s", f"req={self.req}"]
        if self.reads_seen:
            parts.append(f"reads={self.reads_seen}")
            parts.append(f"reads/s={self.reads_seen / wall:.0f}")
        if self.events:
            parts.append(f"events={self.events}")
        if self.engine_at is not None:
            parts.append(f"stashed={self.stashed}")
            parts.append(f"engine_at={self.engine_at:.2f}s")
        for k, v in sorted(self.phases.items()):
            parts.append(f"{k}={v:.2f}s")
        return " ".join(parts)

    def emit(self) -> None:
        """The run ends: a verbose run prints each name that no
        :func:`phase` printed (its total), then the ``wall=`` line."""
        self.t1 = time.perf_counter()
        if not _VERBOSE:
            return
        for name, v in self.phases.items():
            if name not in self.printed:
                self.printed.add(name)
                print(f"INFO: phase {name}: {v:.6f}s", file=sys.stderr)
        print(f"INFO: {self.summary()}", file=sys.stderr)


def _annotation(name: str):
    """``name`` as a ``record_function`` annotation while the profiler
    records; else nothing."""
    if not _PROFILING:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def phase(stats: Optional[RunStats], name: str):
    with _annotation(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if stats is not None:
                stats.note_phase(name, dt)
                stats.printed.add(name)
            if _VERBOSE:
                print(f"INFO: phase {name}: {dt:.3f}s", file=sys.stderr)


@contextlib.contextmanager
def running(stats: RunStats):
    """``stats`` is the run in progress on this thread for the block:
    :func:`span` and :func:`note` record into it, and a run that starts
    in it (the daemon's request) takes it as its own."""
    prev = getattr(_local, "stats", None)
    _local.stats = stats
    try:
        yield stats
    finally:
        _local.stats = prev


def note(name: str, seconds: float) -> None:
    """Add ``seconds`` to ``name`` of the run in progress on this thread
    (none: nothing); it prints at the run's :meth:`RunStats.emit`."""
    stats = current()
    if stats is not None:
        stats.note_phase(name, seconds)


@contextlib.contextmanager
def span(name: str):
    """Time the block as ``name`` of the run in progress on this thread
    (see :func:`note`); a ``record_function`` annotation too while the
    profiler records."""
    with _annotation(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            note(name, time.perf_counter() - t0)


@contextlib.contextmanager
def maybe_profile(stats: RunStats, late: bool = False):
    """With ``PANDEPTH_PROFILE=<dir>``, the run under ``torch.profiler``
    (CPU activity, and CUDA activity when this process has a CUDA context
    as it starts), written as a Chrome trace ``<dir>/pandepth-<req>.json``
    (``req``: the run's id) when the block ends; unset, nothing. It starts
    now, or with ``late`` when the run's start-up returns
    (:meth:`RunStats.started_up`): a process without a CUDA context gets
    one there. While it records, every phase and span is an annotation
    (``user_annotation`` in the trace). Imports torch only when set."""
    global _PROFILING
    out = os.environ.get("PANDEPTH_PROFILE")
    if not out:
        yield
        return
    profs = []

    def start():
        global _PROFILING
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        profs.append(prof)
        _PROFILING = True

    if late:
        stats.on_start_up = start
    else:
        start()
    try:
        yield
    finally:
        stats.on_start_up = None
        if profs:
            _PROFILING = False
            profs[0].stop()
            os.makedirs(out, exist_ok=True)
            path = os.path.join(out, f"pandepth-{stats.req}.json")
            n = 0
            while os.path.exists(path):
                n += 1
                path = os.path.join(out, f"pandepth-{stats.req}-{n}.json")
            profs[0].export_chrome_trace(path)
