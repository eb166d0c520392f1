"""Structured run logging: the port of ``pandepth_tpu/utils/log.py``,
whose ``maybe_profile`` traces with ``torch.profiler`` where JAX's used
``jax.profiler``.

The reference emits three bare INFO lines (src/PanDepth.cpp:3454,
:4879); production deployments need more (SURVEY.md §5): per-phase
wall clock, reads in/filtered, events, and throughput.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

_VERBOSE = os.environ.get("PANDEPTH_VERBOSE", "") not in ("", "0")


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def verbose() -> bool:
    return _VERBOSE


def process_seconds() -> float:
    """Seconds since this process started: its start time in
    ``/proc/self/stat`` (clock ticks since boot) against
    ``/proc/uptime``, to a tick (10 ms)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


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

    def note_phase(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def summary(self) -> str:
        wall = time.perf_counter() - self.t0
        parts = [f"wall={wall:.2f}s"]
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
        if _VERBOSE:
            print(f"INFO: {self.summary()}", file=sys.stderr)


@contextlib.contextmanager
def phase(stats: Optional[RunStats], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if stats is not None:
            stats.note_phase(name, dt)
        if _VERBOSE:
            print(f"INFO: phase {name}: {dt:.3f}s", file=sys.stderr)


@contextlib.contextmanager
def maybe_profile():
    """With ``PANDEPTH_PROFILE=<dir>``, the block under ``torch.profiler``
    (CPU activity, and CUDA activity when this process has a CUDA
    context), written as a Chrome trace ``<dir>/pandepth-<pid>-<n>.json``;
    unset, nothing. Imports torch only when set."""
    out = os.environ.get("PANDEPTH_PROFILE")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    n = 0
    while os.path.exists(path := os.path.join(
            out, f"pandepth-{os.getpid()}-{n}.json")):
        n += 1
    prof.export_chrome_trace(path)
