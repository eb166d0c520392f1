"""The device's share of the profiled samples, from the program's profiler
traces (``PANDEPTH_PROFILE``: a Chrome trace of ``torch.profiler`` around
each run's ``stats+write`` phase).

``busy_s`` is the union of the device's kernels, copies and sets over
every trace. The traced window is the profiled samples, each counted at
the wall that an unprofiled sample of the same run takes (the caller's
``window_s``), so that the profiler's own start and export do not count
as idle. The trace covers only the phase that it wraps, so device work
outside it (the feed's host-to-device copies) is not seen, and
``busy_s`` is a lower bound. The breakdown gives, a sample, the device
operations that took most time and the longest stretches in which the
device did nothing: the gaps inside the trace, each named by the host
operation that ran in its middle, and the caller's host phases outside
the trace.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def _events(path: str):
    with open(path) as fh:
        data = json.load(fh)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    dev, host = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                str(e.get("name", "?"))[:120])
        if cat in _DEVICE:
            dev.append(span)
        elif cat in _HOST:
            host.append(span)
    return dev, host


def _union(spans) -> List[Tuple[float, float]]:
    out = []
    for a, b, _ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(paths: List[str], samples: int, window_s: float,
         host_gaps: Dict[str, float]):
    """(busy_s, window_s, breakdown) of ``samples`` profiled samples, or
    None where no trace holds a device operation. ``host_gaps``: a
    sample's seconds outside the trace, by what the host was doing."""
    n = max(samples, 1)
    busy = 0.0
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for path in paths:
        dev, host = _events(path)
        for a, b, name in dev:
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        merged = _union(dev)
        busy += sum(b - a for a, b in merged) * 1e-6
        if not host:
            continue
        lo = min(a for a, _, _ in host)
        hi = max(b for _, b, _ in host)
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            around = [h for h in host if h[0] <= mid <= h[1]]
            name = min(around, key=lambda h: h[1] - h[0])[2] if around \
                else "(no host op)"
            key = "trace:" + name
            gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    if busy <= 0.0:
        return None
    for name, sec in host_gaps.items():
        gaps["host:" + name] = sec * n

    def top(d):
        return [[k, v / n] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return busy, window_s, {"device_ops": top(ops),
                              "idle_gaps": top(gaps)}
