"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``.
The run makes (or finds in ``portbench/cache/``) the inputs of the cell's
configuration for ``--seed``, brings the program (``pandepth_tpu_torch``)
up and warms it as the cell's load generator does, drives the window for
``--seconds``, stops every process it started, judges every table that
every job wrote against the plain reference, and prints as its last line
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit.

Exit codes: 0 with a result line; 1 when there is no card (or fewer than
the cell asks for), no program in the checkout, a set-up that failed, or
JAX loaded in this process; 64 for arguments it does not take; 143 on
SIGTERM.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import shutil
import signal
import sys
import tempfile
import time
from typing import List, Optional

from portbench import judge as judging
from portbench import hoststat, nvml, spec, trace
from portbench.loadgen import Context
from portbench.inputs import cache
from portbench.jobs import Run, mean, stderr_tail

PROGRAM = "pandepth_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pandepth_tpu")
EXIT_USAGE = 64
#: RunStats phases that do not overlap one another, outside the profiler
HOST_PHASES = ("open", "targets", "start_up", "feed")


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"portbench: {message}", file=sys.stderr)
        raise SystemExit(EXIT_USAGE)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = _Parser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return p.parse_args(argv)


def device_info(chips: int):
    """({platform, kind, count}, None) where this machine has ``chips``
    CUDA cards, else (None, why)."""
    try:
        import torch
    except ImportError as e:
        return None, f"torch cannot be imported: {e}"
    if not torch.cuda.is_available():
        return None, "no CUDA device is available: the benchmark runs " \
                     "on an NVIDIA GPU"
    n = torch.cuda.device_count()
    if n < chips:
        return None, f"the cell needs {chips} CUDA devices, this machine " \
                     f"has {n}"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}, None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def child_env(root: str, extra: Optional[dict] = None) -> dict:
    """The program's environment: this one without ``PANDEPTH_*``, the
    checkout on the import path, and every build and kernel cache that a
    CUDA or torch library may keep in fixed directories of the checkout."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PANDEPTH_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    c = os.path.join(spec.HERE, "cache")
    env["CUDA_CACHE_PATH"] = os.path.join(c, "cuda")
    env["TRITON_CACHE_DIR"] = os.path.join(c, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(c, "torch_extensions")
    env.update(extra or {})
    return env


def _host_gaps(jobs) -> dict:
    """A sample's seconds in which the host, not the card, worked, the
    mean over ``jobs``: RunStats' phases outside the profiler's reach, the
    rest of RunStats' wall, and the time outside RunStats (the process's
    start and imports; the daemon's round trip)."""
    jobs = [j for j in jobs if j.stats_wall is not None]
    out = {}
    for k in HOST_PHASES:
        v = mean(j.phases.get(k, 0.0) for j in jobs)
        if v:
            out[k] = v
    rest = mean(j.stats_wall - sum(j.phases.get(k, 0.0) for k in
                                   HOST_PHASES + ("stats+write",))
                for j in jobs)
    if rest is not None:
        out["run_other"] = max(rest, 0.0)
        out["outside_runstats"] = max(
            mean(j.wall - j.stats_wall for j in jobs), 0.0)
    return out


def _summary(jobs) -> str:
    """One line on the window's samples: their count, mean wall and, where
    they printed RunStats, its wall and each phase's mean."""
    parts = [f"{len(jobs)} window samples",
             f"wall {mean(j.wall for j in jobs):.4f} s"]
    timed = [j for j in jobs if j.stats_wall is not None]
    if timed:
        parts.append(f"RunStats wall {mean(j.stats_wall for j in timed):.3f}")
        names = sorted({k for j in timed for k in j.phases})
        parts += [f"{k} {mean(j.phases.get(k, 0.0) for j in timed):.4f}"
                  for k in names]
    return "portbench: " + "; ".join(parts)


def _print_samples(run: Run, rss_at) -> None:
    """Lines on the run's samples: the set-up's walls (and RunStats
    phases, where printed), the window's walls, and the host's readings
    between them (``hoststat``)."""
    print("portbench: set-up samples: " + "; ".join(
        f"wall {j.wall:.3f} s" + "".join(
            f", {k} {v:.3f}" for k, v in sorted(j.phases.items()))
        for j in run.stage("setup")), flush=True)
    window = run.stage("window")
    if rss_at and len(window) < int(rss_at):
        print(f"portbench: the daemon's memory was read after the "
              f"window's {len(window)} samples, not after {rss_at}",
              file=sys.stderr)
    if not window:
        return
    print(_summary(window), flush=True)
    print("portbench: window sample walls (s): "
          + " ".join(f"{j.wall:.3f}" for j in window), flush=True)
    for k, name in enumerate(hoststat.NAMES):
        got = [h[k] for h in run.host]
        if len(got) > 1 and None not in got:
            print(f"portbench: window samples' {name} (s): "
                  + " ".join(f"{b - a:.2f}" for a, b in zip(got, got[1:])),
                  flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             root: str, program: Optional[List[str]] = None,
             extra_env: Optional[dict] = None, cards: int = 0,
             cache_dir: Optional[str] = None) -> Optional[dict]:
    """One run of ``cell``: the result line's object without ``device``'s
    platform, kind and count, or None where the program's set-up failed.
    ``program`` (default ``python -m pandepth_tpu_torch``) and
    ``extra_env`` are for the harness's own tests, as is ``cache_dir``
    (default ``portbench/cache``); ``cards`` is how many cards to read the
    used memory of (0: none)."""
    cfg = cell.config
    inputs = cache.ensure(cache_dir or os.path.join(spec.HERE, "cache"),
                          cell.config_name, cell.config_text, cfg, seed)
    print(f"portbench: inputs of {cell.config_name}, seed {seed}: "
          + (f"made in {inputs.seconds:.3f} s" if inputs.seconds
             else "found in the cache"), flush=True)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        p = cfg["pandepth"]
        extra = [a.format(annotation=inputs.gff) for a in p["args"]]
        ctx = Context(
            program=program or [sys.executable, "-m", PROGRAM],
            sample_args=lambda prefix: ["-i", inputs.bam, "-o", prefix,
                                        *extra],
            env=child_env(root, extra_env), workdir=workdir,
            seconds=seconds, trace=traced, traffic=cell.traffic,
            reads_per_sample=int(cfg["reads_per_sample"]),
            profile_dir=os.path.join(workdir, "profile"))
        sampler = nvml.Sampler(cards).start() if cards else None
        try:
            run: Run = spec.loadgen(cell.traffic).drive(ctx)
        finally:
            peak = sampler.stop() if sampler else 0
        if sampler is not None and sampler.error:
            print(f"portbench: the card's memory was not read: "
                  f"{sampler.error}", file=sys.stderr)
        if run.setup_s is None:
            bad = [j for j in run.jobs if j.rc != 0]
            print(f"portbench: the program's set-up failed: "
                  + (f"exit {bad[-1].rc}: {stderr_tail(bad[-1], 6000)}"
                     if bad else "no set-up job ran"), file=sys.stderr)
            return None
        t0 = time.perf_counter()
        want = cache.reference(cfg, seed, inputs)
        print(f"portbench: reference table in {time.perf_counter() - t0:.3f}"
              f" s; {len(run.jobs)} jobs judged", flush=True)
        numbers, notes = judging.judge(run.jobs, p["table"], want)
        for note in notes:
            print(f"portbench: {note}", file=sys.stderr)
        metrics = {}
        for m in cell.per_layer if traced else cell.end_to_end:
            value = spec.reader(m.name)(run)
            if value is None:
                print(f"portbench: {m.name}: nothing to read",
                      file=sys.stderr)
                continue
            metrics[m.name] = {"value": value, "unit": m.unit}
        result = {"correct": judging.passed(numbers),
                  "attempted": len(run.jobs),
                  "failed": numbers["jobs_failed"] + numbers["tables_wrong"],
                  "metrics": metrics,
                  "device": {"memory_peak_bytes": peak}}
        window = run.stage("window")
        _print_samples(run, cell.traffic.get("rss_after_samples"))
        if traced:
            prof = run.stage("profiled")
            got = trace.read(
                sorted(glob.glob(os.path.join(ctx.profile_dir, "*.json"))),
                len(prof), len(prof) * (mean(j.wall for j in window) or 0.0),
                _host_gaps(window))
            if got is None:
                print("portbench: the profiler's traces hold no device "
                      "operation", file=sys.stderr)
            else:
                busy, window_s, breakdown = got
                result["device"].update(busy_s=busy, window_s=window_s)
                result["breakdown"] = breakdown
        result["checks"] = {k: {"value": v, "limit": judging.LIMITS[k]}
                            for k, v in numbers.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class _Terminated(BaseException):
    pass


def _on_term(signum, frame):
    raise _Terminated()


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    signal.signal(signal.SIGTERM, _on_term)
    root = os.getcwd()
    try:
        cell = spec.load_cell(root, args.workload)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    dev, why = device_info(cell.chips)
    if dev is None:
        print(f"portbench: {why}; no result", file=sys.stderr)
        return 1
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program ({PROGRAM}) is not in this "
              f"checkout; no result", file=sys.stderr)
        return 1
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          root, cards=cell.chips)
    except _Terminated:
        print("portbench: terminated", file=sys.stderr)
        return 143
    if result is None:
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: this process holds {', '.join(loaded)}; "
              f"no result", file=sys.stderr)
        return 1
    result["device"] = {**dev, **result["device"]}
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
