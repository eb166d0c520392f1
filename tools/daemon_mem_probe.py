#!/usr/bin/env python3
"""Does the resident daemon's device memory grow after its first request?
Runs ``--requests`` chr runs through one daemon on bench.py's 8M-read chr
fixture (``synth.bench_bam``, written into ``_smoke/`` or reused) and
reads the daemon's ``stat`` after each: the card's used bytes
(``torch.cuda.mem_get_info``, every context on the card; this process
makes none), the caching allocator's reserved and allocated bytes, and
the context's stack size (``cuCtxGetLimit``). Each ``--way NAME=K=V,...``
starts a daemon of its own with those variables in its environment
(``NAME=`` alone: the environment as it is), one way after another;
after its last request the daemon is read ``--idle`` more times, a
second apart, with no request between. ``--pause SECONDS`` reads it
every half second for that long after the first request, before the
others; ``--lives N`` runs each way N times, a fresh daemon each. ``--hold`` gives this process a
CUDA context of its own first, used under ``torch.profiler`` as
``chip_smoke.py``'s profile phase uses its own, and reads the card's
used bytes before each daemon starts and after it stopped; ``--smi``
queries ``nvidia-smi``'s compute processes after each request, as
``chip_smoke.py``'s daemon phase does. ``--copies N`` instead runs no
daemon: in this process, N rounds of host->device and device->host
copies of fresh numpy arrays (1, 16 and 128 MiB, a page's jitter each),
once from pageable memory and once through one pinned buffer kept for
all rounds, reading the card's used bytes after each round.
``--inproc N`` runs no daemon either: N chr runs through the daemon's
own ``_Server._run_one`` in this process (under the caller's
``CUDA_MODULE_LOADING``), reading the card's used bytes around each of the engine's upload,
sweep and eval steps and after each run; with ``--served`` the same
``_Server`` serves them on a thread of this process, each run sent by a
client process as the daemon's are. ``--watch SECONDS`` runs
nothing on the card: this process holds a context, idle, and reads the
card's used bytes every quarter second, printing each change.

    python3 tools/daemon_mem_probe.py [--requests N] [--way ...]
                                      [--reads N] [--idle N] [--hold] [--smi]
                                      [--copies N] [--inproc N]
                                      [--served] [--watch SECONDS]
                                      [--pause SECONDS] [--lives N]
                                      [--out FILE]

Prints one line a request, then one JSON line with every reading,
appended to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 8_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--way", action="append", default=[])
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--idle", type=int, default=5)
    ap.add_argument("--hold", action="store_true")
    ap.add_argument("--smi", action="store_true")
    ap.add_argument("--copies", type=int, default=0)
    ap.add_argument("--inproc", type=int, default=0)
    ap.add_argument("--watch", type=float, default=0)
    ap.add_argument("--served", action="store_true")
    ap.add_argument("--pause", type=float, default=0)
    ap.add_argument("--lives", type=int, default=1)
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    from pandepth_tpu_torch import serve, synth
    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.io import native

    import torch

    if torch.cuda.is_available():
        kernels.library()
    try:
        native.load_library()
    except OSError as e:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", "-o", native._LIB, native._SRC,
                        "-lz", "-lpthread"], check=True)
        print(f"libpancov_io did not load ({e}); rebuilt with zlib alone",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    bam = None if (a.copies or a.watch) and not a.inproc else \
        synth.bench_bam(os.path.join(ROOT, "_smoke"), a.reads)
    ways = {}
    for w in a.way or ["as_is="]:
        name, _, kv = w.partition("=")
        for life in range(a.lives):
            ways[f"{name}{life}" if a.lives > 1 else name] = dict(
                p.split("=", 1) for p in kv.split(",") if p)
    got = {"card": smi.stdout.strip(), "reads": a.reads, "hold": a.hold,
           "smi": a.smi, "ways": {}}

    def card_used():
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        return total - free

    if a.copies or a.inproc or a.watch:
        if a.watch:
            got["watch"] = watch(card_used, a.watch)
        if a.copies:
            got["copies"] = copy_rounds(torch, card_used, a.copies)
        if a.inproc:
            got["inproc"] = inproc_rounds(card_used, bam, a.inproc,
                                          a.served)
        print(json.dumps(got), flush=True)
        if a.out:
            with open(a.out, "a") as fh:
                fh.write(json.dumps(got) + "\n")
        return 0
    if a.hold:
        from torch.profiler import ProfilerActivity, profile

        x = torch.randint(0, 1 << 40, (1 << 22,), device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cumsum(torch.sort(x)[0], 0)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in ways.items():
            sock = os.path.join(tmp, f"{name}.sock")
            env = dict(os.environ, PANDEPTH_DAEMON="1",
                       PANDEPTH_DAEMON_REQUIRE="1",
                       PANDEPTH_DAEMON_SOCK=sock,
                       PANDEPTH_DAEMON_IDLE_S="300", **extra)
            rows, idle, paused = [], [], []
            before = card_used() if a.hold else None
            try:
                for k in range(a.requests):
                    t0 = time.perf_counter()
                    r = subprocess.run(
                        [sys.executable, "-m", "pandepth_tpu_torch", "-i",
                         bam, "-o", os.path.join(tmp, f"{name}{k}")],
                        cwd=ROOT, env=env, capture_output=True, text=True,
                        timeout=600)
                    wall = time.perf_counter() - t0
                    if r.returncode != 0:
                        raise SystemExit(f"{name} request {k} exited "
                                         f"{r.returncode}: {r.stderr[-2000:]}")
                    os.environ["PANDEPTH_DAEMON_SOCK"] = sock
                    st = serve.daemon_stat()
                    row = {"wall": round(wall, 3),
                           **{key: st.get(key) for key in (
                               "cuda_used", "cuda_reserved",
                               "cuda_allocated", "cuda_stack", "rss_mb")}}
                    if a.smi:
                        subprocess.run(["nvidia-smi", "--query-compute-apps="
                                        "pid,used_memory", "--format=csv,"
                                        "noheader,nounits"],
                                       capture_output=True, text=True)
                    rows.append(row)
                    print(f"{name} request {k}: {row}", flush=True)
                    if k == 0 and a.pause:
                        t1, last = time.perf_counter(), row["cuda_used"]
                        while time.perf_counter() - t1 < a.pause:
                            time.sleep(0.5)
                            u = serve.daemon_stat().get("cuda_used")
                            if u != last:
                                paused.append((round(time.perf_counter()
                                                     - t1, 2), u - last))
                                last = u
                        print(f"{name}: steps while paused (s after the "
                              f"first request, bytes) {paused}", flush=True)
                for _ in range(a.idle):
                    time.sleep(1)
                    idle.append(serve.daemon_stat().get("cuda_used"))
                print(f"{name}: used bytes a second apart with no "
                      f"request: {idle}", flush=True)
            finally:
                subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                                "--daemon-stop"], cwd=ROOT, env=env,
                               timeout=120)
                time.sleep(2)
            after = card_used() if a.hold else None
            if a.hold:
                print(f"{name}: the card's used bytes before the daemon "
                      f"started {before}, after it stopped {after}",
                      flush=True)
            grew = [k for k in range(1, len(rows))
                    if (rows[k]["cuda_used"] or 0) > (rows[0]["cuda_used"] or 0)]
            print(f"{name}: used bytes above the first request's after "
                  f"requests {grew}; first {rows[0]['cuda_used']}, last "
                  f"{rows[-1]['cuda_used']}", flush=True)
            got["ways"][name] = {"env": extra, "rows": rows, "grew": grew,
                                 "idle": idle, "paused": paused,
                                 "before": before,
                                 "after": after}
    print(json.dumps(got), flush=True)
    if a.out:
        with open(a.out, "a") as fh:
            fh.write(json.dumps(got) + "\n")
    return 0


def watch(card_used, seconds: float) -> dict:
    """Every change of the card's used bytes over ``seconds`` while this
    process holds an idle context: (s from the start, bytes, step)."""
    t0 = time.perf_counter()
    first = last = card_used()
    steps, n = [], 0
    while time.perf_counter() - t0 < seconds:
        time.sleep(0.25)
        u = card_used()
        n += 1
        if u != last:
            steps.append((round(time.perf_counter() - t0, 2), u, u - last))
            last = u
    print(f"watch: {n} readings over {seconds} s, the card's used bytes "
          f"{first} to {last}; changes (s, bytes, step) {steps}", flush=True)
    return {"first": first, "last": last, "readings": n, "steps": steps}


def inproc_rounds(card_used, bam: str, rounds: int,
                  served: bool = False) -> dict:
    """The card's used bytes after each of ``rounds`` chr runs through
    ``_Server._run_one`` in this process, and each step of them by the
    engine method it fell in (round, bytes) or between them."""
    from pandepth_tpu_torch import serve
    from pandepth_tpu_torch.device.engine import CoverageEngine

    at = {"round": 0}
    steps = {}

    def wrap(name):
        f = getattr(CoverageEngine, name)

        def g(*args, **kw):
            u0 = card_used()
            try:
                return f(*args, **kw)
            finally:
                d = card_used() - u0
                if d:
                    steps.setdefault(name, []).append((at["round"], d))
        setattr(CoverageEngine, name, g)

    for name in ("_upload", "_flush_block", "sweep_state",
                 "segment_stats"):
        wrap(name)
    run_one = serve._Server._run_one

    def whole(self, req, fds):
        u0 = card_used()
        try:
            return run_one(self, req, fds)
        finally:
            d = card_used() - u0
            if d:
                steps.setdefault("_run_one", []).append((at["round"], d))
    serve._Server._run_one = whole
    used = []
    env = {k: v for k, v in os.environ.items() if k.startswith("PANDEPTH_")}
    with tempfile.TemporaryDirectory() as tmp:
        srv = serve._Server(os.path.join(tmp, "d.sock"))
        if served:
            import threading

            threading.Thread(target=srv.serve, args=(600,),
                             daemon=True).start()
            while not os.path.exists(srv.path):
                time.sleep(0.05)
            cenv = dict(os.environ, PANDEPTH_DAEMON="1",
                        PANDEPTH_DAEMON_REQUIRE="1",
                        PANDEPTH_DAEMON_SOCK=srv.path)
        for k in range(rounds):
            at["round"] = k
            out = os.path.join(tmp, "r")
            if served:
                rc = subprocess.run(
                    [sys.executable, "-m", "pandepth_tpu_torch", "-i", bam,
                     "-o", out], cwd=ROOT, env=cenv, capture_output=True,
                    timeout=600).returncode
            else:
                fds = [os.open(os.devnull, os.O_RDWR) for _ in range(3)]
                rc = srv._run_one({"argv": ["-i", bam, "-o", out],
                                   "cwd": tmp, "env": env}, fds)["rc"]
            if rc != 0:
                raise SystemExit(f"in-process run {k} exited {rc}")
            used.append(card_used())
        if served:
            serve._request(srv.path, {"cmd": "stop"})
    grew = [(k, used[k] - used[k - 1]) for k in range(1, rounds)
            if used[k] != used[k - 1]]
    inside = {n: [st for st in v if st[0] > 0] for n, v in steps.items()}
    print(f"inproc (served {served}): {rounds} runs, the card's used bytes {used[0]} to "
          f"{used[-1]}; steps after a run (run, bytes) {grew}; steps "
          f"inside the engine's methods after the first run {inside}",
          flush=True)
    return {"used": used, "grew": grew, "steps": steps}


def copy_rounds(torch, card_used, rounds: int) -> dict:
    """The card's used bytes after each round of copies, pageable and
    pinned; prints each step."""
    import numpy as np

    rng = np.random.default_rng(0)
    sizes = (1 << 20, 16 << 20, 128 << 20)
    dev = torch.device("cuda")
    pinned = torch.empty(max(sizes) + 4096, dtype=torch.uint8,
                         pin_memory=True)
    out = {}
    for way in ("pageable", "pinned"):
        used = [card_used()]
        for _ in range(rounds):
            for n in sizes:
                n += int(rng.integers(0, 4096))
                h = np.full(n, 7, dtype=np.uint8)
                if way == "pageable":
                    d = torch.from_numpy(h).to(dev)
                    back = d.cpu().numpy()
                else:
                    pinned[:n].copy_(torch.from_numpy(h))
                    d = pinned[:n].to(dev, non_blocking=True)
                    torch.cuda.synchronize()
                    pinned[:n].copy_(d, non_blocking=True)
                    torch.cuda.synchronize()
                    back = pinned[:n].numpy()
                assert back[n - 1] == 7
                del d, h, back
            used.append(card_used())
        steps = [(k, used[k] - used[k - 1]) for k in range(1, len(used))
                 if used[k] != used[k - 1]]
        print(f"copies {way}: {rounds} rounds, the card's used bytes "
              f"{used[0]} to {used[-1]}; steps (round, bytes) {steps}",
              flush=True)
        out[way] = {"first": used[0], "last": used[-1], "steps": steps}
    return out


if __name__ == "__main__":
    sys.exit(main())
