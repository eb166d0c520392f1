#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pandepth_tpu_torch``) on one
NVIDIA GPU. Run it from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi)
2. build    nvcc build of pandepth_tpu_torch/csrc/sweep_kernels.cu
3. setup    in a subprocess: libpancov_io, the native BAM feed, built
            and loaded (rebuilt with zlib alone where the libdeflate it
            linked does not load); the golden BAM of tests/fixtures.py;
            bench.py's own 8M-read, 3 Gb-shape BAM (12 x 250 Mb contigs,
            150 bp reads, seed 42), generated into _smoke/ or reused
4. kernels  pack_events, sweep_scan and eval_pair against their plain
            PyTorch twins on the card, array-equal: at the main path's
            shapes (the events and chr segments that
            pandepth_tpu_torch.run.stage feeds from the fixture) and on
            edge cases (every position tier, wrap18, min_dep=3, sentinel
            tails); the time of each beside its twin's
5. golden   the port's CLI on cuda over the golden fixture: the chr
            table byte-equal to tests/golden/chr.chr.stat.gz.txt
6. e2e      the port's CLI on cuda over the 8M-read fixture, twice in
            this process (steady state: torch, CUDA and both libraries
            already loaded) and once as a fresh
            ``python -m pandepth_tpu_torch.cli`` (what a user waits for);
            wall times, reads/s and the launches of every kernel in the
            first run (all > 0); every chr table byte-equal to the
            jax-free native host sweep's (pandepth_tpu.cli with
            PANDEPTH_HOST_FINALIZE=1, also a subprocess)

Then one JSON line of kernel results, and last
``{"ok": true, "device": {...}}``. This process imports nothing but
torch and pandepth_tpu_torch (which reuses the jax-free half of
pandepth_tpu); the fixtures and the host sweep run in subprocesses.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "_smoke")
SOURCE = "pandepth_tpu_torch/csrc/sweep_kernels.cu"
REPLACES = {"pack_events": "pandepth_tpu/device/engine.py:43",
            "sweep_scan": "pandepth_tpu/device/sweep.py:38",
            "eval_pair": "pandepth_tpu/device/sweep.py:66"}
N_READS = 8_000_000


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: {phase} failed: {msg}")


def chr_table(prefix: str) -> bytes:
    with gzip.open(prefix + ".chr.stat.gz", "rb") as fh:
        return fh.read()


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# Set-up that needs the JAX package's jax-free modules directly, run in a
# subprocess: argv = golden BAM path. The fixtures module is loaded by
# path, because another installed package may own the name "tests".
SETUP = r"""
import importlib.util, os, subprocess, sys

from pandepth_tpu.io import native

try:
    lib = native.load_library()
    print("libpancov_io loads as built")
except OSError as e:
    ldd = subprocess.run(["ldd", native._LIB], capture_output=True,
                         text=True).stdout
    missing = "; ".join(l.strip() for l in ldd.splitlines()
                        if "not found" in l)
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                    "-shared", "-fPIC", "-o", native._LIB, native._SRC,
                    "-lz", "-lpthread"], check=True)
    print(f"libpancov_io did not load ({missing or e}); REBUILT WITHOUT "
          f"libdeflate, so the feed inflates with zlib")
    lib = native.load_library()
if lib is None:
    sys.exit(f"libpancov_io does not build: {native.build_error()}")

spec = importlib.util.spec_from_file_location(
    "pandepth_test_fixtures", os.path.join("tests", "fixtures.py"))
fixtures = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fixtures)
fixtures.make_bam(sys.argv[1], n=800, seed=11)

import bench

print(bench.ensure_fixture())
"""


def setup(golden_bam: str) -> str:
    """Native library, golden BAM and bench.py's 8M-read fixture (made by
    bench.ensure_fixture itself, seed 42); returns the fixture's path."""
    env = dict(os.environ, PANDEPTH_BENCH_DIR=CACHE,
               PANDEPTH_BENCH_READS=str(N_READS))
    r = subprocess.run([sys.executable, "-c", SETUP, golden_bam], cwd=ROOT,
                       env=env, capture_output=True, text=True)
    if r.returncode != 0:
        fail("setup", f"exited {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        say("setup", line)
    return lines[-1]


class KernelCheck:
    """Kernel-against-twin comparisons and timings, per kernel."""

    def __init__(self):
        self.err = {k: 0 for k in REPLACES}
        self.cases = {k: 0 for k in REPLACES}
        self.ms = {}
        self.plain_ms = {}

    def compare(self, name: str, got, want, what: str) -> None:
        import torch

        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail("kernels", f"{name} {what}: {g.dtype}{tuple(g.shape)} "
                                f"vs twin {w.dtype}{tuple(w.shape)}")
            if g.numel():
                d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
                self.err[name] = max(self.err[name], int(d))
            if not torch.equal(g, w):
                fail("kernels", f"{name} {what}: differs from its twin")
        self.cases[name] += 1

    def case(self, raw_s, raw_e, sentinel: int, lo, hi, min_dep: int,
             wrap18: bool, what: str, timed: bool = False) -> None:
        """One input through all three kernels and their twins."""
        import torch

        from pandepth_tpu_torch.device import kernels, sweep
        from pandepth_tpu_torch.device.convert import tier_for_max

        tier = tier_for_max(sentinel)
        got = kernels.pack_events(raw_s, raw_e, tier)
        want = sweep.pack_events_reference(raw_s, raw_e, sentinel)
        self.compare("pack_events", got, want, what)
        pos, delta = got
        pos_s, order = torch.sort(pos, stable=True)
        delta_s = delta[order]
        got = kernels.sweep_scan(pos_s, delta_s, min_dep, wrap18, sentinel)
        want = sweep.sweep_scan_reference(pos_s, delta_s, min_dep, wrap18,
                                          sentinel)
        self.compare("sweep_scan", got, want, what)
        depth, c_cov, c_sum = got
        got = kernels.eval_pair(pos_s, depth, c_cov, c_sum, min_dep, lo, hi)
        want = sweep.eval_pair_reference(pos_s, depth, c_cov, c_sum,
                                         min_dep, lo, hi)
        self.compare("eval_pair", got, want, what)
        if not timed:
            return
        self.ms["pack_events"] = cuda_ms(
            lambda: kernels.pack_events(raw_s, raw_e, tier))
        self.plain_ms["pack_events"] = cuda_ms(
            lambda: sweep.pack_events_reference(raw_s, raw_e, sentinel))
        self.ms["sweep_scan"] = cuda_ms(
            lambda: kernels.sweep_scan(pos_s, delta_s, min_dep, wrap18,
                                       sentinel))
        self.plain_ms["sweep_scan"] = cuda_ms(
            lambda: sweep.sweep_scan_reference(pos_s, delta_s, min_dep,
                                               wrap18, sentinel))
        self.ms["eval_pair"] = cuda_ms(
            lambda: kernels.eval_pair(pos_s, depth, c_cov, c_sum, min_dep,
                                      lo, hi))
        self.plain_ms["eval_pair"] = cuda_ms(
            lambda: sweep.eval_pair_reference(pos_s, depth, c_cov, c_sum,
                                              min_dep, lo, hi))
        self.sort_ms = cuda_ms(lambda: torch.sort(pos, stable=True))


def edge_cases(check: KernelCheck, dev) -> None:
    """Random events on every tier with duplicates, sentinel tails, a
    deep pileup past 18 bits, and queries inside, on and past the
    events."""
    import numpy as np
    import torch

    rng = np.random.RandomState(3)
    tiers = [(np.int32, 2_000_000_000), (np.uint32, 4_200_000_000),
             (np.int64, 17_000_000_000)]
    for np_dt, span in tiers:
        sentinel = int(np.iinfo(np_dt).max)
        raw_np = np.int64 if np_dt is np.int64 else np.int32
        for n_pairs in (3000, 700_000):
            s = rng.randint(0, span - 1000, n_pairs).astype(np.int64)
            s[: n_pairs // 10] = s[0]                 # duplicates
            e = s + rng.randint(0, 400, n_pairs)
            deep = 270_000 if n_pairs > 3000 else 0   # past 2^18
            s = np.concatenate([s, np.full(deep, span // 2, np.int64)])
            e = np.concatenate([e, np.full(deep, span // 2 + 77, np.int64)])
            tail = 97                                  # sentinel tail
            s = np.concatenate([s, np.full(tail, sentinel, np.int64)])
            e = np.concatenate([e, np.full(tail, sentinel, np.int64)])
            raw_s = torch.from_numpy(s.astype(np_dt).view(raw_np)).to(dev)
            raw_e = torch.from_numpy(e.astype(np_dt).view(raw_np)).to(dev)
            q = np.sort(rng.randint(0, span, 600)).astype(np.int64)
            q[:50] = s[:50]                            # on event positions
            q_dt = np.int32 if np_dt is np.int32 else np.int64
            lo = torch.from_numpy(q[0::2].astype(q_dt)).to(dev)
            hi = torch.from_numpy(q[1::2].astype(q_dt)).to(dev)
            for min_dep in (1, 3):
                for wrap18 in (False, True):
                    check.case(raw_s, raw_e, sentinel, lo, hi, min_dep,
                               wrap18, f"{np.dtype(np_dt).name} "
                               f"pairs={n_pairs} min_dep={min_dep} "
                               f"wrap18={wrap18}")


def main_path_case(check: KernelCheck, bam: str, dev):
    """The fixture's own staged events and chr segments, as the port's
    run stages them for the kernels; returns (events, segments, tier
    name)."""
    from pandepth_tpu_torch.cli import parse_args
    from pandepth_tpu_torch.run import stage

    st = stage(parse_args(["pandepth", "-i", bam, "-o", os.devnull]), dev)
    eng, t = st.engine, st.targets
    raw_s, raw_e = eng.upload_staged()
    lo, hi = eng.segment_bounds(t.gene_tid[t.seg_gene], t.seg_start,
                                t.seg_end)
    q_lo, q_hi = eng.queries(lo, hi)
    check.case(raw_s, raw_e, eng.pos_sentinel, q_lo, q_hi, eng.min_dep,
               eng.wrap18, f"main path ({eng.pos_dtype.__name__} tier)",
               timed=True)
    return 2 * int(raw_s.shape[0]), int(q_lo.shape[0]), \
        eng.pos_dtype.__name__


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from pandepth_tpu_torch.cli import main as port_main
        from pandepth_tpu_torch.device import kernels
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    os.makedirs(CACHE, exist_ok=True)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; {torch.cuda.device_count()} "
                  f"visible")

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    say("build", f"{time.perf_counter() - t0:.2f} s "
                 f"({kernels.build_log.strip().count('Used')} kernels "
                 f"reported by ptxas)")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    with tempfile.TemporaryDirectory(dir=CACHE) as tmp:
        # 3. set-up
        t0 = time.perf_counter()
        gbam = os.path.join(tmp, "golden.bam")
        bam = setup(gbam)
        say("setup", f"{bam} ({os.path.getsize(bam)} bytes) "
                     f"{time.perf_counter() - t0:.1f} s")

        # 4. kernels against their twins
        check = KernelCheck()
        edge_cases(check, dev)
        n_events, n_segs, tier = main_path_case(check, bam, dev)
        torch.cuda.synchronize()
        for k in REPLACES:
            say("kernels", f"{k}: {check.cases[k]} cases array-equal to "
                           f"the twin; main path ({n_events} events, "
                           f"{n_segs} segments, {tier} tier) "
                           f"{check.ms[k]:.4f} ms, twin "
                           f"{check.plain_ms[k]:.4f} ms")
        say("kernels", f"library stable sort at the main path: "
                       f"{check.sort_ms:.4f} ms")

        # 5. golden
        if port_main(["pandepth", "-i", gbam, "-o",
                      os.path.join(tmp, "golden")], device=dev) != 0:
            fail("golden", "the port's CLI exited non-zero")
        with open(os.path.join(ROOT, "tests", "golden",
                               "chr.chr.stat.gz.txt"), "rb") as fh:
            if chr_table(os.path.join(tmp, "golden")) != fh.read():
                fail("golden", "chr table differs from the golden file")
        say("golden", "chr table byte-equal to "
                      "tests/golden/chr.chr.stat.gz.txt")

        # 6. the real-size main path: the counted run, in this process
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = port_main(["pandepth", "-i", bam, "-o",
                        os.path.join(tmp, "port"), "-v"], device=dev)
        wall = time.perf_counter() - t0
        runs = dict(kernels.launches)
        if rc != 0:
            fail("e2e", f"the port's CLI exited {rc}")
        if min(runs.values()) < 1:
            fail("e2e", f"a kernel was not launched on the main path: "
                        f"{runs}")
        t0 = time.perf_counter()
        if port_main(["pandepth", "-i", bam, "-o",
                      os.path.join(tmp, "port2")], device=dev) != 0:
            fail("e2e", "the port's second run exited non-zero")
        wall2 = time.perf_counter() - t0
        # a user's run: a fresh process that imports torch, makes its CUDA
        # context and loads both libraries (the kernels are built already)
        t0 = time.perf_counter()
        cold = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch.cli",
                               "-i", bam, "-o", os.path.join(tmp, "cold"),
                               "-v"], cwd=ROOT, capture_output=True,
                              text=True)
        cold_wall = time.perf_counter() - t0
        if cold.returncode != 0:
            fail("e2e", f"the port's CLI process exited {cold.returncode}: "
                        f"{cold.stderr[-2000:]}")
        cold_run = [ln for ln in cold.stderr.splitlines()
                    if ln.startswith("INFO: wall=")]
        env = dict(os.environ, PANDEPTH_HOST_FINALIZE="1")
        t0 = time.perf_counter()
        host = subprocess.run([sys.executable, "-m", "pandepth_tpu.cli",
                               "-i", bam, "-o", os.path.join(tmp, "host")],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True)
        host_wall = time.perf_counter() - t0
        if host.returncode != 0:
            fail("e2e", f"host sweep exited {host.returncode}: "
                        f"{host.stderr[-2000:]}")
        port_tab = chr_table(os.path.join(tmp, "port"))
        for other in ("host", "port2", "cold"):
            if chr_table(os.path.join(tmp, other)) != port_tab:
                fail("e2e", f"chr table of the {other} run differs from "
                            f"the port's")
        say("e2e", f"chr mode, {N_READS} reads, CLI process (user wall): "
                   f"{cold_wall:.3f} s ({N_READS / cold_wall:.0f} reads/s); "
                   f"its run alone {cold_run[-1][6:] if cold_run else '?'}")
        say("e2e", f"in this process (steady state): {wall:.3f} s "
                   f"({N_READS / wall:.0f} reads/s), again {wall2:.3f} s "
                   f"({N_READS / wall2:.0f} reads/s); launches {runs}")
        say("e2e", f"all chr tables byte-equal to the host sweep's "
                   f"({len(port_tab.splitlines())} lines; host sweep CLI "
                   f"process {host_wall:.3f} s)")

    if "jax" in sys.modules:
        fail("imports", "jax was imported")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": runs[k],
         "max_abs_err": check.err[k], "ms": check.ms[k],
         "plain_ms": check.plain_ms[k]} for k in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
