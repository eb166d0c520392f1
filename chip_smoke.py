#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pandepth_tpu_torch``) on one
NVIDIA GPU. Run it from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi)
2. build    nvcc build of pandepth_tpu_torch/csrc/sweep_kernels.cu
3. setup    in a subprocess: libpancov_io, the native BAM feed, built
            and loaded (rebuilt with zlib alone where the libdeflate it
            linked does not load); the golden fixtures of
            tests/fixtures.py (BAM, and the same records as SAM and as
            CRAM, BED, GFFs, FASTA); bench.py's own 8M-read, 3 Gb-shape
            BAM (12 x 250 Mb contigs, 150 bp reads, seed 42), generated
            into _smoke/ or reused; an exome-sized BED over it (200,000
            regions of 150-300 bp, seed 5); bench3gb.py's .list samples
            (two 4M-read BAMs on the same contigs, its
            _gen_list_extra_fixture) and its 8M-line PAF
            (_write_paf_fixture); an unsorted 8M-read BAM (bench.py's
            generator without its sort, no index)
4. kernels  every kernel against its plain PyTorch twin on the card,
            array-equal, at the shapes of every main path of phase 6:
            the state that pandepth_tpu_torch.run.stage builds from the
            fixture for chr with raw pairs (PANDEPTH_ENC=0: pack_events,
            sweep_scan, eval_pair, eval_boundaries on 300 chr segments;
            timed), for bed (the same on the exome BED's staged pairs and
            its 200,000 regions), for the CIGAR feed
            (PANDEPTH_NO_NATIVE=1: sweep_scan, eval_pair, eval_boundaries
            on every batch's extract_events output), and for chr and the
            .list with encoded windows (the card's default: decode_enc on
            every stacked block, timed, and the whole finalize_encoded),
            and for the unsorted BAM (the card's default, whose windows
            the encoder cuts short: all of them staged as raw pairs);
            extract_events and eval_boundaries on the fixture's first
            2^20-read batch as pandepth_tpu_torch.run.read_batches yields
            it (one op per read; timed) and extract_events on a seeded
            2^20-read multi-op batch on the fixture's layout (timed); all
            of them on edge cases (every position tier, wrap18,
            min_dep=3, sentinel tails, every CIGAR op, filters, clipping,
            zero-op reads, JAX-style padding, a 70,000-op read; every
            code group, escapes in both planes, zero rows, partial
            blocks, windows of 2^19 and of 5,000 slots); the time of each
            beside its twin's; the Python decoder's time per batch; the
            code groups and blocks of each encoded path; the bytes each
            feed copies to the card and the copies' time
5. golden   the port's CLI on cuda over the golden fixtures: chr, bed,
            gene and gene_gc from the BAM, native with encoded windows,
            native with raw pairs and with PANDEPTH_NO_NATIVE=1, and chr
            from the SAM (both ways) and the CRAM; every table byte-equal
            to tests/golden/
6. e2e      the main paths at full size, each with every kernel count set
            to 0 just before it and read just after, and every kernel it
            runs launched at least once:
            chr     the port's CLI over the 8M-read fixture with raw pairs
                    (PANDEPTH_ENC=0), twice in this process; wall times,
                    reads/s
            chr_enc the same with the card's default, encoded windows
                    (decode_enc); then once as a fresh ``python -m
                    pandepth_tpu_torch.cli``; every chr table byte-equal
                    to the raw run's and to the jax-free native host
                    sweep's (pandepth_tpu.cli with PANDEPTH_HOST_FINALIZE=1,
                    a subprocess)
            cigar   the same with PANDEPTH_NO_NATIVE=1 (the Python decoder
                    and the extract_events kernel, >= 8 batches); its
                    table byte-equal to the native run's
            step    coverage_step (the fused single-device step) on the
                    fixture's first batch and the chr bounds
            bed     -b with the exome BED (indexed fetch windows, ranged
                    native stream, PANDEPTH_ENC=0); the table byte-equal
                    to the host sweep's
            list    the .list of the 8M-read fixture and the two 4M-read
                    samples (16M reads pooled, encoded windows); the
                    table byte-equal to the host sweep's
            paf     the 8M-line PAF (the native PAF loader, raw pairs); the
                    chr table byte-equal to the host sweep's
            unsorted the unsorted BAM with the card's default and with raw
                    pairs: no window reaches decode_enc, the peak device
                    memory of each; both tables byte-equal to the host
                    sweep's
7. profile  the cigar, bed, chr_enc and chr runs once more under
            torch.profiler: host wall, device time (the sum of every op's
            self device time), the device's busy share, the host->device
            copies' time, the largest ops, the peak device memory; tables
            byte-equal to phase 6's

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
            "eval_pair": "pandepth_tpu/device/sweep.py:66",
            "extract_events": "pandepth_tpu/device/events.py:40",
            "eval_boundaries": "pandepth_tpu/device/sweep.py:89",
            "decode_enc": "pandepth_tpu/device/sweep.py:205"}
# what each main path must launch
PATHS = {"chr": ("pack_events", "sweep_scan", "eval_pair"),
         "chr_enc": ("decode_enc", "sweep_scan", "eval_pair"),
         "cigar": ("extract_events", "sweep_scan", "eval_pair"),
         "step": ("extract_events", "sweep_scan", "eval_boundaries"),
         "bed": ("pack_events", "sweep_scan", "eval_pair"),
         "list": ("decode_enc", "sweep_scan", "eval_pair"),
         "paf": ("pack_events", "sweep_scan", "eval_pair"),
         "unsorted": ("pack_events", "sweep_scan", "eval_pair")}
N_READS = 8_000_000
BATCH_READS = 1 << 20   # RunConfig.max_reads_per_batch
N_BED = 200_000
SENTINEL = 1 << 62      # JAX's extract_events sentinel
COLS = ("tid", "pos", "flag", "mapq", "op_code", "op_len", "op_read")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: {phase} failed: {msg}")


def table(prefix: str, kind: str = "chr") -> bytes:
    with gzip.open(f"{prefix}.{kind}.stat.gz", "rb") as fh:
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
# subprocess: argv = golden directory, N_BED. The fixtures module is
# loaded by path, because another installed package may own the name
# "tests". Prints the 8M-read fixture's path, then the exome BED's.
SETUP = r"""
import importlib.util, os, subprocess, sys

import numpy as np

from pandepth_tpu.io import native
from pandepth_tpu.io.bam_writer import cigar_str_to_ops
from pandepth_tpu.io.cram_writer import write_cram

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
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
d, n_bed = sys.argv[1], int(sys.argv[2])
recs = fx.make_bam(os.path.join(d, "golden.bam"), n=800, seed=11)
fx.make_bed(os.path.join(d, "t.bed"))
fx.make_gff(os.path.join(d, "t.gff"))
fx.make_gff(os.path.join(d, "safe.gff"), overhang=False)
fx.make_fasta(os.path.join(d, "ref.fa"))
names = [c[0] for c in fx.CONTIGS]
lengths = [c[1] for c in fx.CONTIGS]
# the golden records as SAM text (no index: every read counts) and as
# CRAM, which canonicalizes =/X to M (the same depth)
with open(os.path.join(d, "golden.sam"), "w") as fh:
    fh.write("@HD\tVN:1.6\tSO:coordinate\n")
    for name, ln in fx.CONTIGS:
        fh.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
    for i, (tid, pos, flag, mapq, cigar) in enumerate(recs):
        n_seq = sum(l for op, l in cigar_str_to_ops(cigar)
                    if op in (0, 1, 4, 7, 8)) if cigar != "*" else 0
        fh.write(f"r{i}\t{flag}\t{names[tid]}\t{pos + 1}\t{mapq}\t{cigar}"
                 f"\t*\t0\t0\t{'A' * n_seq if n_seq else '*'}\t*\n")
write_cram(os.path.join(d, "golden.cram"), names, lengths,
           [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
            for t, p, f, q, c in recs])

import bench

print(bench.ensure_fixture())
bed = os.path.join(os.path.dirname(bench.ensure_fixture()),
                   f"exome_{n_bed}.bed")
if not os.path.exists(bed):
    rng = np.random.RandomState(5)
    tid = np.sort(rng.randint(0, len(bench.GENOME), n_bed))
    ln = np.array([g[1] for g in bench.GENOME])[tid]
    start = (rng.rand(n_bed) * (ln - 400)).astype(np.int64)
    end = start + rng.randint(150, 301, n_bed)
    order = np.lexsort((start, tid))
    with open(bed + ".tmp", "w") as fh:
        for k in order:
            fh.write(f"{bench.GENOME[tid[k]][0]}\t{start[k]}\t{end[k]}\n")
    os.replace(bed + ".tmp", bed)
print(bed)

import bench3gb

extra = [os.path.join(bench3gb.BENCH_DIR, f"bench3gb_s{k}.bam")
         for k in (2, 3)]
for k, path in zip((2, 3), extra):
    if not os.path.exists(path):
        bench3gb._gen_list_extra_fixture(path, k)
lst = os.path.join(bench3gb.BENCH_DIR, "bench3gb.list")
with open(lst, "w") as fh:
    fh.write("\n".join([bench.ensure_fixture()] + extra) + "\n")
print(lst)
paf = os.path.join(bench3gb.BENCH_DIR, "bench3gb.paf")
if not os.path.exists(paf):
    bench3gb._write_paf_fixture(paf)
print(paf)

# bench.py's generator without its coordinate sort: nearly every start
# delta escapes the encoder's codes, so it cuts each window short
uns = os.path.join(bench3gb.BENCH_DIR, f"unsorted_{bench.N_READS}.bam")
if not os.path.exists(uns):
    from pandepth_tpu.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(42)
    n = bench.N_READS
    lens = np.array([g[1] for g in bench.GENOME])
    tid = rng.randint(0, len(bench.GENOME), n).astype(np.int32)
    pos = (rng.rand(n) * (lens[tid] - 200)).astype(np.int32)
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    write_uniform_bam(uns + ".tmp", [g[0] for g in bench.GENOME],
                      [g[1] for g in bench.GENOME], tid, pos, flag, mapq,
                      make_index=False)
    os.replace(uns + ".tmp", uns)
print(uns)
"""


def setup(golden_dir: str):
    """Native library, golden fixtures, bench.py's 8M-read fixture (made
    by bench.ensure_fixture itself, seed 42), the exome BED, bench3gb.py's
    .list (the fixture and its two 4M-read samples), its PAF and the
    unsorted BAM; returns (fixture, BED, .list, PAF, unsorted) paths."""
    env = dict(os.environ, PANDEPTH_BENCH_DIR=CACHE,
               PANDEPTH_BENCH_READS=str(N_READS),
               PANDEPTH_BENCH3GB_READS=str(N_READS))
    r = subprocess.run([sys.executable, "-c", SETUP, golden_dir,
                        str(N_BED)], cwd=ROOT, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        fail("setup", f"exited {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-5]:
        say("setup", line)
    return lines[-5:]


class env:
    """Environment variables set (a value) or unset (None) inside the
    block, restored after it."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kw}
        self._apply(self.kw)

    def __exit__(self, *exc):
        self._apply(self.old)

    @staticmethod
    def _apply(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def no_native():
    """PANDEPTH_NO_NATIVE=1 inside the block: the Python decoders."""
    return env(PANDEPTH_NO_NATIVE="1")


def raw_pairs():
    """PANDEPTH_ENC=0 inside the block: the native feed stages raw pairs
    (pack_events) instead of the card's default, encoded windows."""
    return env(PANDEPTH_ENC="0")


class KernelCheck:
    """Kernel-against-twin comparisons and timings, per kernel."""

    def __init__(self):
        self.err = {k: 0 for k in REPLACES}
        self.cases = {k: 0 for k in REPLACES}
        self.ms = {}
        self.plain_ms = {}
        self.notes = []

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

    def time(self, name: str, kernel, twin, note: str = "") -> None:
        """The kernel's and the twin's times; with ``note`` they go to a
        note line instead of the kernel's JSON entry."""
        ms, plain_ms = cuda_ms(kernel), cuda_ms(twin)
        if note:
            self.notes.append(f"{name} on {note}: {ms:.4f} ms, twin "
                              f"{plain_ms:.4f} ms")
        else:
            self.ms[name], self.plain_ms[name] = ms, plain_ms

    def sweep_case(self, raw_s, raw_e, sentinel: int, lo, hi, min_dep: int,
                   wrap18: bool, what: str, timed: bool = False) -> None:
        """Staged start/end pairs through pack_events and its twin, then
        :meth:`state_case` on the packed events."""
        from pandepth_tpu_torch.device import kernels, sweep
        from pandepth_tpu_torch.device.convert import tier_for_max

        tier = tier_for_max(sentinel)
        got = kernels.pack_events(raw_s, raw_e, tier)
        want = sweep.pack_events_reference(raw_s, raw_e, sentinel)
        self.compare("pack_events", got, want, what)
        if timed:
            self.time("pack_events",
                      lambda: kernels.pack_events(raw_s, raw_e, tier),
                      lambda: sweep.pack_events_reference(raw_s, raw_e,
                                                          sentinel))
        self.state_case(*got, sentinel, lo, hi, min_dep, wrap18, what, timed)

    def state_case(self, pos, delta, sentinel: int, lo, hi, min_dep: int,
                   wrap18: bool, what: str, timed: bool = False) -> None:
        """Events through the library's stable sort, then sweep_scan,
        eval_pair and eval_boundaries and their twins."""
        import torch

        from pandepth_tpu_torch.device import kernels, sweep

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
        self.boundaries_case(pos_s, depth, c_cov, c_sum, min_dep,
                             torch.cat([lo, hi]), what)
        if not timed:
            return
        self.time("sweep_scan",
                  lambda: kernels.sweep_scan(pos_s, delta_s, min_dep,
                                             wrap18, sentinel),
                  lambda: sweep.sweep_scan_reference(pos_s, delta_s,
                                                     min_dep, wrap18,
                                                     sentinel))
        self.time("eval_pair",
                  lambda: kernels.eval_pair(pos_s, depth, c_cov, c_sum,
                                            min_dep, lo, hi),
                  lambda: sweep.eval_pair_reference(pos_s, depth, c_cov,
                                                    c_sum, min_dep, lo, hi))
        sort_ms = cuda_ms(lambda: torch.sort(pos, stable=True))
        self.notes.append(f"library stable sort of the native main path's "
                          f"{pos.shape[0]} events: {sort_ms:.4f} ms")

    def extract_case(self, cols, offsets, limits, flags_mask: int,
                     min_mapq: int, sentinel: int, pos_dtype, what: str,
                     timed: bool = False, note: str = ""):
        """One batch through extract_events and its twin; returns the
        kernel's events."""
        from pandepth_tpu_torch.device import events, kernels

        args = (*cols, offsets, limits, flags_mask, min_mapq)
        got = kernels.extract_events(*args, sentinel, pos_dtype)
        want = events.extract_events_reference(*args, sentinel, pos_dtype)
        self.compare("extract_events", got, want, what)
        if timed:
            self.time("extract_events",
                      lambda: kernels.extract_events(*args, sentinel,
                                                     pos_dtype),
                      lambda: events.extract_events_reference(
                          *args, sentinel, pos_dtype), note)
        return got

    def decode_cases(self, groups, pos_max: int, what: str,
                     timed: bool = False, note: str = "") -> None:
        """Each present code group through decode_enc and its twin; timed
        as the decode of every group, kernel against twins."""
        from pandepth_tpu_torch.device import sweep

        def decoders(g):
            if len(g) == 6:
                return (sweep.decode_const_group,
                        sweep.decode_const_group_reference)
            return sweep.decode_enc_group, sweep.decode_enc_group_reference

        present = [g for g in groups if g is not None]
        for g in present:
            kernel, twin = decoders(g)
            self.compare("decode_enc", kernel(*g, pos_max=pos_max),
                         twin(*g, pos_max=pos_max), what)
        if timed:
            self.time("decode_enc",
                      lambda: [decoders(g)[0](*g, pos_max=pos_max)
                               for g in present],
                      lambda: [decoders(g)[1](*g, pos_max=pos_max)
                               for g in present], note)

    def finalize_enc_case(self, groups, cp, cd, lo, hi, pos_max: int,
                          min_dep: int, wrap18: bool, what: str) -> None:
        """The whole finalize_encoded (decode_enc into one buffer, the
        library sort, sweep_scan, eval_pair) against its twin: all seven
        outputs."""
        from pandepth_tpu_torch.device import sweep

        args = (*groups, cp, cd, lo, hi)
        kw = dict(min_dep=min_dep, wrap18=wrap18, pos_max=pos_max)
        self.compare("decode_enc", sweep.finalize_encoded(*args, **kw),
                     sweep.finalize_encoded_reference(*args, **kw),
                     what + ", whole finalize_encoded")

    def boundaries_case(self, pos_s, depth, c_cov, c_sum, min_dep: int, x,
                        what: str, timed: bool = False) -> None:
        from pandepth_tpu_torch.device import kernels, sweep

        args = (pos_s, depth, c_cov, c_sum, min_dep, x)
        self.compare("eval_boundaries", kernels.eval_boundaries(*args),
                     sweep.eval_boundaries_reference(*args), what)
        if timed:
            self.time("eval_boundaries",
                      lambda: kernels.eval_boundaries(*args),
                      lambda: sweep.eval_boundaries_reference(*args))


def sweep_edge_cases(check: KernelCheck, dev) -> None:
    """Random events on every tier with duplicates, sentinel tails, a
    deep pileup past 18 bits, and queries inside, on and past the
    events: pack_events, sweep_scan, eval_pair and eval_boundaries."""
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
                    check.sweep_case(raw_s, raw_e, sentinel, lo, hi,
                                     min_dep, wrap18,
                                     f"{np.dtype(np_dt).name} "
                                     f"pairs={n_pairs} min_dep={min_dep} "
                                     f"wrap18={wrap18}")


def enc_edge_cases(check: KernelCheck, dev) -> None:
    """decode_enc on every code group of every tier: escapes in both
    planes of the mixed format and in the const format's delta plane
    (negative jumps wrap the uint32 tier), zero rows, short rows, a
    partial block, windows of 2^19 slots (256 scan tiles a row) and of
    5,000 (a ragged last tile); then the whole finalize_encoded over the
    four groups, a raw chunk with a sentinel tail and 300 queries."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device.convert import (enc_group_from_numpy,
                                                   positions_to_words)
    from pandepth_tpu_torch.synth import enc_group

    rng = np.random.RandomState(8)
    kinds = ((np.uint8, False), (np.uint16, False), (np.uint8, True),
             (np.uint16, True))
    for pos_dt, span in ((np.int32, 2_000_000_000),
                         (np.uint32, 4_200_000_000),
                         (np.int64, 17_000_000_000)):
        pm = int(np.iinfo(pos_dt).max)
        for cap, ce, rows in ((1 << 19, 1 << 13, (8, 3)),
                              (5000, 64, (2, 1))):
            groups = [enc_group_from_numpy(enc_group(
                rng, code_dt, pos_dt, 10_000, span - 100_000, const, rows,
                cap, ce)[0], pos_dt, dev) for code_dt, const in kinds]
            what = (f"{np.dtype(pos_dt).name} tier, blocks of {rows} rows x "
                    f"{cap} slots")
            check.decode_cases(groups, pm, what)
            s = rng.randint(0, span - 1000, 5000).astype(np.int64)
            s = np.concatenate([s, np.full(77, pm, np.int64)])
            e = np.where(s < pm, s + rng.randint(0, 500, s.shape[0]), pm)
            raw = torch.from_numpy(positions_to_words(np.concatenate([s, e]),
                                                      pos_dt)).to(dev)
            live = torch.from_numpy((s < pm).astype(np.int32)).to(dev)
            q = np.sort(rng.randint(0, span, 600))
            lo, hi = (torch.from_numpy(positions_to_words(x, pos_dt)).to(dev)
                      for x in (q[0::2], q[1::2]))
            for min_dep, wrap18 in ((1, False), (3, True)):
                check.finalize_enc_case(
                    groups, [raw], [torch.cat([live, -live])], lo, hi, pm,
                    min_dep, wrap18, f"{what}, min_dep={min_dep} "
                                     f"wrap18={wrap18}")


def device_cols(batch, dev):
    """A ReadBatch's seven int32 columns on ``dev``."""
    import numpy as np
    import torch

    return [torch.from_numpy(np.asarray(getattr(batch, c), np.int32)).to(dev)
            for c in COLS]


def extract_edge_cases(check: KernelCheck, dev) -> None:
    """extract_events on JAX's int64 output and on every engine tier,
    min_mapq -1/0/20, two flag masks, JAX-style padding and a 70,000-op
    read."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.synth import jax_padded, make_batch

    tiers = [([5000, 3200, 700], torch.int32, (1 << 31) - 1),
             ([1_900_000_000, 1_500_000_000], torch.int64, (1 << 32) - 1),
             ([3_000_000_000, 2_500_000_000], torch.int64, (1 << 63) - 1)]
    seed = 40
    for lengths, out_dtype, tier_sentinel in tiers:
        sizes = np.asarray(lengths, np.int64) + 512   # GenomeLayout's pad
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        lay = [torch.from_numpy(a.astype(np.int64)).to(dev)
               for a in (offsets, offsets + sizes)]
        for n, long_ops, pad in ((3000, 0, False), (3000, 0, True),
                                 (500, 70_000, True)):
            seed += 1
            b = make_batch(lengths, n, seed, long_read_ops=long_ops)
            cols = device_cols(jax_padded(b) if pad else b, dev)
            for min_mapq in (-1, 0, 20):
                for mask in (1796, 4):
                    for sentinel, dt in ((SENTINEL, torch.int64),
                                         (tier_sentinel, out_dtype)):
                        check.extract_case(
                            cols, *lay, mask, min_mapq, sentinel, dt,
                            f"lengths={lengths} n={n} long={long_ops} "
                            f"pad={pad} q={min_mapq} x={mask} "
                            f"sentinel={sentinel}")


def main_path_states(check: KernelCheck, bam: str, bed: str, lst: str,
                     uns: str, dev):
    """The device state that the port's run stages for each counted path,
    through the kernels and their twins: chr with raw pairs
    (PANDEPTH_ENC=0; staged pairs and the chr segments, timed), bed
    (PANDEPTH_ENC=0; the exome BED's staged pairs and its regions), cigar
    (PANDEPTH_NO_NATIVE=1; every batch's extract_events output, dead
    slots included, and the chr segments), chr_enc and list (the card's
    default, encoded windows; every stacked block through decode_enc,
    timed, and the whole finalize_encoded with the raw pairs of the
    windows staged on the host), and unsorted (the card's default; every
    window short, so staged pairs alone). Returns a description of each
    path's shape, and the bytes each path's feed copied to the card in
    how many copies, with the seconds those copies took (the engine's
    host clock around each synchronised copy: a copy from pageable
    memory holds the host until it is staged)."""
    import torch

    from pandepth_tpu_torch.cli import parse_args
    from pandepth_tpu_torch.device.engine import ENC_GROUPS, CoverageEngine
    from pandepth_tpu_torch.run import stage

    shapes, h2d = {}, {}
    CoverageEngine.time_copies = True
    for path, inp, extra, way in (
            ("chr", bam, [], raw_pairs), ("bed", bam, ["-b", bed], raw_pairs),
            ("cigar", bam, [], no_native), ("chr_enc", bam, [], env),
            ("list", lst, [], env), ("unsorted", uns, [], env)):
        cfg = parse_args(["pandepth", "-i", inp, *extra, "-o", os.devnull])
        with way():
            st = stage(cfg, dev)
        eng, t = st.engine, st.targets
        what = f"{path} path ({eng.pos_dtype.__name__} tier)"
        detail = ""
        n_win = sum(eng.n_windows.values())
        if n_win:
            detail = (f"{n_win} windows by group {eng.n_windows}; decoded "
                      f"whole, {2 * eng.enc_cap * n_win} events; ")
        if path == "cigar":
            cp, cd = eng._event_chunks()
            pos, delta = torch.cat(cp), torch.cat(cd)
            n_events = int(pos.shape[0])
        elif not eng._has_enc:
            raw_s, raw_e = eng.upload_staged()
            n_events = 2 * int(raw_s.shape[0])
        else:
            groups = eng._enc_args()
            cp, cd = eng._event_chunks()
            detail += (f"blocks "
                       f"{ {g: len(eng._enc[g]) for g in ENC_GROUPS} }, ")
            slots = sum(b[0].numel() // (1 if len(b) == 6 else 2)
                        for g in ENC_GROUPS for b in eng._enc[g])
            n_events = 2 * slots + sum(int(c.shape[0]) for c in cp)
        if path == "unsorted" and (eng._has_enc or eng.n_windows["raw"] < 2):
            fail("kernels", f"unsorted: windows not staged as raw pairs: "
                            f"{eng.n_windows}")
        h2d[path] = (eng.h2d_bytes, eng.h2d_copies, eng.h2d_seconds)
        lo, hi = eng.segment_bounds(t.gene_tid[t.seg_gene], t.seg_start,
                                    t.seg_end)
        q_lo, q_hi = eng.queries(lo, hi)
        args = (eng.pos_sentinel, q_lo, q_hi, eng.min_dep, eng.wrap18, what)
        if path == "cigar":
            check.state_case(pos, delta, *args)
        elif not eng._has_enc:
            check.sweep_case(raw_s, raw_e, *args, timed=path == "chr")
        else:
            check.decode_cases(groups, eng.pos_sentinel, what, timed=True,
                               note="" if path == "chr_enc" else what)
            check.finalize_enc_case(groups, cp, cd, q_lo, q_hi,
                                    eng.pos_sentinel, eng.min_dep,
                                    eng.wrap18, what)
        shapes[path] = (f"{path} path ({detail}{n_events} events, "
                        f"{int(q_lo.shape[0])} segments, "
                        f"{eng.pos_dtype.__name__} tier)")
        del st, eng, args
    CoverageEngine.time_copies = False
    return shapes, h2d


class FirstBatch:
    """The CIGAR feed's first batch of the fixture on the card: its seven
    columns, the layout, the chr segments' global bounds (int64) and the
    engine's tier. Reading it runs the Python decoder over the whole
    file; ``batch_s`` holds the seconds of each batch (the first one's
    include the whole-file inflate)."""

    def __init__(self, bam: str, dev):
        import numpy as np
        import torch

        from pandepth_tpu_torch.cli import parse_args
        from pandepth_tpu_torch.run import prepare, read_batches

        cfg = parse_args(["pandepth", "-i", bam, "-o", os.devnull])
        self.batch_s = []
        with no_native():
            st = prepare(cfg, dev)
            t0 = time.perf_counter()
            for i, b in enumerate(read_batches(bam, cfg, st.regions)):
                self.batch_s.append(time.perf_counter() - t0)
                if i == 0:
                    first = b
                t0 = time.perf_counter()
        b = first
        eng, t = st.engine, st.targets
        self.n, self.m = b.n_reads, b.n_total_ops
        self.cols = device_cols(b, dev)
        self.lengths = eng.layout.lengths
        self.offsets = torch.from_numpy(eng.layout.offsets).to(dev)
        self.limits = torch.from_numpy(eng.layout.limits).to(dev)
        lo, hi = eng.segment_bounds(t.gene_tid[t.seg_gene], t.seg_start,
                                    t.seg_end)
        self.lo = torch.from_numpy(lo.astype(np.int64)).to(dev)
        self.hi = torch.from_numpy(hi.astype(np.int64)).to(dev)
        self.sentinel = eng.pos_sentinel
        self.dtype = eng._dev_dtype
        self.tier = eng.pos_dtype.__name__
        self.flags_mask, self.min_mapq = cfg.flags, cfg.min_mapq


def main_path_cigar(check: KernelCheck, fb: FirstBatch, dev) -> None:
    """extract_events (the engine's tier, timed, and JAX's int64 output)
    and eval_boundaries (int64 sweep state of that batch, the 300 chr
    bounds, timed) against their twins at the CIGAR feed's shapes; then
    extract_events on a seeded multi-op batch of as many reads on the
    fixture's layout (timed), where the per-read rebase is not trivial."""
    import torch

    from pandepth_tpu_torch.device import sweep
    from pandepth_tpu_torch.synth import make_batch

    what = f"first batch ({fb.n} reads, {fb.m} ops, {fb.tier} tier)"
    check.extract_case(fb.cols, fb.offsets, fb.limits, fb.flags_mask,
                       fb.min_mapq, fb.sentinel, fb.dtype, what, timed=True)
    ev = check.extract_case(fb.cols, fb.offsets, fb.limits, fb.flags_mask,
                            fb.min_mapq, SENTINEL, torch.int64,
                            what + ", JAX's int64 output")
    st = sweep.sort_events(*ev)
    x = torch.cat([fb.lo, fb.hi])
    check.boundaries_case(*st[:4], 1, x, what + ", chr bounds",
                          timed=True)
    b = make_batch(fb.lengths, fb.n, seed=9)
    what = (f"a seeded multi-op batch ({b.n_reads} reads, {b.n_total_ops} "
            f"ops, 0-8 per read, every op code, {fb.tier} tier)")
    check.extract_case(device_cols(b, dev), fb.offsets, fb.limits,
                       fb.flags_mask, fb.min_mapq, fb.sentinel, fb.dtype,
                       what, timed=True, note=what)


def step_twin(fb: FirstBatch):
    """coverage_step as the composition of the plain twins."""
    from pandepth_tpu_torch.device import events, sweep

    ev = events.extract_events_reference(*fb.cols, fb.offsets, fb.limits,
                                         fb.flags_mask, fb.min_mapq)
    st = sweep.sort_events_reference(*ev)
    ql = sweep.eval_boundaries_reference(*st[:4], 1, fb.lo)
    qh = sweep.eval_boundaries_reference(*st[:4], 1, fb.hi)
    return qh[0] - ql[0], qh[1] - ql[1]


def counted(kernels, path: str, fn):
    """Run one main path with every kernel count set to 0 just before it;
    fail unless each kernel of the path launched. Returns (result,
    counts, wall seconds)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    runs = dict(kernels.launches)
    missing = [k for k in PATHS[path] if runs[k] < 1]
    if missing:
        fail("e2e", f"{path}: {missing} not launched on the path: {runs}")
    return out, runs, wall


def profiled(fn):
    """``fn`` once under torch.profiler. Returns (host wall s, device ms:
    the sum of the device's kernels and copies, the host->device copies'
    ms, the largest ops as (name, ms), peak device memory allocated in
    bytes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (host ops would count their kernels twice);
    # "Activity Buffer Request" is the profiler's own overhead
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "Activity Buffer Request"
                  and e.self_device_time_total > 0), key=lambda o: -o[1])
    return (wall, sum(ms for _, ms in ops),
            sum(ms for name, ms in ops if name.startswith("Memcpy HtoD")),
            ops[:6], torch.cuda.max_memory_allocated())


def golden(port_main, gdir: str, dev) -> int:
    """Every golden configuration the slice runs; returns the count."""
    gold = os.path.join(ROOT, "tests", "golden")
    modes = {"chr": [], "bed": ["-b", "{d}/t.bed"],
             "gene": ["-g", "{d}/t.gff", "-f", "CDS"],
             "gene_gc": ["-g", "{d}/safe.gff", "-c", "-r", "{d}/ref.fa"]}
    runs = [(f"{m} bam {way}", "golden.bam", m, way)
            for m in modes for way in ("native", "raw", "no_native")]
    runs += [("chr sam native", "golden.sam", "chr", "native"),
             ("chr sam no_native", "golden.sam", "chr", "no_native"),
             ("chr cram", "golden.cram", "chr", "native")]
    for what, inp, mode, way in runs:
        kind = "gene" if mode.startswith("gene") else mode
        args = ["pandepth", "-i", os.path.join(gdir, inp), "-o",
                os.path.join(gdir, "out"),
                *(a.format(d=gdir) for a in modes[mode])]
        with {"native": env, "raw": raw_pairs, "no_native": no_native}[way]():
            rc = port_main(args, device=dev)
        if rc != 0:
            fail("golden", f"{what}: the port's CLI exited {rc}")
        with open(os.path.join(gold, f"{mode}.{kind}.stat.gz.txt"),
                  "rb") as fh:
            if table(os.path.join(gdir, "out"), kind) != fh.read():
                fail("golden", f"{what}: table differs from the golden "
                               f"file")
    return len(runs)


def host_sweep(args, out: str):
    """The JAX package's jax-free native host sweep as a CLI process;
    returns its wall seconds."""
    env = dict(os.environ, PANDEPTH_HOST_FINALIZE="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu.cli", *args,
                        "-o", out], cwd=ROOT, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail("e2e", f"host sweep exited {r.returncode}: {r.stderr[-2000:]}")
    return wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from pandepth_tpu_torch.cli import main as port_main
        from pandepth_tpu_torch.device import kernels
        from pandepth_tpu_torch.device.step import coverage_step
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

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

    # the election under test is the card's default
    os.environ.pop("PANDEPTH_ENC", None)
    paths = {}
    with tempfile.TemporaryDirectory(dir=CACHE) as tmp:
        # 3. set-up
        t0 = time.perf_counter()
        bam, bed, lst, paf, uns = setup(tmp)
        say("setup", f"{bam} ({os.path.getsize(bam)} bytes), {bed}, {lst}, "
                     f"{paf} ({os.path.getsize(paf)} bytes), {uns} "
                     f"({os.path.getsize(uns)} bytes) "
                     f"{time.perf_counter() - t0:.1f} s")

        # 4. kernels against their twins
        check = KernelCheck()
        sweep_edge_cases(check, dev)
        extract_edge_cases(check, dev)
        enc_edge_cases(check, dev)
        states, h2d = main_path_states(check, bam, bed, lst, uns, dev)
        t0 = time.perf_counter()
        fb = FirstBatch(bam, dev)
        say("kernels", f"the fixture's {len(fb.batch_s)} batches through the "
                       f"Python decoder alone (no device) "
                       f"{time.perf_counter() - t0:.3f} s: the first "
                       f"(whole-file inflate and its decode) "
                       f"{fb.batch_s[0]:.3f} s, the other "
                       f"{len(fb.batch_s) - 1} {sum(fb.batch_s[1:]):.3f} s")
        main_path_cigar(check, fb, dev)
        torch.cuda.synchronize()
        shapes = {k: states["chr"]
                  for k in ("pack_events", "sweep_scan", "eval_pair")}
        shapes["extract_events"] = (f"first batch ({fb.n} reads, {fb.m} "
                                    f"ops, {fb.tier} tier)")
        shapes["eval_boundaries"] = (f"first batch's {2 * fb.m} int64 "
                                     f"events, {2 * fb.lo.shape[0]} bounds")
        shapes["decode_enc"] = states["chr_enc"]
        for k in REPLACES:
            say("kernels", f"{k}: {check.cases[k]} cases array-equal to "
                           f"the twin; {shapes[k]} {check.ms[k]:.4f} ms, "
                           f"twin {check.plain_ms[k]:.4f} ms")
        say("kernels", f"also array-equal at {states['bed']}, "
                       f"{states['cigar']}, {states['list']} and "
                       f"{states['unsorted']}")
        for path, (nbytes, n_copies, secs) in h2d.items():
            say("kernels", f"host->device copies of the {path} feed: "
                           f"{nbytes} bytes in {n_copies} copies, "
                           f"{secs * 1e3:.3f} ms (host clock)")
        for note in check.notes:
            say("kernels", note)

        # 5. golden
        n_gold = golden(port_main, tmp, dev)
        say("golden", f"{n_gold} tables byte-equal to tests/golden/ (chr, "
                      f"bed, gene, gene_gc from the BAM: encoded windows, "
                      f"raw pairs and no-native; chr from SAM both ways "
                      f"and CRAM)")

        # 6. the real-size main paths, each counted on its own
        def cli(out, *extra, inp=bam):
            rc = port_main(["pandepth", "-i", inp, "-o",
                            os.path.join(tmp, out), *extra], device=dev)
            if rc != 0:
                fail("e2e", f"the port's CLI ({out}) exited {rc}")

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        # chr, native stream, raw pairs and then encoded windows
        with raw_pairs():
            _, paths["chr"], wall = counted(kernels, "chr",
                                            lambda: cli("port", "-v"))
            wall2 = timed(lambda: cli("port2"))
        _, paths["chr_enc"], enc_wall = counted(kernels, "chr_enc",
                                                lambda: cli("enc", "-v"))
        enc_wall2 = timed(lambda: cli("enc2"))
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
        host_wall = host_sweep(["-i", bam], os.path.join(tmp, "host"))
        port_tab = table(os.path.join(tmp, "port"))
        for other in ("host", "port2", "enc", "enc2", "cold"):
            if table(os.path.join(tmp, other)) != port_tab:
                fail("e2e", f"chr table of the {other} run differs from "
                            f"the raw-pair run's")
        say("e2e", f"chr mode, {N_READS} reads, CLI process (user wall, "
                   f"encoded windows): {cold_wall:.3f} s "
                   f"({N_READS / cold_wall:.0f} reads/s); its run alone "
                   f"{cold_run[-1][6:] if cold_run else '?'}")
        say("e2e", f"chr in this process, raw pairs (PANDEPTH_ENC=0): "
                   f"{wall:.3f} s ({N_READS / wall:.0f} reads/s), again "
                   f"{wall2:.3f} s; launches {paths['chr']}")
        say("e2e", f"chr_enc in this process, encoded windows (default): "
                   f"{enc_wall:.3f} s ({N_READS / enc_wall:.0f} reads/s), "
                   f"again {enc_wall2:.3f} s; launches {paths['chr_enc']}")
        say("e2e", f"chr tables of both feeds byte-equal to each other and "
                   f"to the host sweep's ({len(port_tab.splitlines())} "
                   f"lines; host sweep CLI process {host_wall:.3f} s)")

        # chr through the Python decoder and the CIGAR feed
        with no_native():
            _, paths["cigar"], wall = counted(
                kernels, "cigar", lambda: cli("cigar", "-v"))
        n_batches = paths["cigar"]["extract_events"]
        if n_batches < -(-N_READS // BATCH_READS):
            fail("e2e", f"cigar: extract_events launched {n_batches} "
                        f"times, fewer than the fixture's batches")
        if table(os.path.join(tmp, "cigar")) != port_tab:
            fail("e2e", "chr table of the PANDEPTH_NO_NATIVE=1 run differs "
                        "from the native run's")
        say("e2e", f"cigar (PANDEPTH_NO_NATIVE=1), {N_READS} reads in this "
                   f"process: {wall:.3f} s ({N_READS / wall:.0f} reads/s); "
                   f"launches {paths['cigar']}; chr table byte-equal to "
                   f"the native run's")

        # the fused single-device step
        (cov, dsum), paths["step"], wall = counted(
            kernels, "step", lambda: [t.cpu() for t in coverage_step(
                *fb.cols, fb.offsets, fb.limits, fb.lo, fb.hi,
                flags_mask=fb.flags_mask, min_mapq=fb.min_mapq)])
        want = [t.cpu() for t in step_twin(fb)]
        if not (torch.equal(cov, want[0]) and torch.equal(dsum, want[1])):
            fail("e2e", "step: coverage_step differs from the composition "
                        "of the twins")
        if int(cov.sum()) <= 0:
            fail("e2e", "step: no coverage")
        say("e2e", f"step: coverage_step on the first batch and "
                   f"{cov.shape[0]} chr bounds {wall * 1e3:.3f} ms (first "
                   f"call, host clock); launches {paths['step']}; equal to "
                   f"the composition of the twins")

        # -b with an exome-sized BED, raw pairs
        with raw_pairs():
            _, paths["bed"], wall = counted(
                kernels, "bed", lambda: cli("bedport", "-b", bed, "-v"))
        host_wall = host_sweep(["-i", bam, "-b", bed],
                               os.path.join(tmp, "bedhost"))
        bed_tab = table(os.path.join(tmp, "bedport"), "bed")
        if bed_tab != table(os.path.join(tmp, "bedhost"), "bed"):
            fail("e2e", "bed: table differs from the host sweep's")
        say("e2e", f"bed ({N_BED} regions): {wall:.3f} s in this process; "
                   f"launches {paths['bed']}; table byte-equal to the host "
                   f"sweep's ({len(bed_tab.splitlines())} lines; host sweep "
                   f"CLI process {host_wall:.3f} s)")

        # the .list: three samples pooled, encoded windows
        n_list = N_READS + 2 * (N_READS // 2)
        _, paths["list"], wall = counted(
            kernels, "list", lambda: cli("listport", "-v", inp=lst))
        host_wall = host_sweep(["-i", lst], os.path.join(tmp, "listhost"))
        list_tab = table(os.path.join(tmp, "listport"))
        if list_tab != table(os.path.join(tmp, "listhost")):
            fail("e2e", "list: table differs from the host sweep's")
        say("e2e", f"list (3 BAMs, {n_list} reads pooled): {wall:.3f} s in "
                   f"this process ({n_list / wall:.0f} reads/s); launches "
                   f"{paths['list']}; table byte-equal to the host sweep's "
                   f"(host sweep CLI process {host_wall:.3f} s)")

        # PAF: the native PAF loader's pairs
        _, paths["paf"], wall = counted(
            kernels, "paf", lambda: cli("pafport", "-v", inp=paf))
        host_wall = host_sweep(["-i", paf], os.path.join(tmp, "pafhost"))
        paf_tab = table(os.path.join(tmp, "pafport"))
        if paf_tab != table(os.path.join(tmp, "pafhost")):
            fail("e2e", "paf: table differs from the host sweep's")
        say("e2e", f"paf ({N_READS} lines): {wall:.3f} s in this process "
                   f"({N_READS / wall:.0f} lines/s); launches "
                   f"{paths['paf']}; chr table byte-equal to the host "
                   f"sweep's (host sweep CLI process {host_wall:.3f} s)")

        # the unsorted BAM: the card's default election, then raw pairs.
        # Its header declares coordinate order, which the host sweep's
        # streaming fold verifies, so the host sweep runs without the fold
        def peak_mb(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            return out, (torch.cuda.max_memory_allocated() - base) / 2**20

        (_, paths["unsorted"], wall), peak = peak_mb(lambda: counted(
            kernels, "unsorted", lambda: cli("unsport", "-v", inp=uns)))
        if paths["unsorted"]["decode_enc"]:
            fail("e2e", "unsorted: a window cut short reached decode_enc")
        with raw_pairs():
            raw_wall, raw_peak = peak_mb(
                lambda: timed(lambda: cli("unsraw", inp=uns)))
        with env(PANDEPTH_STREAM_FOLD="0"):
            host_wall = host_sweep(["-i", uns], os.path.join(tmp, "unshost"))
        uns_tab = table(os.path.join(tmp, "unsport"))
        for other in ("unsraw", "unshost"):
            if table(os.path.join(tmp, other)) != uns_tab:
                fail("e2e", f"unsorted: the {other} table differs from the "
                            f"default run's")
        say("e2e", f"unsorted ({N_READS} reads): default election "
                   f"{wall:.3f} s, peak device memory {peak:.1f} MiB above "
                   f"the smoke's own tensors; raw pairs (PANDEPTH_ENC=0) "
                   f"{raw_wall:.3f} s, {raw_peak:.1f} MiB; launches "
                   f"{paths['unsorted']}; tables byte-equal to each other "
                   f"and to the host sweep's (host sweep CLI process "
                   f"{host_wall:.3f} s)")

        # 7. profile: the cigar, bed and both chr runs once more, traced
        with no_native():
            prof = {"cigar": profiled(lambda: cli("cigarprof"))}
        with raw_pairs():
            prof["bed"] = profiled(lambda: cli("bedprof", "-b", bed))
            prof["chr"] = profiled(lambda: cli("chrprof"))
        prof["chr_enc"] = profiled(lambda: cli("encprof"))
        if any(table(os.path.join(tmp, f"{p}prof")) != port_tab
               for p in ("cigar", "chr", "enc")) or \
                table(os.path.join(tmp, "bedprof"), "bed") != bed_tab:
            fail("profile", "a profiled run's table differs from phase 6's")
        for path, (pwall, dev_ms, h2d_ms, ops, peak) in prof.items():
            top = "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in ops)
            say("profile", f"{path}: wall {pwall:.3f} s, device time "
                           f"{dev_ms:.3f} ms (busy "
                           f"{100 * dev_ms / 1e3 / pwall:.4f}%), host->device "
                           f"copies {h2d_ms:.3f} ms, peak device memory "
                           f"{peak} bytes; largest: {top}")

    if "jax" in sys.modules:
        fail("imports", "jax was imported")
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k],
         "launches": sum(p[k] for p in paths.values()),
         "max_abs_err": check.err[k], "ms": check.ms[k],
         "plain_ms": check.plain_ms[k]} for k in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
