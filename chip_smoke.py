#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pandepth_tpu_torch``) on one
NVIDIA GPU. Run it from the repository root, with no arguments:

    python3 chip_smoke.py

(``chip_smoke.py worker ...`` is one rank of a path that phase 6 spawns;
see :func:`worker`.) Phases, one line each; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi)
2. build    nvcc build of pandepth_tpu_torch/csrc/sweep_kernels.cu
3. setup    in a subprocess, all through the port's own code: its
            libpancov_io, the native BAM feed, built and loaded (rebuilt
            with zlib alone where the libdeflate it linked does not
            load); the golden fixtures (BAM, and the same records as SAM
            and as CRAM, BED, GFFs, FASTA) and the benchmark fixtures of
            pandepth_tpu_torch/synth.py, generated into _smoke/ or reused:
            bench.py's 8M-read, 3 Gb-shape BAM (12 x 250 Mb contigs,
            150 bp reads, seed 42), an exome-sized BED over it (200,000
            regions of 150-300 bp, seed 5), bench3gb.py's .list samples
            (two 4M-read BAMs on the same contigs) and its 8M-line PAF,
            an unsorted 8M-read BAM (bench.py's reads without their
            sort, no index), synth.deep_bam (270,005 reads on a 400 bp
            contig, 270,000 of them on one base) and synth.spliced_bam
            (2M sorted reads of 60M5D40M3000N50M on the 3 Gb contigs,
            seed 43). Meanwhile g++ builds the JAX package's
            libpancov_io, with zlib, for the host sweep (the oracle)
4. kernels  every kernel against its plain PyTorch twin on the card,
            array-equal, at the shapes of every main path of phase 6:
            first sort_pairs (K2's stable sort) on
            pandepth_tpu_torch/synth.py's sort_edge_events and
            sort_edge_rows, after holding its tile and scratch to the
            library's: every tier over its whole range (negative int32
            keys, uint32 words past 2^31, int64 past 2^32), 0, 1, a tile
            - 1, a tile, a tile + 1 and a few tiles of events, every
            position equal, descending and ascending input, an encoded
            buffer's sentinel tail, a pile-up, keys apart in one byte,
            the extreme words, 1,000,003 events with 270,000 on one
            position, and (8, width) row blocks; 50 launches on the tail
            and the pile-up; then
            the state that pandepth_tpu_torch.run.stage builds from the
            fixture for chr with raw pairs (PANDEPTH_ENC=0: pack_events,
            sort_pairs, sweep_scan, eval_pair, eval_boundaries on 300 chr
            segments; timed, sort_pairs beside the library's stable sort
            and gather, with the peak device memory of each), for bed (the same on the exome BED's staged pairs and
            its 200,000 regions), for the CIGAR feed
            (PANDEPTH_NO_NATIVE=1: sweep_scan, eval_pair, eval_boundaries
            on every batch's extract_events output), and for chr and the
            .list with encoded windows (the card's default: decode_enc on
            every stacked block, timed, sort_pairs on the one event
            buffer it fills, timed on chr, and the whole
            finalize_encoded),
            and for the unsorted BAM (the card's default, whose windows
            the encoder cuts short: all of them staged as raw pairs);
            the sharded engine's 8-row blocks of the chr path (timed) and
            of the bed path (shard_carry, sort_pairs' row form, each row's
            sweep_scan, eval_pair_rows); eval_boundaries on the lo and hi of every
            counted path's segments (timed on chr and bed for notes);
            extract_events and eval_boundaries on the fixture's first
            2^20-read batch as
            pandepth_tpu_torch.run.read_batches yields it (one op per
            read; timed) and extract_events on a seeded 2^20-read
            multi-op batch on the fixture's layout (timed); all of them
            on edge cases (every position tier, wrap18, min_dep=3,
            sentinel tails, every CIGAR op, filters, clipping, zero-op
            reads, JAX-style padding, a 70,000-op read; every code group,
            escapes in both planes, zero rows, partial blocks, windows of
            2^19 and of 5,000 slots; for the sharded engine a hot range,
            empty rows, a carry past int32, an event at the axis's end,
            segments across and inside ranges and of zero length, 1, 8
            and 4 + 4 rows in two blocks, with the whole segment_stats
            against the twins' engine; shard_carry on
            synth.carry_edge_blocks: row payloads of 1, a run - 1, a run,
            a run + 1 and a few of its runs over 1, 8 and 37 rows
            and 70,000 rows, on both 32-bit tiers, an all-zero row,
            carries past 2^31 at a row edge, rows on earlier devices);
            bucket_events on the chr path's
            events over 1, 2, 4 and 8 ranges (timed, with the library's
            stable sort of the destinations beside it) and on every tier
            with dead slots, a hot range, an event at the axis's end, 0
            and 1 events and up to 1024 ranges; the time of each beside its
            twin's and its bound; the Python decoder's time per batch;
            the code groups and blocks of each encoded path; the bytes
            each feed copies to the card and the copies' time. The four
            chained-scan (look-back) kernels also on the edges of their
            tiles (pandepth_tpu_torch/synth.py's sweep_edge_events,
            enc_edge_groups, extract_edge_batches and bucket_edge_events,
            after holding its tile sizes to the built library's):
            sweep_scan at 1, a tile - 1, a tile, a tile + 1 and a few
            tiles of events, a carry past 2^32, a wrap18 pileup across a
            tile boundary, c_sum past 2^64; decode_enc with escapes on
            each tile's first and last slot, unsorted and duplicated
            entries, entries at CAP and past it, full lists, const rows
            of ns = 0 and CAP, and groups of 18 blocks (more than one
            launch takes); extract_events at 1, a tile - 1, a tile, a
            tile + 1 and a few tiles of ops, reads starting on a tile's
            first and last op, a read of more than three tiles, zero-op
            reads and JAX's padding at a tile boundary, ref lengths past
            2^32 across one; bucket_events at 0, 1, a tile - 1, a tile, a
            tile + 1 and a few tiles of events over 1, 2, 8, 37 and 1024
            ranges, a destination change on a tile's first and last
            event, an all-dead tile, a range empty everywhere. The two
            search kernels on the edges of their searches and tiles
            (synth.search_edge_cases and rows_edge_segments, after
            holding the staging window to the library's): eval_pair at
            1, 2, 15, 16, 17, 255, 256, 257 and a few tiles' worth of
            events, boundaries before, on, beside and past the events,
            zero-length and reversed segments, a run of equal positions
            longer than a 16-way round's stride, dense tiles wider and
            narrower than the window, unsorted segments, and
            eval_boundaries, the same search body one-sided, on every
            case's lo and hi concatenated; eval_pair_rows
            at segments crossing no row, one, two and every row and
            clips on a range's ends, and over 5,000 rows (more cuts than
            it stages in shared memory). 50 launches of each of those nine
            kernels on its main path's inputs (the chr path's, the 8-row
            chr block's, the step path's first batch; extract_events on
            both CIGAR batches; sort_pairs on the chr path's events and
            the 8-row chr block), every output array-equal to the first
            and to the twin (shard_carry with slot 0 of every row
            overwritten before each launch); the device
            time of each (torch.profiler) beside its CUDA-event time and
            its host time per call, with the kernels and memsets a call
            puts on the card, eval_pair also on the bed path's 200,000
            regions and a 1M-window chunk of a -w 150 grid over the chr
            path's state (and of a -w 1500 grid, whose tiles span more
            events than the window), and eval_boundaries on the step,
            chr and bed paths' boundaries, each beside torch.searchsorted
            of the same boundaries (the search alone) as a yardstick;
            torch.cumsum of the chr path's deltas and piece lengths as a
            yardstick for one of sweep_scan's sums; the sum of each row's
            deltas (torch.sum) as one for shard_carry; the card's time per
            dependent load (kernels.chase, a one-thread pointer chase of
            64 and 4,096 links), and each timed search shape's bound
            restated as the larger of its byte bound and its dependent
            loads
5. golden   the port's CLI on cuda over the golden fixtures: chr, bed,
            gene, gene_gc and win (-w 100) from the BAM, native with
            encoded windows, native with raw pairs and with
            PANDEPTH_NO_NATIVE=1, and chr from the SAM (both ways) and the
            CRAM; every table byte-equal to tests/golden/
6. e2e      the main paths at full size, each with every kernel count set
            to 0 just before it and read just after, and every kernel it
            runs launched at least once; from here to phase 13, in this
            process and in the workers, a guard fails the smoke if
            torch.sort, torch.argsort or Tensor.sort meets a CUDA tensor
            outside a plain twin:
            chr     the port's CLI over the 8M-read fixture with raw pairs
                    (PANDEPTH_ENC=0), twice in this process; wall times,
                    reads/s
            chr_enc the same with the card's default, encoded windows
                    (decode_enc); then once as a fresh ``python -m
                    pandepth_tpu_torch.cli``; every chr table byte-equal
                    to the raw run's and to the native host sweep's
                    (pandepth_tpu.cli with PANDEPTH_HOST_FINALIZE=1, a
                    subprocess)
            cigar   the same with PANDEPTH_NO_NATIVE=1 (the Python decoder
                    and the extract_events kernel, >= 8 batches); its
                    table byte-equal to the native run's
            step    coverage_step (the fused single-device step) on the
                    fixture's first batch and the chr bounds
            bed     -b with the exome BED (indexed fetch windows, ranged
                    native stream, PANDEPTH_ENC=0); the table byte-equal
                    to the host sweep's
            win     -w 1500 (2M windows, the card's default feed): more
                    windows than one 1M-query chunk, so the engine keeps
                    its state and runs eval_pair chunk by chunk; the table
                    byte-equal to the host sweep's
            list    the .list of the 8M-read fixture and the two 4M-read
                    samples (16M reads pooled, encoded windows); the
                    table byte-equal to the host sweep's
            paf     the 8M-line PAF (the native PAF loader, raw pairs); the
                    chr table byte-equal to the host sweep's
            unsorted the unsorted BAM with the card's default and with raw
                    pairs: no window reaches decode_enc, the peak device
                    memory of each; both tables byte-equal to the host
                    sweep's
            chr_sharded, bed_sharded  the chr and -b runs through the
                    sharded engine with device=["cuda"] * 8 (8 rows on
                    the card): wall, host bucketing seconds, peak device
                    memory; tables byte-equal to the single-device runs'
                    and so to the host sweep's
            cli_sharded the CLI as a user calls it (no device: every
                    visible card) with PANDEPTH_SHARDED=1, one row per
                    card; its table byte-equal to the same
            multiproc the .list through pandepth_tpu_torch.sharding.launch
                    on 2 gloo ranks sharing cuda:0, each a worker process
                    (rank 0 decodes files 0 and 2, rank 1 file 1): every
                    rank's launches, exchange seconds and bytes and
                    RunStats; rank 0's table byte-equal to the list run's
                    (and so to the host sweep's), none from rank 1
            multiproc_nccl the chr fixture through the launcher on 1 NCCL
                    rank; the table byte-equal to chr's
            mesh_step sharded_coverage_step on the first batch's reads,
                    split over 2 gloo ranks on cuda:0; both ranks' (cover,
                    dsum) equal to the step path's
7. profile  the cigar, bed, chr_enc, win, chr and chr_sharded runs once
            more under torch.profiler: host wall, device time (the sum
            of every op's self device time), the device's busy share,
            the host->device copies' time, the largest ops, the peak
            device memory; tables byte-equal to phase 6's; then one chr
            run under PANDEPTH_PROFILE=<dir>, whose own trace must hold
            the sweep_scan kernel
8. site     -a on pandepth_tpu_torch/synth.py's 12 Mb genome (16 x 750
            kb, S. cerevisiae's size) at 30x (2,400,000 150 bp reads,
            seed 42, sorted, indexed), each counted: one device with
            encoded windows (site) and raw pairs (site_raw), 8 rows on
            the card (site_sharded), 2 gloo ranks sharing it
            (site_multiproc, the ranks' parts joined); every
            .SiteDepth.gz and chr table byte-equal to the host sweep's;
            walls, the state fetch's bytes, peak device memory
9. win6     -w 100 on the 8M-read 3 Gb fixture (~30M windows, mode 6:
            each contig's windows by K3's chunked eval on the kept state,
            no state fetched), counted; the table byte-equal to the host
            sweep's; the wall and the seconds of the segment_stats calls
10. daemon  three chr runs on the 8M-read fixture through ``python -m
            pandepth_tpu_torch`` with PANDEPTH_DAEMON=1 and
            PANDEPTH_DAEMON_REQUIRE=1 (a socket in the temp directory;
            the first run spawns the daemon), beside a fresh ``python -m
            pandepth_tpu_torch.cli`` process and PANDEPTH_DAEMON=0
            ``python -m pandepth_tpu_torch``; every table byte-equal to
            the in-process run's; each run's launches (the daemon's
            counts) and the daemon's device memory after each request
            (nvidia-smi, and its allocator's bytes), which must not grow
            after the first; then --daemon-stop, whatever happened
11. wrap18  -a, -w 100 and chr on synth.deep_bam (depth 270,000 on one
            base: the reference's 18-bit cells wrap it to 7,856 with -a
            and -w below 150, not in chr mode), each counted, on one
            device; the .SiteDepth.gz and every table byte-equal to the
            host sweep's
12. boot    fresh chr processes on the 8M-read fixture, each way twice in
            turns: ``python -m pandepth_tpu_torch.cli -v`` (the start-up,
            torch, the CUDA context and the kernel library, on the main
            thread while a thread stashes the first windows) and a process
            that runs ``boot.start_up()`` before it calls ``cli.main``
            (the serial order); then one overlapped on the sharded engine
            (the stash decoded on the host); the walls, the windows
            stashed (at least 1 in each overlapped run) and the RunStats
            phases; every table byte-equal to the in-process run's
13. graft   pandepth_tpu_torch.graft_entry: ``entry()``'s coverage_step on
            cuda:0 (counted) array-equal to its CPU twin, and
            ``dryrun_multichip(2)``, two gloo ranks sharing the card, each
            rank's sharded step equal to coverage_step on all the reads,
            under JOB_SECONDS
14. host    the host engine (PANDEPTH_HOST_FINALIZE=1), in fresh
            ``python -m pandepth_tpu_torch.cli`` processes that report
            whether they imported torch (none may) and their peak RSS:
            chr, -b, -w 1500, -w 100, the .list, the PAF and -a on the
            site fixture, each table byte-equal to the device run's of
            this call and the host sweep's, each wall beside the host
            sweep's (earlier in the call, and again right after each
            process) and the boot phase's fresh device processes; chr with
            a fold every 2^20 pairs (at least 7) against
            PANDEPTH_STREAM_FOLD=0, and the same on synth.spliced_bam
            (2M reads with a deletion and a splice each, at least 3
            folds, held to the host sweep's table too), tables equal, the
            folds counted by the engine, peak RSS of each;
            PANDEPTH_SITE_SPLIT=1 on -a and the .list, byte-equal to the
            one-shot runs; two chr requests through a daemon with the
            variable set (the first spawns it), which loads no kernel
            module. The phase launches no kernel

Then the card's line once more, one JSON line of kernel results, and
last ``{"ok": true, "device": {...}}``. This process and its workers
import nothing but torch and pandepth_tpu_torch; the fixtures and the
host sweep run in subprocesses.
"""

from __future__ import annotations

import gzip
import json
import os
import re
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
            "decode_enc": "pandepth_tpu/device/sweep.py:205",
            "shard_carry": "pandepth_tpu/sharding/engine.py:81",
            "eval_pair_rows": "pandepth_tpu/sharding/engine.py:73",
            "bucket_events": "pandepth_tpu/sharding/mesh.py:64",
            "sort_pairs": "pandepth_tpu/device/sweep.py:49"}
# what each main path must launch (summed over the ranks of a path run by
# spawned workers)
MESH = ("bucket_events", "shard_carry", "sort_pairs", "sweep_scan",
        "eval_pair_rows")
# K2: its sort, then its scans
K2 = ("sort_pairs", "sweep_scan")
SHARDED = ("shard_carry",) + K2 + ("eval_pair_rows",)
PATHS = {"chr": ("pack_events",) + K2 + ("eval_pair",),
         "chr_enc": ("decode_enc",) + K2 + ("eval_pair",),
         "cigar": ("extract_events",) + K2 + ("eval_pair",),
         "step": ("extract_events",) + K2 + ("eval_boundaries",),
         "bed": ("pack_events",) + K2 + ("eval_pair",),
         "win": ("decode_enc",) + K2 + ("eval_pair",),
         "list": ("decode_enc",) + K2 + ("eval_pair",),
         "paf": ("pack_events",) + K2 + ("eval_pair",),
         "unsorted": ("pack_events",) + K2 + ("eval_pair",),
         "chr_sharded": SHARDED, "bed_sharded": SHARDED,
         "cli_sharded": SHARDED,
         "multiproc": MESH, "multiproc_nccl": MESH,
         "mesh_step": MESH + ("extract_events",),
         "site": ("decode_enc",) + K2 + ("eval_pair",),
         "site_raw": ("pack_events",) + K2 + ("eval_pair",),
         "site_sharded": SHARDED,
         "site_multiproc": MESH,
         "win6": ("decode_enc",) + K2 + ("eval_pair",),
         "daemon": ("decode_enc",) + K2 + ("eval_pair",),
         "wrap18_site": K2 + ("eval_pair",),
         "wrap18_w100": K2 + ("eval_pair",),
         "wrap18_chr": K2 + ("eval_pair",),
         "graft": ("extract_events",) + K2 + ("eval_boundaries",)}
N_READS = 8_000_000
BATCH_READS = 1 << 20   # RunConfig.max_reads_per_batch
N_BED = 200_000
WIN_BP = 1500           # -w of the win path: 2M windows of the 3 Gb layout
QUERY_CHUNK = 1 << 20   # CoverageEngine.segment_stats' chunk
SHARD_ROWS = 8          # rows of the sharded runs on the one card
RANGES = (1, 2, 4, 8)   # bucket_events' ranges on the chr path's events
WIN6_BP = 100           # -w of the win6 path: ~30M windows of the 3 Gb layout
DAEMON_RUNS = 3         # chr runs through the daemon: the first spawns it
SETTLE_READS = 6        # the idle daemon's stat, read a quarter second apart
DAEMON_SETTLE_S = 20    # idle after the first request before the baseline
HOST_MIN_FOLDS = 7      # folds of 2^20 pairs the host phase's chr must take
SPLICED_MIN_FOLDS = 3   # and its spliced BAM (3 segments a read)
JOB_SECONDS = 300       # each spawned job's limit, all its ranks killed
HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's device memory rate
SENTINEL = 1 << 62      # JAX's extract_events sentinel
COLS = ("tid", "pos", "flag", "mapq", "op_code", "op_len", "op_read")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: {phase} failed: {msg}")


def table(prefix: str, kind: str = "chr") -> bytes:
    with gzip.open(f"{prefix}.{kind}.stat.gz", "rb") as fh:
        return fh.read()


def search_bytes(n: int, word: int) -> int:
    """The bytes one Q(x) evaluation needs of a sweep state of ``n``
    events: a binary search's ceil(log2 n) + 1 position words, then the
    piece's depth (4 B) and two int64 prefixes."""
    return (max(n - 1, 1).bit_length() + 1) * word + 20


def eval_bytes(n: int, word: int, b: int, span: int, sides: int = 2) -> int:
    """The bytes eval_pair (``sides`` 2) or eval_boundaries (1) needs for
    ``b`` items over ``n`` events of ``word`` bytes, their boundaries'
    lower bounds ``span`` events apart at most: each boundary read and
    each pair of outputs written once, and the state's words the searches
    need, the fewer of every boundary's own search (:func:`search_bytes`)
    and one read of the span (a position, a depth and two prefixes an
    event)."""
    return b * (sides * word + 16) + min(sides * b * search_bytes(n, word),
                                         (span + 1) * (word + 20))


def span_of(pos_s, x) -> int:
    """The events between the lower bounds of the least and the greatest
    of the boundaries ``x`` in ``pos_s``."""
    import torch

    ends = torch.searchsorted(pos_s, torch.stack([x.min(), x.max()]))
    return int(ends[1] - ends[0])


def search_loads(n: int, q: int) -> int:
    """The fewest dependent loads in which the card can search ``q``
    boundaries in ``n`` sorted words and gather each one's piece: a round
    of a cooperative search cuts an interval lanes + 1 ways with a load a
    lane, then one more load. A boundary's cut is the widest one resident
    wave gives it: at most a block's 1,024 lanes, the card's resident
    threads shared among the ``q`` boundaries, and never fewer than the
    512 lanes of a tile's two edge searches (a block searches its tile's
    least and greatest boundary, stages the span between and finishes in
    shared memory). ceil(log_{lanes + 1}(n + 1)) rounds, then one."""
    import torch

    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    resident = props.multi_processor_count \
        * props.max_threads_per_multi_processor
    lanes = max(512, min(1024, resident // max(q, 1)))
    rounds = 0
    while (lanes + 1) ** rounds < n + 1:
        rounds += 1
    return rounds + 1


def sort_floor_bytes(n: int, word: int, key: int) -> int:
    """The bytes sort_pairs' own design moves for ``n`` events of
    ``word``-byte positions and ``key``-byte keys: the histogram's read of
    the positions, the first pass (positions and deltas in, keys and
    deltas out), the passes between (keys and deltas in and out) and the
    last (keys and deltas in, positions and deltas out), a pass a byte of
    the key."""
    ends = 2 * n * (word + 4 + key + 4)
    return n * word + ends + (key - 2) * 2 * n * (key + 4)


def peak_bytes(fn) -> int:
    """The device memory ``fn`` allocates at its peak above what was
    allocated before it (its outputs included)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def device_ms(fn, iters: int = 10, tries: int = 3):
    """(device ms per call, kernels per call, memsets per call) of ``fn``
    under torch.profiler after a warm-up call: the sum of the device ops'
    own times, which leaves out the host's gaps between launches. A trace
    that lost events (no kernel, or a fractional count per call) is taken
    again, up to ``tries`` times."""
    for _ in range(tries):
        got = _device_ms(fn, iters)
        if got[1] >= 1 and got[1] == int(got[1]) and got[2] == int(got[2]):
            break
    return got


def _device_ms(fn, iters: int):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, kernels, memsets = 0.0, 0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0 \
                or e.key == "Activity Buffer Request":
            continue
        ms += e.self_device_time_total / 1e3
        if "memset" in e.key.lower():
            memsets += e.count
        else:
            kernels += e.count
    return ms / iters, kernels / iters, memsets / iters


def host_ms(fn, calls: int = 100, runs: int = 5) -> float:
    """Host milliseconds per call of ``fn``: a host clock around ``calls``
    calls with no synchronisation between them (after a warm-up call), the
    least of ``runs`` such clocks (the host is shared, so a longer one
    holds other work): what launching costs the host. Where it exceeds
    the device time, the CUDA-event time of a run of calls is the
    host's."""
    import torch

    fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return best


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


# Set-up, run in a subprocess so that the fixtures' generation leaves
# nothing in this process: argv = golden directory, cache directory,
# reads, BED regions. Prints the 8M-read fixture's path, the exome BED's,
# the .list's, the PAF's, the unsorted BAM's, the site fixture's and the
# deep BAM's and the spliced BAM's, one per line, last.
SETUP = r"""
import os, subprocess, sys

from pandepth_tpu_torch import synth
from pandepth_tpu_torch.io import native

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
          f"libdeflate, so the table writers compress with zlib")
    lib = native.load_library()
if lib is None:
    sys.exit(f"libpancov_io does not build: {native.build_error()}")
print(f"libpancov_io: {native._LIB}")

d, cache = sys.argv[1], sys.argv[2]
n_reads, n_bed = int(sys.argv[3]), int(sys.argv[4])
synth.golden_inputs(d)
bam = synth.bench_bam(cache, n_reads)
bed = os.path.join(cache, f"exome_{n_bed}.bed")
synth.exome_bed(bed, n_bed)
extra = [os.path.join(cache, f"bench3gb_s{k}.bam") for k in (2, 3)]
for k, path in zip((2, 3), extra):
    if not os.path.exists(path):
        synth.list_sample_bam(path, k, n_reads // 2)
lst = os.path.join(cache, "bench3gb.list")
with open(lst, "w") as fh:
    fh.write("\n".join([bam] + extra) + "\n")
paf = os.path.join(cache, "bench3gb.paf")
if not os.path.exists(paf):
    synth.paf_file(paf, n_reads)
print("\n".join([bam, bed, lst, paf, synth.unsorted_bam(cache, n_reads),
                 synth.site_bam(cache), synth.deep_bam(cache),
                 synth.spliced_bam(cache)]))
"""

# the JAX package's libpancov_io, built for the host sweep (the oracle,
# a pandepth_tpu.cli process) with zlib alone, as the port's may have
# to be: PANDEPTH_NATIVE_BUILD points that process at it
ORACLE_NATIVE = os.path.join(CACHE, "oracle_native")


def setup(golden_dir: str):
    """The port's native library, the golden fixtures and the benchmark
    fixtures (the set-up subprocess), and the oracle's native library
    (g++ at the same time); returns (fixture, BED, .list, PAF, unsorted,
    site, deep, spliced) paths."""
    os.makedirs(ORACLE_NATIVE, exist_ok=True)
    oracle = subprocess.Popen(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-o", os.path.join(ORACLE_NATIVE, "libpancov_io.so"),
         os.path.join(ROOT, "pandepth_tpu", "io", "native", "pancov_io.cpp"),
         "-lz", "-lpthread"], stderr=subprocess.PIPE, text=True)
    r = subprocess.run([sys.executable, "-c", SETUP, golden_dir, CACHE,
                        str(N_READS), str(N_BED)], cwd=ROOT,
                       capture_output=True, text=True)
    _, err = oracle.communicate()
    if r.returncode != 0:
        fail("setup", f"exited {r.returncode}: {r.stderr[-3000:]}")
    if oracle.returncode != 0:
        fail("setup", f"g++ of the oracle's libpancov_io exited "
                      f"{oracle.returncode}: {err[-2000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-8]:
        say("setup", line)
    return lines[-8:]


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
        self.bound_ms = {}
        self.library_ms = {}
        self.notes = []
        # (kernel, what, bytes bound ms, dependent loads) of each timed
        # shape of the search kernels, for their dependent-round bound
        self.searches = []

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

    def repeat(self, name: str, kernel, want, what: str,
               times: int = 50) -> None:
        """``times`` launches of ``kernel`` on one input: every output
        array-equal to the first launch's and to the twin's ``want`` (a
        race in a look-back shows as an intermittent difference)."""
        import torch

        first = kernel()
        for k in range(times):
            got = kernel() if k else first
            if not all(torch.equal(g, f) and torch.equal(g, w)
                       for g, f, w in zip(got, first, want)):
                fail("kernels", f"{name} {what}: launch {k + 1} of {times} "
                                f"differs from the first or the twin")
        self.notes.append(f"{name}: {times} launches on {what}, every "
                          f"output array-equal to the first and the twin")

    def device_note(self, name: str, kernel, what: str,
                    ms: float = None) -> None:
        """The kernel's device time per call beside its CUDA-event time
        (``ms``, by default the kernel's JSON entry's) and the host's time
        per call, with the launches each call puts on the device."""
        dms, nk, nm = device_ms(kernel)
        hms = host_ms(kernel)
        self.notes.append(f"{name} on {what}: device time {dms:.4f} ms per "
                          f"call (profiler; CUDA events "
                          f"{self.ms[name] if ms is None else ms:.4f} ms, "
                          f"host {hms:.4f} ms a call unsynchronised), "
                          f"{nk:g} kernel(s) and {nm:g} memset(s) a call")

    def pair_case(self, state, min_dep: int, lo, hi, what: str,
                  note: str = "") -> None:
        """eval_pair held array-equal to its twin on ``state`` (pos_s,
        depth, c_cov, c_sum) at ``lo``/``hi``, then timed (:meth:`time`:
        the kernel's JSON entry, or a note with ``note``), its device and
        host time per call, and torch.searchsorted of the same
        boundaries, the search alone, as a yardstick."""
        import torch

        from pandepth_tpu_torch.device import kernels, sweep

        pos_s = state[0]
        n, w, b = pos_s.numel(), pos_s.element_size(), lo.numel()
        x = torch.cat([lo, hi])
        nbytes = eval_bytes(n, w, b, span_of(pos_s, x))
        kernel = lambda: kernels.eval_pair(*state, min_dep, lo, hi)  # noqa
        twin = lambda: sweep.eval_pair_reference(*state, min_dep, lo,  # noqa
                                                 hi)
        self.compare("eval_pair", kernel(), twin(), note or what)
        ms = self.time("eval_pair", kernel, twin, nbytes, note)
        self.device_note("eval_pair", kernel, note or what, ms)
        ss = cuda_ms(lambda: torch.searchsorted(pos_s, x))
        self.notes.append(f"yardstick for eval_pair's search (not "
                          f"library_ms): torch.searchsorted of the {2 * b} "
                          f"boundaries of {note or what}: {ss:.4f} ms")
        self.searches.append(("eval_pair", note or what,
                              nbytes / HBM_BYTES_PER_S * 1e3,
                              search_loads(n, 2 * b)))

    def round_notes(self, ns_per_load: float) -> None:
        """Each timed search shape's bound restated: the larger of its
        byte bound and its dependent loads at ``ns_per_load``."""
        for name, what, bytes_ms, loads in self.searches:
            lat_ms = loads * ns_per_load * 1e-6
            self.notes.append(
                f"{name} bound on {what}: bytes {bytes_ms:.6f} ms, "
                f"{loads} dependent loads {lat_ms:.6f} ms: "
                f"{max(bytes_ms, lat_ms):.6f} ms")

    def time(self, name: str, kernel, twin, nbytes: int,
             note: str = "") -> float:
        """The kernel's and the twin's times, and the bound: the least
        time the card needs to move ``nbytes`` (each input read once, each
        output written once, what this call's data needs) at its memory
        rate. With ``note`` they go to a note line instead of the
        kernel's JSON entry. Returns the kernel's time."""
        ms, plain_ms = cuda_ms(kernel), cuda_ms(twin)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        if note:
            self.notes.append(f"{name} on {note}: {ms:.4f} ms, twin "
                              f"{plain_ms:.4f} ms, bound {bound:.6f} ms")
        else:
            self.ms[name], self.plain_ms[name] = ms, plain_ms
            self.bound_ms[name] = bound
        return ms

    def sort_case(self, pos, delta, tier: int, what: str,
                  timed: bool = False, note: str = ""):
        """sort_pairs held array-equal to its twin on ``pos``/``delta`` (a
        (rows, width) block row by row); with ``timed`` also 50 launches
        of it, then timed for its JSON entry, or with ``note`` for a note:
        its CUDA-event, device and host time per call, the twin's (the
        library's stable sort and gather, timed once more for the JSON
        entry's library_ms), the bound (each word and delta read once and
        written once), the design's own bytes and the peak device memory
        of the kernel and of the library's sort. Returns the twin's
        (pos_s, delta_s)."""
        from pandepth_tpu_torch.device import kernels, sweep

        kernel = lambda: kernels.sort_pairs(pos, delta, tier)  # noqa: E731
        twin = lambda: sweep.sort_pairs_reference(pos, delta)  # noqa: E731
        want = twin()
        self.compare("sort_pairs", kernel(), want, what)
        if not (timed or note):
            return want
        n, w = pos.numel(), pos.element_size()
        key = 8 if tier == kernels.TIER_I64 else 4
        if timed:
            self.repeat("sort_pairs", kernel, want, what)
        ms = self.time("sort_pairs", kernel, twin, 2 * n * (w + 4), note)
        self.device_note("sort_pairs", kernel, note or what, ms)
        lib_ms, lib_dev = cuda_ms(twin), device_ms(twin)[0]
        if not note:
            self.library_ms["sort_pairs"] = lib_ms
        floor = sort_floor_bytes(n, w, key)
        self.notes.append(
            f"sort_pairs on {note or what}: the library's stable sort and "
            f"gather {lib_ms:.4f} ms (device {lib_dev:.4f} ms); the "
            f"design's own {floor} bytes ({floor / n:.0f} B an event, "
            f"{key} passes) take {floor / HBM_BYTES_PER_S * 1e3:.6f} ms at "
            f"the memory rate; peak device memory: kernel "
            f"{peak_bytes(kernel)} bytes, library sort and gather "
            f"{peak_bytes(twin)} bytes")
        return want

    def sweep_case(self, raw_s, raw_e, sentinel: int, lo, hi, min_dep: int,
                   wrap18: bool, what: str, timed: bool = False,
                   pair_note: str = "") -> None:
        """Staged start/end pairs through pack_events and its twin, then
        :meth:`state_case` on the packed events."""
        from pandepth_tpu_torch.device import kernels, sweep
        from pandepth_tpu_torch.device.convert import tier_for_max

        tier = tier_for_max(sentinel)
        got = kernels.pack_events(raw_s, raw_e, tier)
        want = sweep.pack_events_reference(raw_s, raw_e, sentinel)
        self.compare("pack_events", got, want, what)
        if timed:
            m = raw_s.numel()
            self.time("pack_events",
                      lambda: kernels.pack_events(raw_s, raw_e, tier),
                      lambda: sweep.pack_events_reference(raw_s, raw_e,
                                                          sentinel),
                      2 * m * (raw_s.element_size() + got[0].element_size()
                               + 4))
        self.state_case(*got, sentinel, lo, hi, min_dep, wrap18, what, timed,
                        pair_note)

    def state_case(self, pos, delta, sentinel: int, lo, hi, min_dep: int,
                   wrap18: bool, what: str, timed: bool = False,
                   pair_note: str = "") -> None:
        """Events through sort_pairs, then sweep_scan, eval_pair and
        eval_boundaries and their twins; with ``timed`` sort_pairs,
        sweep_scan and eval_pair timed (eval_pair also at 1M-window chunks
        of -w 150 and -w 1500 grids from position 0), with ``pair_note``
        eval_pair timed for a note."""
        import torch

        from pandepth_tpu_torch.device import kernels, sweep
        from pandepth_tpu_torch.device.convert import tier_for_max

        pos_s, delta_s = self.sort_case(pos, delta, tier_for_max(sentinel),
                                        what, timed=timed)
        got = kernels.sweep_scan(pos_s, delta_s, min_dep, wrap18, sentinel)
        scan_want = sweep.sweep_scan_reference(pos_s, delta_s, min_dep,
                                               wrap18, sentinel)
        self.compare("sweep_scan", got, scan_want, what)
        depth, c_cov, c_sum = got
        got = kernels.eval_pair(pos_s, depth, c_cov, c_sum, min_dep, lo, hi)
        want = sweep.eval_pair_reference(pos_s, depth, c_cov, c_sum,
                                         min_dep, lo, hi)
        self.compare("eval_pair", got, want, what)
        self.boundaries_case(pos_s, depth, c_cov, c_sum, min_dep,
                             torch.cat([lo, hi]), what,
                             note=f"{what}, lo and hi"
                             if timed or pair_note else "")
        state = (pos_s, depth, c_cov, c_sum)
        if pair_note:
            self.pair_case(state, min_dep, lo, hi, what, pair_note)
        if not timed:
            return
        n, w = pos_s.numel(), pos_s.element_size()
        scan = lambda: kernels.sweep_scan(pos_s, delta_s, min_dep,  # noqa
                                          wrap18, sentinel)
        self.repeat("sweep_scan", scan, scan_want, what)
        self.time("sweep_scan", scan,
                  lambda: sweep.sweep_scan_reference(pos_s, delta_s,
                                                     min_dep, wrap18,
                                                     sentinel),
                  n * (w + 4 + 4 + 8 + 8))
        self.device_note("sweep_scan", scan, what)
        plen = torch.diff(c_cov, prepend=c_cov[:1] * 0)
        cum32 = cuda_ms(lambda: torch.cumsum(delta_s, 0, dtype=torch.int32))
        cum64 = cuda_ms(lambda: torch.cumsum(plen, 0))
        self.notes.append(f"yardstick for one of sweep_scan's three sums "
                          f"(not library_ms): torch.cumsum of the {n} int32 "
                          f"deltas {cum32:.4f} ms, of the {n} int64 piece "
                          f"lengths {cum64:.4f} ms")
        self.repeat("eval_pair",
                    lambda: kernels.eval_pair(*state, min_dep, lo, hi),
                    want, what)
        self.pair_case(state, min_dep, lo, hi, what)
        for bp, mb in ((150, "150 Mb"), (1500, "1.5 Gb")):
            win = bp * torch.arange(1 << 20, dtype=pos_s.dtype,
                                    device=pos_s.device)
            self.pair_case(state, min_dep, win, win + bp, what,
                           f"a 1M-window chunk of a -w {bp} grid (the first "
                           f"{mb}), {what}")

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
            n, m = cols[0].numel(), cols[4].numel()
            kernel = lambda: kernels.extract_events(  # noqa: E731
                *args, sentinel, pos_dtype)
            self.repeat("extract_events", kernel, want, what)
            ms = self.time("extract_events", kernel,
                           lambda: events.extract_events_reference(
                               *args, sentinel, pos_dtype),
                           16 * n + 12 * m + 16 * offsets.numel()
                           + 2 * m * (got[0].element_size() + 4), note)
            self.device_note("extract_events", kernel, what, ms)
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
            word = 4 if pos_max == (1 << 31) - 1 else 8
            nbytes = 0
            for g in present:
                for part in g:
                    for t in (part if isinstance(part, tuple) else (part,)):
                        nbytes += t.numel() * t.element_size()
                nbytes += 2 * sum(c[..., 0, :].numel() if len(g) == 4
                                  else c.numel() for c in g[0]) * (word + 4)
            def decode():
                return [t for g in present
                        for t in decoders(g)[0](*g, pos_max=pos_max)]

            self.time("decode_enc", decode,
                      lambda: [decoders(g)[1](*g, pos_max=pos_max)
                               for g in present], nbytes, note)
            if not note:
                self.repeat("decode_enc", decode,
                            [t for g in present
                             for t in decoders(g)[1](*g, pos_max=pos_max)],
                            what)
                self.device_note("decode_enc", decode, what)

    def finalize_enc_case(self, groups, cp, cd, lo, hi, pos_max: int,
                          min_dep: int, wrap18: bool, what: str,
                          sort_note: str = "") -> None:
        """sort_pairs on the one event buffer that finalize_encoded sorts
        (timed for a note with ``sort_note``), then the whole
        finalize_encoded (decode_enc into one buffer, sort_pairs,
        sweep_scan, eval_pair) against its twin: all seven outputs."""
        from pandepth_tpu_torch.device import sweep
        from pandepth_tpu_torch.device.convert import tier_for_max

        pos, delta = sweep.encoded_events(*groups, cp, cd, pos_max)
        self.sort_case(pos, delta, tier_for_max(pos_max),
                       what + ", its sort input", note=sort_note)
        del pos, delta
        args = (*groups, cp, cd, lo, hi)
        kw = dict(min_dep=min_dep, wrap18=wrap18, pos_max=pos_max)
        self.compare("decode_enc", sweep.finalize_encoded(*args, **kw),
                     sweep.finalize_encoded_reference(*args, **kw),
                     what + ", whole finalize_encoded")

    def boundaries_case(self, pos_s, depth, c_cov, c_sum, min_dep: int, x,
                        what: str, timed: bool = False,
                        note: str = "") -> None:
        """eval_boundaries held array-equal to its twin at ``x``; with
        ``timed`` also 50 launches of it, and timed for its JSON entry, or
        with ``note`` for a note: its CUDA-event, device and host time per
        call, and torch.searchsorted of the same boundaries."""
        from pandepth_tpu_torch.device import kernels, sweep

        args = (pos_s, depth, c_cov, c_sum, min_dep, x)
        want = sweep.eval_boundaries_reference(*args)
        self.compare("eval_boundaries", kernels.eval_boundaries(*args), want,
                     what)
        if not (timed or note):
            return
        import torch

        n, w, b = pos_s.numel(), pos_s.element_size(), x.numel()
        nbytes = eval_bytes(n, w, b, span_of(pos_s, x), sides=1)
        kernel = lambda: kernels.eval_boundaries(*args)  # noqa: E731
        if timed:
            self.repeat("eval_boundaries", kernel, want, what)
        ms = self.time("eval_boundaries", kernel,
                       lambda: sweep.eval_boundaries_reference(*args),
                       nbytes, note)
        self.device_note("eval_boundaries", kernel, note or what, ms)
        ss = cuda_ms(lambda: torch.searchsorted(pos_s, x))
        ss_dev = device_ms(lambda: torch.searchsorted(pos_s, x))[0]
        self.notes.append(f"yardstick for eval_boundaries' search (not "
                          f"library_ms): torch.searchsorted of the {b} "
                          f"boundaries of {note or what}: {ss:.4f} ms, "
                          f"device {ss_dev:.4f} ms")
        self.searches.append(("eval_boundaries", note or what,
                              nbytes / HBM_BYTES_PER_S * 1e3,
                              search_loads(n, b)))


def sweep_edge_cases(check: KernelCheck, dev) -> None:
    """Random events on every tier with duplicates, sentinel tails, a
    deep pileup past 18 bits, and queries inside, on and past the
    events: pack_events, sweep_scan, eval_pair and eval_boundaries; then
    sweep_scan on the edges of its tiles and look-backs
    (``synth.sweep_edge_events``, the cases tests/test_torch_sweep.py
    holds the twin to JAX on), after the library's stable sort."""
    import numpy as np
    import torch

    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device import kernels, sweep
    from pandepth_tpu_torch.device.convert import positions_to_words

    lib = kernels.library()
    tiles = (lib.pdt_sweep_scan_tile(), lib.pdt_decode_enc_tile(),
             lib.pdt_extract_events_tile(), lib.pdt_bucket_tile(),
             lib.pdt_eval_pair_win(), lib.pdt_carry_run())
    want = (synth.SWEEP_TILE, synth.DEC_TILE, synth.EXTRACT_TILE,
            synth.BUCKET_TILE, synth.SEARCH_WIN, synth.CARRY_RUN)
    if tiles != want:
        fail("kernels", f"the library's tiles {tiles} are not synth's "
                        f"{want}: the edge cases miss the tile boundaries")
    for name, pos, delta, pos_dt, min_dep, wrap18 in \
            synth.sweep_edge_events(seed=5):
        p = torch.from_numpy(positions_to_words(pos, pos_dt)).to(dev)
        pos_s, order = torch.sort(p, stable=True)
        delta_s = torch.from_numpy(delta).to(dev)[order]
        pm = int(np.iinfo(pos_dt).max)
        check.compare("sweep_scan",
                      kernels.sweep_scan(pos_s, delta_s, min_dep, wrap18, pm),
                      sweep.sweep_scan_reference(pos_s, delta_s, min_dep,
                                                 wrap18, pm),
                      f"look-back edge: {name}, min_dep={min_dep} "
                      f"wrap18={wrap18}")

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


def sort_edge_cases(check: KernelCheck, dev) -> None:
    """sort_pairs after holding its tile to synth's and kernels.py's and
    kernels.sort_plan's scratch to the library's: on
    ``synth.sort_edge_events`` (the cases tests/test_torch_sort.py holds
    the twin to JAX on: 0, 1, a tile - 1, a tile, a tile + 1 and a few
    tiles of events over each tier's whole range, every position equal,
    descending and ascending input, an encoded buffer's sentinel tail, a
    pile-up, keys apart in the top or the bottom byte alone, the tier's
    extreme words), 50 launches on the tail's and the pile-up's inputs;
    1,000,003 events with 270,000 of them on one position (synth.deep_bam's
    depth) on every tier; and ``synth.sort_edge_rows``, (8, width) blocks
    of the sharded engine's shape."""
    import numpy as np
    import torch

    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.device.convert import positions_to_words, tier_of

    lib = kernels.library()
    if not lib.pdt_sort_tile() == synth.SORT_TILE == kernels.SORT_TILE:
        fail("kernels", f"sort_pairs' tile {lib.pdt_sort_tile()} is not "
                        f"synth's {synth.SORT_TILE} or kernels.py's "
                        f"{kernels.SORT_TILE}")
    for tier in (kernels.TIER_I32, kernels.TIER_U32, kernels.TIER_I64):
        for rows, width in ((1, 1), (1, 4097), (8, (1 << 21) + 1),
                            (1, 15_199_506)):
            plan = kernels.sort_plan(tier, rows * width, rows)
            words = lib.pdt_sort_pairs_scratch(tier, rows, width)
            if plan["scratch_bytes"] != 8 * words:
                fail("kernels", f"sort_plan({tier}, {rows} x {width}) "
                                f"plans {plan['scratch_bytes']} bytes of "
                                f"scratch, the library takes {8 * words}")

    def on_card(pos, delta, pos_dt):
        p = torch.from_numpy(positions_to_words(pos.ravel(), pos_dt))
        return (p.reshape(pos.shape).to(dev),
                torch.from_numpy(delta).to(dev))

    for name, pos, delta, pos_dt in synth.sort_edge_events(seed=3):
        p, d = on_card(pos, delta, pos_dt)
        tier = tier_of(pos_dt)
        want = check.sort_case(p, d, tier, f"sort edge: {name}")
        if "pile-up" in name or "tail" in name:
            check.repeat("sort_pairs",
                         lambda: kernels.sort_pairs(p, d, tier), want,
                         f"sort edge: {name}")
    rng = np.random.RandomState(19)
    for pos_dt, least, most in synth.SORT_RANGES:
        pos = rng.randint(least, most, 1_000_003, dtype=np.int64)
        pos[rng.permutation(pos.shape[0])[:270_000]] = pos[7]
        delta = np.arange(pos.shape[0], dtype=np.int32)
        check.sort_case(*on_card(pos, delta, pos_dt), tier_of(pos_dt),
                        f"{np.dtype(pos_dt).name}: 1,000,003 events, "
                        f"270,000 on one position")
    for name, pos, delta, pos_dt in synth.sort_edge_rows(seed=4):
        check.sort_case(*on_card(pos, delta, pos_dt), tier_of(pos_dt),
                        f"sort rows: {name}")


def search_edge_cases(check: KernelCheck, dev) -> None:
    """eval_pair on the edges of its cooperative search and dense tiles,
    and eval_boundaries on each case's lo and hi concatenated
    (``synth.search_edge_cases``, the cases tests/test_torch_sweep.py and
    tests/test_torch_step.py hold the twins to JAX on): 1, 2, 15, 16, 17,
    255, 256 and 257 events
    and a few tiles' worth on every tier, boundaries before, on, beside
    and past the events, zero-length and reversed segments, a run of
    equal positions longer than a 16-way round's stride, and 40,000
    sorted segments whose tiles span more and fewer events than the
    staging window, then shuffled; after the library's stable sort and
    sweep_scan. eval_boundaries also on the concatenation less its last
    boundary (an odd count: a lo half one longer than its hi half), sorted
    and shuffled."""
    import numpy as np
    import torch

    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device import kernels, sweep
    from pandepth_tpu_torch.device.convert import positions_to_words

    rng = np.random.RandomState(16)
    for name, pos, delta, pos_dt, min_dep, lo, hi in \
            synth.search_edge_cases(seed=6):
        p = torch.from_numpy(positions_to_words(pos, pos_dt)).to(dev)
        pos_s, order = torch.sort(p, stable=True)
        delta_s = torch.from_numpy(delta).to(dev)[order]
        state = (pos_s, *kernels.sweep_scan(
            pos_s, delta_s, min_dep, False, int(np.iinfo(pos_dt).max)))
        q = [torch.from_numpy(x).to(dev).to(pos_s.dtype) for x in (lo, hi)]
        check.compare("eval_pair", kernels.eval_pair(*state, min_dep, *q),
                      sweep.eval_pair_reference(*state, min_dep, *q),
                      f"search edge: {name}, min_dep={min_dep}")
        x = torch.cat(q)
        shuffle = torch.from_numpy(rng.permutation(x.numel())).to(dev)
        for order, xs in (("lo and hi", x), ("lo and hi but the last", x[:-1]),
                          ("sorted", torch.sort(x).values),
                          ("shuffled", x[shuffle])):
            check.boundaries_case(*state, min_dep, xs,
                                  f"search edge: {name}, min_dep={min_dep}, "
                                  f"{order}")


def carry_edge_cases(check: KernelCheck, dev) -> None:
    """shard_carry on the edges of its runs and rows
    (``synth.carry_edge_blocks``, the cases tests/test_torch_sharding.py
    holds the twin to JAX on): row payloads of 1, a run - 1, a run, a run
    + 1 and a few runs of the kernel's over 1, 8 and 37 rows and
    more rows than a grid's y dimension takes, on the int32 and the uint32
    tier, an all-zero row, carries past 2^31 at a row edge, rows on
    earlier devices; the totals and the whole block against the twin's.
    Each block also as a view 1, 2 or 3 words (in turn) into a larger
    buffer, so that its deltas start off a 16-byte vector."""
    import torch

    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.device.convert import positions_to_words
    from pandepth_tpu_torch.sharding import steps

    for k, (name, pos, delta, pos_dt, bounds, left) in \
            enumerate(synth.carry_edge_blocks(seed=8)):
        rp = torch.from_numpy(positions_to_words(pos, pos_dt)).to(dev)
        rd = torch.from_numpy(delta).to(dev)
        off = 1 + k % 3
        blocks = [(rp.clone(), rd.clone(), "")]
        views = []
        for t in (rp, rd):
            flat = torch.zeros(t.numel() + off, dtype=t.dtype, device=dev)
            views.append(flat[off:].view(t.shape))
            views[-1].copy_(t)
        blocks.append((*views, f", a view {off} words into its buffer"))
        b, lt = (torch.from_numpy(a).to(dev) for a in (bounds, left))
        want = (steps.shard_carry_reference(rp, rd, b, lt), rp, rd)
        for kp, kd, at in blocks:
            check.compare("shard_carry", (kernels.shard_carry(kp, kd, b, lt),
                                          kp, kd), want,
                          f"carry edge: {name}{at}")


def enc_edge_cases(check: KernelCheck, dev) -> None:
    """decode_enc on every code group of every tier: escapes in both
    planes of the mixed format and in the const format's delta plane
    (negative jumps wrap the uint32 tier), zero rows, short rows, a
    partial block, windows of 2^19 slots (256 scan tiles a row) and of
    5,000 (a ragged last tile); then the whole finalize_encoded over the
    four groups, a raw chunk with a sentinel tail and 300 queries; and
    every group on the edges of the kernel's tiles
    (``synth.enc_edge_groups``: escapes on each tile's first and last
    slot, unsorted and duplicated entries, entries at CAP and past it, a
    full list, const rows with ns = 0 and ns = CAP), the cases
    tests/test_torch_encoded.py holds the twins to JAX on; and groups of
    18 blocks, more than one launch takes."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device.convert import (enc_group_from_numpy,
                                                   positions_to_words)
    from pandepth_tpu_torch.synth import enc_edge_groups, enc_group

    rng = np.random.RandomState(8)
    kinds = ((np.uint8, False), (np.uint16, False), (np.uint8, True),
             (np.uint16, True))
    for pos_dt, span in ((np.int32, 2_000_000_000),
                         (np.uint32, 4_200_000_000),
                         (np.int64, 17_000_000_000)):
        pm = int(np.iinfo(pos_dt).max)
        tier = np.dtype(pos_dt).name
        for kind, g in enc_edge_groups(pos_dt, seed=3 + len(tier)):
            check.decode_cases([enc_group_from_numpy(g, pos_dt, dev)], pm,
                               f"look-back edge: {tier} tier, {kind}")
        for const in (False, True):   # more blocks than one launch takes
            g, _ = enc_group(rng, np.uint8, pos_dt, 10_000, span - 100_000,
                             const, (1,) * 17 + (3,), 300, 8)
            check.decode_cases([enc_group_from_numpy(g, pos_dt, dev)], pm,
                               f"{tier} tier, 18 blocks of 300 slots")
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
    read; then on the edges of its tiles and look-back
    (``synth.extract_edge_batches``, the cases tests/test_torch_events.py
    holds the twin to JAX on): 1, a tile - 1, a tile, a tile + 1 and a
    few tiles of ops, reads starting on a tile's first and last op, a read
    of more than three tiles, zero-op reads at a tile boundary, JAX's
    padding across one, ref lengths past 2^32 across one."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.synth import (extract_edge_batches, jax_padded,
                                          make_batch)

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
        for name, b in extract_edge_batches(lengths, seed=seed):
            cols = device_cols(b, dev)
            for sentinel, dt in ((SENTINEL, torch.int64),
                                 (tier_sentinel, out_dtype)):
                check.extract_case(cols, *lay, 1796, 0, sentinel, dt,
                                   f"tile edge: {name}, lengths={lengths}, "
                                   f"sentinel={sentinel}")


def shard_case(check: KernelCheck, eng, lo, hi, what: str,
               timed: bool = False):
    """A sharded engine's bucketed rows, block by block, through
    shard_carry, sort_pairs' row form and each row's sweep_scan, and
    eval_pair_rows on ``lo``/``hi`` (numpy int64 global bounds), each
    against its twin; a later block takes the earlier blocks' totals;
    with ``timed`` sort_pairs' row form also 50 times and timed for a
    note. Returns the (rows, width) of the event block."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device import kernels, sweep
    from pandepth_tpu_torch.device.convert import tier_for_max
    from pandepth_tpu_torch.sharding import steps

    pos2d, delta2d = eng._bucketed()
    totals = []
    for blk in eng._blocks:
        p2, d2 = eng._upload_rows(pos2d, delta2d, blk)
        left = torch.cat([t.to(blk.device) for t in totals]) if totals \
            else torch.zeros(0, dtype=torch.int64, device=blk.device)
        kp, kd, rp, rd = p2.clone(), d2.clone(), p2, d2
        got = kernels.shard_carry(kp, kd, blk.bounds, left)
        want = steps.shard_carry_reference(rp, rd, blk.bounds, left)
        check.compare("shard_carry", (got, kp, kd), (want, rp, rd), what)
        totals.append(got)
        tier = tier_for_max(eng.pos_sentinel)
        ps2, ds2 = check.sort_case(kp, kd, tier, what + ", every row")
        if timed:
            check.repeat("sort_pairs",
                         lambda: kernels.sort_pairs(kp, kd, tier),
                         (ps2, ds2), what + ", every row")
            check.sort_case(kp, kd, tier, what,
                            note=f"{what}, each row on its own")
        state = steps.sort_scan_rows(kp, kd, eng.min_dep, eng.wrap18,
                                     eng.pos_sentinel)
        rows = [sweep.sweep_scan_reference(ps2[r], ds2[r], eng.min_dep,
                                           eng.wrap18, eng.pos_sentinel)
                for r in range(blk.rows)]
        check.compare("sort_pairs", state[:1], (ps2,),
                      what + ", sort_scan_rows")
        check.compare("sweep_scan", state[1:],
                      [torch.stack([x[k] for x in rows]) for k in range(3)],
                      what + ", every row")
        q = torch.from_numpy(np.stack([lo, hi]).astype(np.int64)).to(
            blk.device)
        args = (*state, blk.bounds, eng.min_dep, q[0], q[1])
        check.compare("eval_pair_rows", kernels.eval_pair_rows(*args),
                      steps.eval_pair_rows_reference(*args), what)
        if not timed:
            continue
        rows_n, width = kp.shape
        word = kp.element_size()
        b = np.asarray(eng.bounds[blk.r0:blk.r0 + blk.rows + 1])
        clipped = sum(int((np.clip(hi, b[r], b[r + 1])
                           != np.clip(lo, b[r], b[r + 1])).sum())
                      for r in range(rows_n))
        carry = lambda: kernels.shard_carry(kp, kd, blk.bounds,  # noqa
                                            left)

        def poisoned():
            kp[:, 0], kd[:, 0] = -5, 77   # slot 0 the kernel must write
            return carry(), kp[:, 0].clone(), kd[:, 0].clone()

        check.repeat("shard_carry", poisoned, (want, rp[:, 0], rd[:, 0]),
                     what)
        check.time("shard_carry", carry,
                   lambda: steps.shard_carry_reference(rp, rd, blk.bounds,
                                                       left),
                   rows_n * width * 4 + 8 * left.numel()
                   + rows_n * (8 + 8 + 4 + word))
        check.device_note("shard_carry", carry, what)
        row_sums = lambda: kd[:, 1:].sum(1, dtype=torch.int64)  # noqa
        check.notes.append(f"yardstick for shard_carry (not library_ms): "
                           f"the sum of each row's deltas past slot 0 "
                           f"(torch.sum), {what}: {cuda_ms(row_sums):.4f} "
                           f"ms, device {device_ms(row_sums)[0]:.4f} ms")
        kernel = lambda: kernels.eval_pair_rows(*args)  # noqa: E731
        want = steps.eval_pair_rows_reference(*args)
        check.repeat("eval_pair_rows", kernel, want, what)
        nbytes = (32 * lo.shape[0] + 8 * (rows_n + 1)
                  + 2 * clipped * search_bytes(width, word))
        check.time("eval_pair_rows", kernel,
                   lambda: steps.eval_pair_rows_reference(*args), nbytes)
        check.device_note("eval_pair_rows", kernel, what)
        check.searches.append(("eval_pair_rows", what,
                               nbytes / HBM_BYTES_PER_S * 1e3,
                               search_loads(width, 2 * clipped)))
        check.notes.append(f"eval_pair_rows: {clipped} of "
                           f"{lo.shape[0] * rows_n} (segment, row) clips "
                           f"non-empty, {what}")
    return tuple(pos2d.shape)


def shard_edge_cases(check: KernelCheck, dev) -> None:
    """The sharded engine's kernels on every position tier, wrap18 and
    min_dep 2, 1 and 8 rows on the card and 4 + 4 rows in two blocks (the
    second block takes the first's totals): random intervals over every
    contig with straddling, inner and zero-length segments, and
    ``synth.rows_edge_segments`` (segments crossing no row, one, two and
    every row, clips on a range's ends, reversed ones); then a hot
    range (every event in row 0 but one at the axis's end, in the last
    row; the rows between empty) with deltas that carry past int32; and
    the whole
    segment_stats against the same engine on the twins."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device.layout import GenomeLayout
    from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine
    from pandepth_tpu_torch.synth import rows_edge_segments

    rng = np.random.RandomState(12)
    other = torch.device(dev.type, 0 if dev.index is None else dev.index)
    layouts = ([7000, 4000, 900], [1_500_000_000, 1_000_000_000],
               [3_000_000_000, 2_000_000_000])
    for lengths in layouts:
        lay = GenomeLayout(np.asarray(lengths, np.int64))
        nt = len(lengths)
        # per contig: the whole contig (across ranges), its first half,
        # a short one inside a range, a zero-length one
        seg_tid = np.repeat(np.arange(nt), 4)
        ln = lay.lengths
        seg_start = np.tile([1, 11, 500, 20], nt)
        seg_end = np.stack([ln, ln // 2, np.full(nt, 600), np.full(nt, 19)],
                           1).ravel()
        for devs in ([dev] * 8, [dev], [dev] * 4 + [other] * 4):
            for min_dep, wrap18 in ((1, False), (2, True)):
                engs = [ShardedCoverageEngine(lay, min_dep=min_dep,
                                              wrap18=wrap18, devices=d)
                        for d in (devs, ["cpu"] * len(devs))]
                for hot in (False, True):
                    m = 400
                    if hot:
                        tid = np.zeros(m, np.int64)
                        s = rng.randint(0, 50, m)
                    else:
                        tid = rng.randint(0, nt, m)
                        s = (rng.rand(m) * lay.lengths[tid]).astype(np.int64)
                    e = s + rng.randint(1, 600, m)
                    for eng in engs:
                        eng.add_intervals(tid, s, e)
                        if hot:
                            eng.add_events(np.array([30, 31, 40, lay.total]),
                                           np.array([1 << 30, 1 << 30,
                                                     1 << 30, 1], np.int32))
                    what = (f"sharded {lay.total} cells, {len(devs)} rows, "
                            f"min_dep={min_dep} wrap18={wrap18} hot={hot}")
                    lo, hi = engs[0].segment_bounds(seg_tid, seg_start,
                                                    seg_end)
                    elo, ehi = rows_edge_segments(engs[0].bounds, seed=2)
                    shard_case(check, engs[0], np.concatenate([lo, elo]),
                               np.concatenate([hi, ehi]), what)
                    got, want = (eng.segment_stats(seg_tid, seg_start,
                                                   seg_end) for eng in engs)
                    check.compare("eval_pair_rows",
                                  [torch.from_numpy(got.cover),
                                   torch.from_numpy(got.depth_sum)],
                                  [torch.from_numpy(want.cover),
                                   torch.from_numpy(want.depth_sum)],
                                  what + ", whole segment_stats")


def many_rows_case(check: KernelCheck, dev, rows: int = 5000) -> None:
    """eval_pair_rows over more range cuts than the kernel stages in
    shared memory (EP_BOUNDS, 4,096): ``rows`` sorted rows of 6 slots on
    both position dtypes, slot 0 the range's start, at
    ``synth.rows_edge_segments``."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device import kernels, sweep
    from pandepth_tpu_torch.sharding import steps
    from pandepth_tpu_torch.synth import rows_edge_segments

    rng = np.random.RandomState(14)
    for dt, total in ((torch.int32, 2_000_000_000),
                      (torch.int64, 17_000_000_000)):
        b = np.linspace(0, total, rows + 1).astype(np.int64)
        p = b[:-1, None] + (rng.rand(rows, 6) * np.diff(b)[:, None]).astype(
            np.int64)
        p[:, 0] = b[:-1]
        pos = torch.from_numpy(np.sort(p, 1)).to(dt)
        delta = torch.from_numpy(rng.choice([-1, 1, 2], (rows, 6)).astype(
            np.int32))
        rows_state = [sweep.sweep_scan_reference(
            pos[r], delta[r], 1, False, int(torch.iinfo(dt).max))
            for r in range(rows)]
        state = [pos] + [torch.stack([x[k] for x in rows_state])
                         for k in range(3)]
        lo, hi = (torch.from_numpy(x) for x in rows_edge_segments(b, seed=3))
        args = (*state, torch.from_numpy(b), 1, lo, hi)
        # the twin on the host, where its row loop is cheap
        want = [t.to(dev) for t in steps.eval_pair_rows_reference(*args)]
        got = kernels.eval_pair_rows(
            *(a.to(dev) if torch.is_tensor(a) else a for a in args))
        check.compare("eval_pair_rows", got, want,
                      f"{rows} rows of 6 slots, {dt}, cuts read from device "
                      f"memory")


def sharded_states(check: KernelCheck, bam: str, bed: str, dev):
    """The 8-row blocks that the sharded engine stages for the chr path
    (timed) and the bed path, through shard_case, and the chr path's
    events through bucket_main_path; returns a description of each."""
    from pandepth_tpu_torch.cli import parse_args
    from pandepth_tpu_torch.run import stage

    shapes = {}
    for path, extra in (("chr_sharded", []), ("bed_sharded", ["-b", bed])):
        cfg = parse_args(["pandepth", "-i", bam, *extra, "-o", os.devnull])
        st = stage(cfg, [dev] * SHARD_ROWS)
        eng, t = st.engine, st.targets
        lo, hi = eng.segment_bounds(t.gene_tid[t.seg_gene], t.seg_start,
                                    t.seg_end)
        what = (f"{path} path ({sum(c[0].shape[0] for c in eng._chunks)} "
                f"events, {lo.shape[0]} segments, "
                f"{eng.pos_dtype.__name__} tier)")
        rows, width = shard_case(check, eng, lo, hi, what,
                                 timed=path == "chr_sharded")
        shapes[path] = f"{what[:-1]}, {rows} rows x {width} slots)"
        if path == "chr_sharded":
            shapes["bucket_events"] = bucket_main_path(check, eng, dev)
        del st, eng
    return shapes


def bucket_defined(out, live: int = None):
    """bucket_events' defined outputs: the first sum(counts) slots of
    both buffers (the rest is undefined in the kernel's), the counts and
    the sums."""
    n = int(out[2].sum()) if live is None else live
    return out[0][:n], out[1][:n], out[2], out[3]


def bucket_case(check: KernelCheck, pos, delta, bounds, tier: int,
                what: str) -> None:
    """bucket_events and its twin on one input: their defined outputs
    (:func:`bucket_defined`, cut at the twin's count)."""
    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.sharding import mesh

    got = kernels.bucket_events(pos, delta, bounds, tier)
    want = mesh.bucket_events_reference(pos, delta, bounds, tier)
    n = int(want[2].sum())
    check.compare("bucket_events", bucket_defined(got, n),
                  bucket_defined(want, n), what)


def bucket_edge_cases(check: KernelCheck, dev) -> None:
    """bucket_events on every position tier, over 1, 2, 3, 8 and 1024
    ranges: 0, 1, 5,000 and 1,000,003 events (a third of them in
    coordinate order, deltas -1, 0, 1, 5, dead slots at the sentinel too)
    and a hot range (every event in range 0 but one at the axis's end);
    then on the edges of its tiles and look-back
    (``synth.bucket_edge_events``, the cases tests/test_torch_multihost.py
    holds the twin to JAX on): 0, 1, a tile - 1, a tile, a tile + 1 and a
    few tiles of events over 1, 2, 8, 37 and 1024 ranges, a destination
    change on a tile's first and last event, an all-dead tile, a range
    empty everywhere and a hot range."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device.convert import tier_of
    from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32
    from pandepth_tpu_torch.synth import bucket_edge_events

    for name, pos, delta, np_dt, bounds in bucket_edge_events(seed=4):
        w = pos.astype(np_dt)
        if np_dt is np.uint32:
            w = w.view(np.int32)
        bucket_case(check, torch.from_numpy(w).to(dev),
                    torch.from_numpy(delta).to(dev),
                    torch.from_numpy(bounds).to(dev), tier_of(np_dt),
                    f"tile edge: {name}")

    rng = np.random.RandomState(21)
    for tier, np_dt, span in ((TIER_I32, np.int32, 2_000_000_000),
                              (TIER_U32, np.uint32, 4_200_000_000),
                              (TIER_I64, np.int64, 17_000_000_000)):
        sentinel = int(np.iinfo(np_dt).max)
        for world in (1, 2, 3, 8, 1024):
            step = -(-span // world)
            bounds = torch.from_numpy(np.minimum(
                np.arange(world + 1, dtype=np.int64) * step, span)).to(dev)
            for n, hot in ((0, False), (1, False), (5000, False),
                           (1_000_003, False), (5000, True)):
                p = rng.randint(0, 100 if hot else span, n).astype(np.int64)
                if hot:
                    p[-1] = span
                elif n > 10:
                    p[:n // 3] = np.sort(p[:n // 3])
                d = rng.choice([-1, 0, 1, 5], n).astype(np.int32)
                p[(d == 0) & (rng.rand(n) < 0.5)] = sentinel
                w = p.astype(np_dt)
                if np_dt is np.uint32:
                    w = w.view(np.int32)
                bucket_case(check, torch.from_numpy(w).to(dev),
                            torch.from_numpy(d).to(dev), bounds, tier,
                            f"{np.dtype(np_dt).name} tier, {world} ranges, "
                            f"{n} events, hot={hot}")


def bucket_main_path(check: KernelCheck, eng, dev) -> str:
    """bucket_events on the chr path's events as a rank of the
    multi-process engine uploads them (every chunk the feed left, in the
    tier's words), over RANGES ranges, against its twin; timed at 2
    ranges (the multiproc path's world) for the kernels line and at the
    others for notes, with the library's stable sort of the destinations
    (the order alone) beside it. Returns a description of the shape."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32
    from pandepth_tpu_torch.sharding import mesh

    pos = np.concatenate([c[0] for c in eng._chunks])
    delta = np.concatenate([c[1] for c in eng._chunks])
    tier = {np.int32: TIER_I32, np.uint32: TIER_U32,
            np.int64: TIER_I64}[eng.pos_dtype]
    if eng.pos_dtype is np.uint32:
        pos = pos.view(np.int32)
    pw, dw = torch.from_numpy(pos).to(dev), torch.from_numpy(delta).to(dev)
    n = pos.shape[0]
    what = f"chr path ({n} events, {eng.pos_dtype.__name__} tier)"
    for world in RANGES:
        bounds = torch.from_numpy(eng.layout.shard_bounds(world)).to(dev)
        bucket_case(check, pw, dw, bounds, tier, f"{what}, {world} ranges")
        key = pw.to(torch.int64)
        if tier == TIER_U32:
            key &= 0xFFFFFFFF
        dest = torch.searchsorted(bounds[1:-1].contiguous(), key,
                                  right=True).clamp_(max=world - 1)
        sort_ms = cuda_ms(lambda: torch.sort(dest, stable=True))
        note = "" if world == 2 else f"{what}, {world} ranges"
        kernel = lambda: kernels.bucket_events(  # noqa: E731
            pw, dw, bounds, tier)
        ms = check.time("bucket_events", kernel,
                        lambda: mesh.bucket_events_reference(pw, dw, bounds,
                                                             tier),
                        2 * n * (pos.itemsize + 4), note)
        check.device_note("bucket_events", kernel,
                          f"{what}, {world} ranges", ms)
        if world == 2:
            want = mesh.bucket_events_reference(pw, dw, bounds, tier)
            live = int(want[2].sum())
            check.repeat("bucket_events",
                         lambda: bucket_defined(kernel()),
                         bucket_defined(want, live), f"{what}, 2 ranges")
        if note:
            check.notes.append(f"library stable sort of the {n} "
                               f"destinations ({world} ranges; the order "
                               f"alone): {sort_ms:.4f} ms")
        else:
            check.library_ms["bucket_events"] = sort_ms
    return f"{what}, 2 ranges)"


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
            check.sweep_case(raw_s, raw_e, *args, timed=path == "chr",
                             pair_note=what if path == "bed" else "")
        else:
            check.decode_cases(groups, eng.pos_sentinel, what, timed=True,
                               note="" if path == "chr_enc" else what)
            check.finalize_enc_case(groups, cp, cd, q_lo, q_hi,
                                    eng.pos_sentinel, eng.min_dep,
                                    eng.wrap18, what,
                                    sort_note=what + ", its sort input"
                                    if path == "chr_enc" else "")
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


CHASE_LINKS = (64, 4096)   # the pointer chase's two walks


def load_latency_note(check: KernelCheck, dev) -> float:
    """The card's time per dependent load, for the latency-bound kernels'
    (K3, K5, eval_pair_rows) dependent-load bound: kernels.chase, one
    thread following CHASE_LINKS links of a seeded random cycle of 2^20
    int64 links (8 MB: after the warm-up call every link is in the L2
    cache, so a link takes the least a dependent load takes), each load's
    address the value of the one before; the device time's slope per
    link. The end of each walk is held to the host's walk of the same
    cycle. Returns the nanoseconds a dependent load."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device import kernels

    n = 1 << 20
    perm = np.random.RandomState(17).permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[perm] = np.roll(perm, -1)
    chain = torch.from_numpy(nxt).to(dev)
    times = []
    for k in CHASE_LINKS:
        i = 0
        for _ in range(k):
            i = int(nxt[i])
        if int(kernels.chase(chain, k)[0]) != i:
            fail("kernels", f"chase: the walk of {k} links does not end "
                            f"where the host's does")
        times.append(device_ms(lambda: kernels.chase(chain, k),
                               iters=20)[0])
    (k0, k1), (t0, t1) = CHASE_LINKS, times
    ns = (t1 - t0) / (k1 - k0) * 1e6
    check.notes.append(f"dependent-load latency: a one-thread pointer chase "
                       f"through {n} int64 links in L2 (kernels.chase), "
                       f"{t0:.4f} ms for {k0} links, {t1:.4f} ms for {k1}: "
                       f"{ns:.1f} ns a dependent load")
    return ns


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


class method_clock:
    """Inside the block, each call of ``cls.name`` appends its seconds
    (host clock) to ``seconds``."""

    def __init__(self, cls, name: str):
        self.cls, self.name = cls, name

    def __enter__(self):
        self.real, self.seconds = getattr(self.cls, self.name), []

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.real)


def bucket_clock() -> method_clock:
    """Each host bucketing of the sharded engine
    (``ShardedCoverageEngine._bucketed``) inside the block."""
    from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine

    return method_clock(ShardedCoverageEngine, "_bucketed")


class engines_made:
    """Every engine that ``pandepth_tpu_torch.run.make_engine`` makes
    inside the block, in ``made`` (which keeps them, and their device
    state, alive until it is dropped)."""

    def __enter__(self):
        from pandepth_tpu_torch import run

        self.run, self.real, self.made = run, run.make_engine, []

        def make(*a, **kw):
            self.made.append(self.real(*a, **kw))
            return self.made[-1]

        run.make_engine = make
        return self

    def __exit__(self, *exc):
        self.run.make_engine = self.real


def gz_digest(path: str):
    """(sha256 of the decompressed bytes, their lines), streamed."""
    import hashlib

    h, lines = hashlib.sha256(), 0
    with gzip.open(path, "rb") as fh:
        while chunk := fh.read(1 << 24):
            h.update(chunk)
            lines += chunk.count(b"\n")
    return h.hexdigest(), lines


class LibrarySortGuard:
    """While it is on, every call of torch.sort, torch.argsort,
    Tensor.sort or Tensor.argsort on a CUDA tensor is recorded in
    ``hits`` (where it came from), unless a plain twin (a function whose
    name ends in ``_reference``) made it: on the card the port sorts
    with its own kernel. The calls still run."""

    def __init__(self):
        self.hits, self.saved = [], []

    def start(self) -> None:
        import torch

        for owner, name in ((torch, "sort"), (torch, "argsort"),
                            (torch.Tensor, "sort"),
                            (torch.Tensor, "argsort")):
            real = getattr(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, self._guarded(name, real))

    def _guarded(self, name: str, real):
        import traceback

        import torch

        def guarded(t, *a, **kw):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                frames = traceback.extract_stack()[:-1]
                if not any(f.name.endswith("_reference") for f in frames):
                    self.hits.append(f"{name} of a {t.dtype} CUDA tensor "
                                     f"at {frames[-1].filename}:"
                                     f"{frames[-1].lineno}")
            return real(t, *a, **kw)

        return guarded

    def stop(self) -> list:
        for owner, name, real in self.saved:
            setattr(owner, name, real)
        self.saved = []
        return self.hits


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


def worker(argv) -> int:
    """One rank of a spawned path: ``chip_smoke.py worker MODE WORLD RANK
    BACKEND DEVICE STORE ARGS...``. MODE ``cli`` runs
    ``pandepth_tpu_torch.sharding.launch`` on the pandepth flags ARGS;
    ``step`` runs ``sharded_coverage_step`` on this rank's half of the
    batch in the .npz ARGS[0] and writes its (cover, dsum) beside it.
    ``{rank}`` in ARGS is replaced by the rank.
    Every kernel count is set to 0 just before the run. Prints one line,
    ``RANK`` and a JSON object: the exit code, the wall, the launches, the
    seconds and bytes of each exchange (``mesh.bucket_exchange``:
    bucketing and collectives, synchronised), and the bytes of the sweep
    state the rank fetched to the host (``-a``)."""
    import numpy as np
    import torch

    from pandepth_tpu_torch.device import kernels
    from pandepth_tpu_torch.sharding import mesh

    mode, world, rank, backend, device, store = argv[:6]
    world, rank = int(world), int(rank)
    rest = [a.replace("{rank}", str(rank)) for a in argv[6:]]
    if device.startswith("cuda"):
        kernels.library()   # loaded (built by the parent) before the run
    seconds, nbytes = [], []
    real = mesh.bucket_exchange

    def exchange(*a, **kw):
        t0 = time.perf_counter()
        ex = real(*a, **kw)
        if ex.pos.is_cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        nbytes.append(ex.nbytes)
        return ex

    mesh.bucket_exchange = exchange
    guard = LibrarySortGuard()
    guard.start()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fetched = 0
    if mode == "cli":
        from pandepth_tpu_torch.sharding.launch import main as launch

        with engines_made() as made:
            rc = launch(["launch", "--coordinator", store, "--nprocs",
                         str(world), "--rank", str(rank), "--backend",
                         backend, "--device", device, *rest])
        fetched = sum(e.state_fetch_bytes for e in made.made)
    else:
        import torch.distributed as dist

        from pandepth_tpu_torch.sharding.distributed import init_multihost

        dev = init_multihost(store, world, rank, backend, device)
        x = np.load(rest[0])
        cols = [torch.from_numpy(x[f"{c}{rank}"]).to(dev) for c in COLS]
        rep = [torch.from_numpy(x[k]).to(dev)
               for k in ("offsets", "limits", "bounds", "lo", "hi")]
        step = mesh.sharded_coverage_step(None, int(x["flags_mask"]),
                                          int(x["min_mapq"]), 1)
        cover, dsum = step(*cols, *rep)
        np.savez(f"{rest[0]}.out{rank}.npz", cover=cover.cpu().numpy(),
                 dsum=dsum.cpu().numpy())
        dist.barrier()
        dist.destroy_process_group()
        rc = 0
    wall = time.perf_counter() - t0
    print("RANK " + json.dumps({
        "rank": rank, "rc": rc, "wall": wall, "launches": kernels.launches,
        "exchange_s": seconds, "exchange_bytes": nbytes,
        "state_fetch_bytes": fetched, "library_sorts": guard.stop()}),
        flush=True)
    return rc


def spawned(path: str, mode: str, world: int, backend: str, args,
            tmp: str, device: str = "cuda:0"):
    """``path`` run by ``world`` worker processes (:func:`worker`) on
    ``device``, joined through a file store in ``tmp``; all are killed and the
    phase fails when one fails or the job passes JOB_SECONDS. Fails unless
    the ranks together launched every kernel of the path. Returns (each
    rank's RANK object, each rank's RunStats line or None, the launches
    summed over the ranks, the job's wall)."""
    logs = [os.path.join(tmp, f"{path}.r{r}.{k}") for r in range(world)
            for k in ("out", "err")]
    envs = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    store = "file://" + os.path.join(tmp, f"{path}.store")
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        with open(logs[2 * r], "w") as out, open(logs[2 * r + 1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "worker", mode,
                 str(world), str(r), backend, device, store, *args],
                cwd=ROOT, env=envs, stdout=out, stderr=err))
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        late = time.perf_counter() - t0 > JOB_SECONDS
        if bad or late:
            for p in procs:
                p.kill()
                p.wait()
            why = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad \
                else f"passed {JOB_SECONDS} s"
            with open(logs[2 * bad[0] + 1 if bad else 1]) as fh:
                fail("e2e", f"{path}: {why}: {fh.read()[-3000:]}")
        time.sleep(0.1)
    wall = time.perf_counter() - t0
    ranks, stats = [], []
    for r, p in enumerate(procs):
        with open(logs[2 * r]) as fh:
            got = [ln[5:] for ln in fh.read().splitlines()
                   if ln.startswith("RANK ")]
        with open(logs[2 * r + 1]) as fh:
            err = fh.read()
        if p.returncode != 0 or len(got) != 1:
            fail("e2e", f"{path}: rank {r} exited {p.returncode}: "
                        f"{err[-3000:]}")
        ranks.append(json.loads(got[0]))
        walls = [ln for ln in err.splitlines() if ln.startswith("INFO: wall=")]
        stats.append(walls[-1][6:] if walls else None)
    runs = {k: sum(x["launches"][k] for x in ranks) for k in REPLACES}
    missing = [k for k in PATHS[path] if runs[k] < 1]
    if missing:
        fail("e2e", f"{path}: {missing} not launched on the path: {runs}")
    sorts = [h for x in ranks for h in x["library_sorts"]]
    if sorts:
        fail("e2e", f"{path}: a library sort of a CUDA tensor: {sorts[:5]}")
    return ranks, stats, runs, wall


def rank_lines(ranks, stats) -> str:
    """Each rank's wall, exchanges and launches, for a say() line."""
    return "; ".join(
        f"rank {x['rank']}: {x['wall']:.3f} s in the worker (exchange "
        f"{', '.join(f'{s:.4f}' for s in x['exchange_s'])} s, "
        f"{', '.join(str(b) for b in x['exchange_bytes'])} bytes), "
        f"launches { {k: v for k, v in x['launches'].items() if v} }"
        + (f", RunStats {st}" if st else "") for x, st in zip(ranks, stats))


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
             "gene_gc": ["-g", "{d}/safe.gff", "-c", "-r", "{d}/ref.fa"],
             "win": ["-w", "100"]}
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


#: the host sweep's wall seconds by output prefix, for the host phase
HOST_WALLS = {}


def host_sweep(args, out: str):
    """The JAX package's jax-free native host sweep as a CLI process;
    returns its wall seconds (and keeps it in HOST_WALLS)."""
    env = dict(os.environ, PANDEPTH_HOST_FINALIZE="1",
               PANDEPTH_NATIVE_BUILD=ORACLE_NATIVE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu.cli", *args,
                        "-o", out], cwd=ROOT, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail("e2e", f"host sweep exited {r.returncode}: {r.stderr[-2000:]}")
    HOST_WALLS[os.path.basename(out)] = wall
    return wall


def run_cli(port_main, args, device) -> None:
    """The port's CLI in this process; fails unless it exits 0."""
    rc = port_main(["pandepth", *args], device=device)
    if rc != 0:
        fail("e2e", f"the port's CLI ({' '.join(args)}) exited {rc}")


def site_phase(port_main, kernels, site: str, tmp: str, dev) -> dict:
    """``-a`` on the 12 Mb, 30x fixture: on one device with encoded
    windows (the default) and with raw pairs, on 8 rows of the card, and
    as a 2-rank gloo job sharing it, each counted; every .SiteDepth.gz and
    chr table byte-equal to the host sweep's. Returns each path's
    launches."""
    import torch

    host = os.path.join(tmp, "sitehost")
    host_wall = host_sweep(["-i", site, "-a"], host)
    want = [gz_digest(f"{host}.{k}") for k in ("SiteDepth.gz", "chr.stat.gz")]
    if want[0][1] != 16 * 750_000:
        fail("site", f"the host sweep's dump has {want[0][1]} lines")
    say("site", f"host sweep CLI process {host_wall:.3f} s, "
                f"{want[0][1]} lines")
    runs = {}
    for path, devs, feed in (("site", dev, env), ("site_raw", dev, raw_pairs),
                             ("site_sharded", [dev] * SHARD_ROWS, env)):
        out = os.path.join(tmp, path)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with feed(), engines_made() as made:
            _, runs[path], wall = counted(
                kernels, path,
                lambda: run_cli(port_main, ["-i", site, "-a", "-o", out],
                                devs))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        fetch = [(e.state_fetches, e.state_fetch_bytes,
                  e.state_fetch_seconds) for e in made.made]
        del made
        if [gz_digest(f"{out}.{k}") for k in ("SiteDepth.gz",
                                              "chr.stat.gz")] != want:
            fail("site", f"{path}: the dump or the chr table differs from "
                         f"the host sweep's")
        say("site", f"{path} ({'8 rows' if isinstance(devs, list) else 'one device'}): "
                    f"{wall:.3f} s in this process; state fetch "
                    f"{fetch[0][0]} x, {fetch[0][1]} bytes, "
                    f"{fetch[0][2] * 1e3:.3f} ms; peak device memory "
                    f"{peak:.1f} MiB above the smoke's own tensors; launches "
                    f"{runs[path]}; dump and table byte-equal to the host "
                    f"sweep's")
    out = os.path.join(tmp, "site_multiproc")
    ranks, stats, runs["site_multiproc"], wall = spawned(
        "site_multiproc", "cli", 2, "gloo", ["-i", site, "-a", "-o", out],
        tmp)
    left = [f for f in os.listdir(tmp) if ".SiteDepth.gz.part" in f]
    if left or [gz_digest(f"{out}.{k}") for k in ("SiteDepth.gz",
                                                  "chr.stat.gz")] != want:
        fail("site", f"site_multiproc: the joined dump or the table differs "
                     f"from the host sweep's, or parts were left: {left}")
    say("site", f"site_multiproc (2 gloo ranks on cuda:0): job {wall:.3f} "
                f"s; {rank_lines(ranks, stats)}; state fetch bytes "
                f"{[x['state_fetch_bytes'] for x in ranks]}; launches "
                f"{runs['site_multiproc']}; the joined dump byte-equal to the "
                f"host sweep's, no part left")
    return runs


def genome_windows(lengths, win: int):
    """Every mode-6 window of every contig: (tid, start1, end1)."""
    import numpy as np

    from pandepth_tpu_torch.targets.windows import small_window_tiling

    parts = [small_window_tiling(int(n), win) for n in lengths]
    return (np.concatenate([np.full(p.shape[0], k, np.int32)
                            for k, p in enumerate(parts)]),
            np.concatenate([p[:, 0] for p in parts]),
            np.concatenate([p[:, 1] for p in parts]))


def chunked_launches(lengths, win: int) -> int:
    """eval_pair's launches for mode 6's windows, one contig at a time in
    chunks of QUERY_CHUNK queries, plus the finalize's one."""
    # small_window_tiling's starts: 1, 1 + win, ... below the length
    n_windows = [max(0, -(-(int(n) - 1) // win)) for n in lengths]
    return 1 + sum(-(-w // QUERY_CHUNK) for w in n_windows)


def win6_phase(port_main, kernels, bam: str, tmp: str, dev) -> dict:
    """``-w 100`` (mode 6) on the 3 Gb fixture, counted: the table against
    the host sweep's; the windows evaluated by K3 on the kept state, each
    contig's in chunks (eval_pair's launches at least
    :func:`chunked_launches`), with no state fetched to the host; the wall
    and the seconds of the segment_stats calls. Returns the path's
    launches."""
    from pandepth_tpu_torch.device.engine import CoverageEngine

    host = os.path.join(tmp, "win6host")
    host_wall = host_sweep(["-i", bam, "-w", str(WIN6_BP)], host)
    want = gz_digest(host + ".win.stat.gz")
    out = os.path.join(tmp, "win6")
    with engines_made() as made, \
            method_clock(CoverageEngine, "segment_stats") as k3:
        _, runs, wall = counted(
            kernels, "win6",
            lambda: run_cli(port_main, ["-i", bam, "-w", str(WIN6_BP), "-o",
                                        out], dev))
    eng = made.made[0]
    del made
    least = chunked_launches(eng.layout.lengths, WIN6_BP)
    if eng.state_fetches != 0 or runs["eval_pair"] < least:
        fail("win6", f"{eng.state_fetches} state fetches and "
                     f"{runs['eval_pair']} eval_pair launches (at least "
                     f"{least}): not the chunked eval on the card")
    if gz_digest(out + ".win.stat.gz") != want:
        fail("win6", "the table differs from the host sweep's")
    say("win6", f"-w {WIN6_BP}, {want[1]} lines: {wall:.3f} s in this "
                f"process (host sweep CLI process {host_wall:.3f} s), of "
                f"it K3's chunked eval (segment_stats, copies included) "
                f"{sum(k3.seconds):.3f} s in {len(k3.seconds)} calls; no "
                f"state fetch; launches {runs}; table byte-equal to the "
                f"host sweep's")
    return runs


def settled_stat(serve, sock: str) -> dict:
    """The idle daemon's ``stat``, its ``cuda_used`` the least of
    SETTLE_READS readings a quarter second apart (the greatest as
    ``peak_used``). The card's used bytes count every process on it, and
    other processes' contexts come and go on the card for up to half a
    second about once a minute (``tools/daemon_mem_probe.py --watch``);
    the daemon, idle between requests, holds in every reading what it
    keeps. Its allocator and launches must not move meanwhile."""
    sts = []
    with env(PANDEPTH_DAEMON_SOCK=sock):
        for k in range(SETTLE_READS):
            if k:
                time.sleep(0.25)
            sts.append(serve.daemon_stat())
    own = ("cuda_allocated", "cuda_reserved", "launches")
    if any(st.get(k) != sts[0].get(k) for st in sts for k in own):
        fail("daemon", f"the idle daemon's allocator or launches moved "
                       f"between readings: {sts}")
    used = [st["cuda_used"] for st in sts]
    return dict(sts[0], cuda_used=min(used), peak_used=max(used))


def settle(serve, sock: str) -> list:
    """Wait DAEMON_SETTLE_S seconds with the daemon idle after its first
    request, reading the card's used bytes every half second; returns
    each step (s, bytes). The daemon's context takes its last 64 KiB up
    to 13.2 s after its first reply (``tools/daemon_mem_probe.py
    --pause``), and later runs add nothing: its footprint after the
    first request is the one it has once idle that long."""
    steps, t0 = [], time.perf_counter()
    with env(PANDEPTH_DAEMON_SOCK=sock):
        last = serve.daemon_stat()["cuda_used"]
        while time.perf_counter() - t0 < DAEMON_SETTLE_S:
            time.sleep(0.5)
            used = serve.daemon_stat()["cuda_used"]
            if used != last:
                steps.append((round(time.perf_counter() - t0, 2),
                              used - last))
                last = used
    return steps


def daemon_phase(bam: str, tmp: str, want: bytes) -> dict:
    """Three chr runs through ``python -m pandepth_tpu_torch`` with
    ``PANDEPTH_DAEMON=1 PANDEPTH_DAEMON_REQUIRE=1`` (the first spawns the
    daemon, on a socket in the temp directory), beside a fresh
    ``python -m pandepth_tpu_torch.cli`` process and ``PANDEPTH_DAEMON=0
    python -m pandepth_tpu_torch``; every table byte-equal to ``want``;
    the daemon's launches and device memory after each request (``settle``
    after the first, then ``settled_stat``), which must not grow after the
    first; the daemon stopped whatever happens.
    Returns the launches of the three runs."""
    import shutil
    import signal

    from pandepth_tpu_torch import serve

    sock_dir = tempfile.mkdtemp(prefix="pdt")
    sock = os.path.join(sock_dir, "d.sock")
    denv = dict(os.environ, PANDEPTH_DAEMON="1", PANDEPTH_DAEMON_REQUIRE="1",
                PANDEPTH_DAEMON_SOCK=sock, PANDEPTH_DAEMON_IDLE_S="300")

    def process(args, e, out):
        """(the process's wall, its run's RunStats wall) in seconds."""
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *args, "-i", bam, "-o",
                            os.path.join(tmp, out), "-v"], cwd=ROOT, env=e,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail("daemon", f"{' '.join(args)} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
        if table(os.path.join(tmp, out)) != want:
            fail("daemon", f"{out}: the chr table differs from the "
                           f"in-process run's")
        run = [ln.split()[1][5:-1] for ln in r.stderr.splitlines()
               if ln.startswith("INFO: wall=")]
        return wall, float(run[-1])

    def smi_mib(pid):
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                            "used_memory", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True)
        for line in r.stdout.splitlines():
            p, _, mib = line.partition(",")
            if p.strip() == str(pid):
                return int(mib)
        return None

    pid, walls, mem, total, prev = None, [], [], {}, {}
    peaks, late = [], []
    try:
        cold = process(["pandepth_tpu_torch.cli"], dict(os.environ), "dcold")
        inproc = process(["pandepth_tpu_torch"],
                         dict(denv, PANDEPTH_DAEMON="0"), "d0")
        for k in range(DAEMON_RUNS):
            walls.append(process(["pandepth_tpu_torch"], denv, f"daemon{k}"))
            if k == 0:
                late = settle(serve, sock)
            st = settled_stat(serve, sock)
            peaks.append(st["peak_used"])
            pid = st["pid"]
            runs = {n: st["launches"][n] - prev.get(n, 0)
                    for n in st["launches"]}
            prev = st["launches"]
            missing = [n for n in PATHS["daemon"] if runs[n] < 1]
            if missing:
                fail("daemon", f"run {k}: {missing} not launched: {runs}")
            for n, v in runs.items():
                total[n] = total.get(n, 0) + v
            mem.append((smi_mib(pid), st["cuda_allocated"],
                        st["cuda_reserved"], st["cuda_used"]))
        # nvidia-smi may list no process in a container: then the card's
        # used bytes, read in the daemon, stand for its context
        if any(m[0] is not None and m[0] > mem[0][0]
               or any(m[k] > mem[0][k] for k in (1, 2, 3))
               for m in mem[1:]):
            fail("daemon", f"the daemon's device memory grew after the "
                           f"first request: {mem}")
    finally:
        subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                        "--daemon-stop"], cwd=ROOT, env=denv, timeout=120)
        if pid is not None:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    os.kill(pid, 0)
                except OSError:
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)
        shutil.rmtree(sock_dir, ignore_errors=True)
    say("daemon", f"chr ({N_READS} reads) through the daemon, client "
                  f"process wall (the daemon's RunStats wall): "
                  f"{', '.join(f'{w:.3f} ({r:.2f})' for w, r in walls)} s "
                  f"(the first spawns it); a fresh `python -m "
                  f"pandepth_tpu_torch.cli` process {cold[0]:.3f} "
                  f"({cold[1]:.2f}) s; PANDEPTH_DAEMON=0 `python -m "
                  f"pandepth_tpu_torch` {inproc[0]:.3f} ({inproc[1]:.2f}) "
                  f"s; every table byte-equal to the in-process run's")
    say("daemon", f"the daemon's device memory after each request (MiB by "
                  f"nvidia-smi, bytes allocated, bytes reserved, the card's "
                  f"bytes in use by mem_get_info, the least of "
                  f"{SETTLE_READS} readings; their greatest {peaks}): "
                  f"{mem}, the baseline read {DAEMON_SETTLE_S} s after "
                  f"the first request (the card's used bytes stepped "
                  f"meanwhile (s, bytes): {late}); launches of the "
                  f"{DAEMON_RUNS} runs {total}; stopped")
    return total


def wrap18_phase(port_main, kernels, deep: str, tmp: str, dev) -> dict:
    """``-a``, ``-w 100`` and chr on synth.deep_bam, each counted, on one
    device; the .SiteDepth.gz and every table byte-equal to the host
    sweep's, and the dump's cell at 101 wrapped to 270,000 - 2^18.
    Returns each path's launches."""
    runs = {}
    for path, extra, kinds in (
            ("wrap18_site", ["-a"], ("SiteDepth.gz", "chr.stat.gz")),
            ("wrap18_w100", ["-w", "100"], ("win.stat.gz",)),
            ("wrap18_chr", [], ("chr.stat.gz",))):
        host = os.path.join(tmp, f"{path}_host")
        host_wall = host_sweep(["-i", deep, *extra], host)
        out = os.path.join(tmp, path)
        _, runs[path], wall = counted(
            kernels, path,
            lambda: run_cli(port_main, ["-i", deep, *extra, "-o", out], dev))
        for kind in kinds:
            if gz_digest(f"{out}.{kind}") != gz_digest(f"{host}.{kind}"):
                fail("wrap18", f"{path}: {kind} differs from the host "
                               f"sweep's")
        say("wrap18", f"{path} ({' '.join(extra) or 'chr'}): {wall:.3f} s in "
                      f"this process; launches {runs[path]}; "
                      f"{', '.join(kinds)} byte-equal to the host sweep's "
                      f"(host sweep CLI process {host_wall:.3f} s)")
    with gzip.open(os.path.join(tmp, "wrap18_site.SiteDepth.gz"), "rb") as fh:
        if b"c1\t101\t7856\n" not in fh.read():
            fail("wrap18", "the dump's cell at 101 is not 270,000 - 2^18")
    return runs


# a fresh process in the serial order: the start-up (torch, the CUDA
# context, the kernel library) first, then the CLI, which then has no
# start-up left to overlap; argv = the BAM, the output prefix
SERIAL = r"""
import sys

from pandepth_tpu_torch import boot

boot.start_up()
from pandepth_tpu_torch.cli import main

sys.exit(main(["pandepth", "-i", sys.argv[1], "-o", sys.argv[2], "-v"]))
"""


def fresh_chr(way: str, bam: str, out: str, root: str = ROOT, env=None):
    """One fresh chr process on ``bam`` from the checkout ``root``:
    ``overlap`` is ``python -m pandepth_tpu_torch.cli -v`` (the start-up
    overlapped with the stash), ``serial`` SERIAL. Returns (process wall
    on the host clock, windows stashed, RunStats line, chr table bytes);
    raises RuntimeError when the process fails."""
    cmd = [sys.executable, "-m", "pandepth_tpu_torch.cli", "-i", bam,
           "-o", out, "-v"] if way == "overlap" else \
        [sys.executable, "-c", SERIAL, bam, out]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"the {way} process exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    line = [ln[6:] for ln in r.stderr.splitlines()
            if ln.startswith("INFO: wall=")][-1]
    stashed = re.search(r"stashed=(\d+)", line)
    return wall, int(stashed.group(1)) if stashed else 0, line, table(out)


def boot_phase(bam: str, tmp: str, want: bytes) -> dict:
    """Fresh chr processes on ``bam``: overlapped and SERIAL in turns
    overlap, serial, serial, overlap, then one overlapped on the sharded
    engine (``PANDEPTH_SHARDED=1``: the stash and the rest of the stream
    decoded on the host); every table byte-equal to ``want``, and at least
    one window stashed in each overlapped run. Returns each way's
    (process wall, windows stashed, RunStats line) runs."""
    sharded = dict(os.environ, PANDEPTH_SHARDED="1")
    got = {"overlap": [], "serial": [], "overlap_sharded": []}
    for way in ("overlap", "serial", "serial", "overlap", "overlap_sharded"):
        try:
            run = fresh_chr(way.removesuffix("_sharded"), bam,
                            os.path.join(tmp, f"boot_{way}{len(got[way])}"),
                            env=sharded if way.endswith("_sharded") else None)
        except RuntimeError as e:
            fail("boot", str(e))
        if run[3] != want:
            fail("boot", f"the {way} process's chr table differs from the "
                         f"in-process run's")
        got[way].append(run[:3])
    if any(stashed < 1 for _, stashed, _ in
           got["overlap"] + got["overlap_sharded"]):
        fail("boot", f"an overlapped process stashed no window: {got}")
    for way, runs in got.items():
        say("boot", f"{way}: fresh chr process walls "
                    f"{', '.join(f'{w:.3f}' for w, _, _ in runs)} s; "
                    f"RunStats {' | '.join(ln for _, _, ln in runs)}")
    say("boot", "every table byte-equal to the in-process run's")
    return got


def graft_phase(kernels) -> dict:
    """``graft_entry.entry()`` on cuda:0, counted, against its CPU twin,
    array-equal; ``dryrun_multichip(2)`` (gloo ranks sharing the card)
    under JOB_SECONDS. Returns entry()'s launches."""
    import torch

    from pandepth_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    (cov, dsum), runs, wall = counted(
        kernels, "graft", lambda: [t.cpu() for t in fn(*args)])
    twin_fn, twin_args = graft_entry.entry(device="cpu")
    want = twin_fn(*twin_args)
    if not (torch.equal(cov, want[0]) and torch.equal(dsum, want[1])):
        fail("graft", f"entry() on the card ({cov.tolist()}, "
                      f"{dsum.tolist()}) differs from its CPU twin "
                      f"({want[0].tolist()}, {want[1].tolist()})")
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(2, seconds=JOB_SECONDS)
    dry_wall = time.perf_counter() - t0
    say("graft", f"entry(): coverage_step on cuda:0 {wall * 1e3:.3f} ms "
                 f"(first call, host clock), cover {cov.tolist()}, launches "
                 f"{runs}, array-equal to its CPU twin; dryrun_multichip(2): "
                 f"{dry['backend']} ranks on {', '.join(dry['devices'])}, "
                 f"{dry_wall:.3f} s, every rank's (cover, dsum) equal to "
                 f"coverage_step on all the reads ({dry['cover'].tolist()})")
    return runs


# a fresh ``python -m pandepth_tpu_torch.cli`` (run as -m runs it) that
# reports last on its stderr whether it imported anything of torch, its
# ru_maxrss at its start and at its end, and the streaming folds its host
# engines took; argv = the CLI's flags
HOST_CHILD = r"""
import atexit, json, resource, runpy, sys

START_KB = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
from pandepth_tpu_torch.device.host_engine import HostCoverageEngine

ENGINES = []
made = HostCoverageEngine.__init__
HostCoverageEngine.__init__ = \
    lambda self, *a, **k: (made(self, *a, **k), ENGINES.append(self))[0]


def report():
    print("HOST_CHILD " + json.dumps({
        "torch": any(m.split(".")[0] == "torch" for m in sys.modules),
        "start_kb": START_KB,
        "maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        "folds": sum(e.folds for e in ENGINES)}),
        file=sys.stderr, flush=True)


atexit.register(report)
sys.argv = ["pandepth_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("pandepth_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""
# a process's ru_maxrss starts at the resident size of the memory it was
# spawned from (exec keeps the old memory's peak), so the child starts
# from a shell that forks it, not from this process's gigabytes
VIA_SHELL = ["/bin/sh", "-c", '"$@"; exit $?', "sh"]


def host_child(args, out: str, **env_set):
    """One fresh forced-host CLI process of the port (HOST_CHILD, through
    VIA_SHELL) with ``env_set`` on top of PANDEPTH_HOST_FINALIZE=1; fails
    if it exits non-zero, imported torch, or started from a large
    ru_maxrss. Returns (wall seconds, peak RSS in MiB, folds taken)."""
    e = dict(os.environ, PANDEPTH_HOST_FINALIZE="1", **env_set)
    t0 = time.perf_counter()
    r = subprocess.run([*VIA_SHELL, sys.executable, "-c", HOST_CHILD, *args,
                        "-o", out], cwd=ROOT, env=e, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    rep = [json.loads(ln[len("HOST_CHILD "):])
           for ln in r.stderr.splitlines() if ln.startswith("HOST_CHILD ")]
    if r.returncode != 0 or len(rep) != 1:
        fail("host", f"{' '.join(args)} exited {r.returncode}: "
                     f"{r.stderr[-2000:]}")
    rep = rep[0]
    if rep["torch"]:
        fail("host", f"{' '.join(args)}: the forced-host process imported "
                     f"torch")
    if rep["start_kb"] > 128 << 10:
        fail("host", f"{' '.join(args)}: its ru_maxrss started at "
                     f"{rep['start_kb']} kB, not its own")
    return wall, rep["maxrss_kb"] / 1024.0, rep["folds"]


def host_phase(files: dict, tmp: str, boot: dict) -> None:
    """Fresh forced-host processes of the port (HOST_CHILD) on the smoke's
    fixtures at full size: chr, -b, -w 1500, -w 100, the .list, the PAF
    and -a on the site fixture, each table byte-equal to the device run's
    of this call and to the host sweep's, each wall beside the host
    sweep's, run again right after it; chr with folds every 2^20 pairs against
    PANDEPTH_STREAM_FOLD=0 (the peak RSS of each), and the same on the
    spliced fixture; PANDEPTH_SITE_SPLIT=1
    on -a and on the .list against the one-shot runs; two requests
    through a daemon (PANDEPTH_DAEMON=1), the second warm. No child
    imports torch, so none launches a kernel."""
    bam, bed, lst, paf, site = (files[k] for k in
                                ("bam", "bed", "lst", "paf", "site"))
    cases = (("chr", ["-i", bam], ("chr.stat.gz",), "port", "host"),
             ("bed", ["-i", bam, "-b", bed], ("bed.stat.gz",), "bedport",
              "bedhost"),
             ("win", ["-i", bam, "-w", str(WIN_BP)], ("win.stat.gz",),
              "winport", "winhost"),
             ("win6", ["-i", bam, "-w", str(WIN6_BP)], ("win.stat.gz",),
              "win6", "win6host"),
             ("list", ["-i", lst], ("chr.stat.gz",), "listport",
              "listhost"),
             ("paf", ["-i", paf], ("chr.stat.gz",), "pafport", "pafhost"),
             ("site", ["-i", site, "-a"], ("SiteDepth.gz", "chr.stat.gz"),
              "site", "sitehost"))
    want = {}
    for case, args, kinds, device_out, host_out in cases:
        out = os.path.join(tmp, f"hostport_{case}")
        wall, rss, _ = host_child(args, out)
        # the host sweep once more, right after the port's process
        again = host_sweep(args, os.path.join(tmp, f"hostjax_{case}"))
        got = [gz_digest(f"{out}.{k}") for k in kinds]
        for other in (device_out, host_out, f"hostjax_{case}"):
            if got != [gz_digest(os.path.join(tmp, f"{other}.{k}"))
                       for k in kinds]:
                fail("host", f"{case}: {', '.join(kinds)} differ from the "
                             f"{other} run's")
        want[case] = got
        say("host", f"{case} ({' '.join(args[2:]) or 'chr'}): fresh "
                    f"forced-host process of the port {wall:.3f} s, peak "
                    f"RSS {rss:.1f} MiB; the JAX package's host sweep just "
                    f"after it {again:.3f} s (earlier in this call "
                    f"{HOST_WALLS[host_out]:.3f} s); {', '.join(kinds)} "
                    f"byte-equal to the device run's and the host sweep's")
    walls = {way: [w for w, _, _ in runs] for way, runs in boot.items()}
    say("host", f"the boot phase's fresh device processes (chr): "
                f"{walls}")

    # the streaming fold: a fold past every 2^20 staged pairs, against
    # the run without it, on the 8M-read fixture (one segment a read) and
    # on the spliced one (three, the last past the next reads' starts),
    # whose table is also held to the host sweep's (too few pairs for
    # its fold, which raises on such reads)
    spliced_host = os.path.join(tmp, "splicedhost")
    spliced_wall = host_sweep(["-i", files["spliced"]], spliced_host)
    want["spliced"] = [gz_digest(f"{spliced_host}.chr.stat.gz")]
    for case, least in (("chr", HOST_MIN_FOLDS),
                        ("spliced", SPLICED_MIN_FOLDS)):
        src = bam if case == "chr" else files["spliced"]
        runs = {}
        for way, extra in (("fold", {"PANDEPTH_FOLD_PAIRS": str(1 << 20)}),
                           ("nofold", {"PANDEPTH_STREAM_FOLD": "0"})):
            out = os.path.join(tmp, f"host{way}_{case}")
            runs[way] = host_child(["-i", src], out, **extra)
            if [gz_digest(f"{out}.chr.stat.gz")] != want[case]:
                fail("host", f"{case} {way}: the chr table differs from "
                             f"the host sweep's")
        folds = runs["fold"][2]
        if folds < least or runs["nofold"][2]:
            fail("host", f"{case}: {folds} folds, fewer than {least}, or "
                         f"{runs['nofold'][2]} without the fold")
        say("host", f"{case} with PANDEPTH_FOLD_PAIRS={1 << 20}: {folds} "
                    f"folds, {runs['fold'][0]:.3f} s, peak RSS "
                    f"{runs['fold'][1]:.1f} MiB; PANDEPTH_STREAM_FOLD=0 "
                    f"{runs['nofold'][0]:.3f} s, peak RSS "
                    f"{runs['nofold'][1]:.1f} MiB; tables byte-equal"
                    + (f" to the host sweep's ({spliced_wall:.3f} s)"
                       if case == "spliced" else ""))

    # the per-contig split passes, forced, against the one-shot runs
    for case, args, kinds in (("site", ["-i", site, "-a"],
                               ("SiteDepth.gz", "chr.stat.gz")),
                              ("list", ["-i", lst], ("chr.stat.gz",))):
        out = os.path.join(tmp, f"hostsplit_{case}")
        wall, rss, _ = host_child(args, out, PANDEPTH_SITE_SPLIT="1")
        if [gz_digest(f"{out}.{k}") for k in kinds] != want[case]:
            fail("host", f"split {case}: {', '.join(kinds)} differ from "
                         f"the one-shot run's")
        say("host", f"PANDEPTH_SITE_SPLIT=1 on {case}: {wall:.3f} s, peak "
                    f"RSS {rss:.1f} MiB; byte-equal to the one-shot run's")

    # the host engine inside the daemon: the first request spawns it
    import shutil
    import signal

    from pandepth_tpu_torch import serve

    sock_dir = tempfile.mkdtemp(prefix="pdt")
    denv = dict(os.environ, PANDEPTH_DAEMON="1", PANDEPTH_DAEMON_REQUIRE="1",
                PANDEPTH_DAEMON_SOCK=os.path.join(sock_dir, "h.sock"),
                PANDEPTH_DAEMON_IDLE_S="120", PANDEPTH_HOST_FINALIZE="1")
    pid, walls = None, []
    try:
        for k in range(2):
            out = os.path.join(tmp, f"hostdaemon{k}")
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                                "-i", bam, "-o", out], cwd=ROOT, env=denv,
                               capture_output=True, text=True, timeout=600)
            walls.append(time.perf_counter() - t0)
            if r.returncode != 0:
                fail("host", f"daemon request {k} exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
            if [gz_digest(f"{out}.chr.stat.gz")] != want["chr"]:
                fail("host", f"daemon request {k}: the chr table differs")
        with env(PANDEPTH_DAEMON_SOCK=denv["PANDEPTH_DAEMON_SOCK"]):
            st = serve.daemon_stat()
        pid = st.get("pid")
        if "launches" in st:
            fail("host", f"the daemon ran a device engine: {st}")
    finally:
        subprocess.run([sys.executable, "-m", "pandepth_tpu_torch",
                        "--daemon-stop"], cwd=ROOT, env=denv, timeout=120)
        if pid is not None:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    os.kill(pid, 0)
                except OSError:
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)
        shutil.rmtree(sock_dir, ignore_errors=True)
    say("host", f"chr through the daemon with PANDEPTH_HOST_FINALIZE=1: "
                f"client process walls {walls[0]:.3f} s (spawns it), "
                f"{walls[1]:.3f} s (warm); the daemon's peak RSS "
                f"{st.get('rss_mb')} MiB, no kernel module loaded; tables "
                f"byte-equal; stopped")
    say("host", "no host process imported torch: this phase launched no "
                "kernel")


def main() -> int:
    if sys.argv[1:2] == ["worker"]:
        return worker(sys.argv[2:])
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
        bam, bed, lst, paf, uns, site, deep, spliced = setup(tmp)
        say("setup", f"{bam} ({os.path.getsize(bam)} bytes), {bed}, {lst}, "
                     f"{paf} ({os.path.getsize(paf)} bytes), {uns} "
                     f"({os.path.getsize(uns)} bytes), {site} "
                     f"({os.path.getsize(site)} bytes), {deep} "
                     f"({os.path.getsize(deep)} bytes) "
                     f"{time.perf_counter() - t0:.1f} s")

        # 4. kernels against their twins
        check = KernelCheck()
        sort_edge_cases(check, dev)
        sweep_edge_cases(check, dev)
        search_edge_cases(check, dev)
        extract_edge_cases(check, dev)
        enc_edge_cases(check, dev)
        shard_edge_cases(check, dev)
        carry_edge_cases(check, dev)
        many_rows_case(check, dev)
        bucket_edge_cases(check, dev)
        states, h2d = main_path_states(check, bam, bed, lst, uns, dev)
        states.update(sharded_states(check, bam, bed, dev))
        t0 = time.perf_counter()
        fb = FirstBatch(bam, dev)
        say("kernels", f"the fixture's {len(fb.batch_s)} batches through the "
                       f"Python decoder alone (no device) "
                       f"{time.perf_counter() - t0:.3f} s: the first "
                       f"(whole-file inflate and its decode) "
                       f"{fb.batch_s[0]:.3f} s, the other "
                       f"{len(fb.batch_s) - 1} {sum(fb.batch_s[1:]):.3f} s")
        main_path_cigar(check, fb, dev)
        check.round_notes(load_latency_note(check, dev))
        torch.cuda.synchronize()
        shapes = {k: states["chr"] for k in ("pack_events", "sort_pairs",
                                             "sweep_scan", "eval_pair")}
        shapes["extract_events"] = (f"first batch ({fb.n} reads, {fb.m} "
                                    f"ops, {fb.tier} tier)")
        shapes["eval_boundaries"] = (f"first batch's {2 * fb.m} int64 "
                                     f"events, {2 * fb.lo.shape[0]} bounds")
        shapes["decode_enc"] = states["chr_enc"]
        shapes["shard_carry"] = shapes["eval_pair_rows"] = \
            states["chr_sharded"]
        shapes["bucket_events"] = states.pop("bucket_events")
        for k in REPLACES:
            say("kernels", f"{k}: {check.cases[k]} cases array-equal to "
                           f"the twin; {shapes[k]} {check.ms[k]:.4f} ms, "
                           f"twin {check.plain_ms[k]:.4f} ms, bound "
                           f"{check.bound_ms[k]:.6f} ms"
                           + (f", library {check.library_ms[k]:.4f} ms"
                              if k in check.library_ms else ""))
        say("kernels", f"also array-equal at {states['bed']}, "
                       f"{states['cigar']}, {states['list']}, "
                       f"{states['unsorted']} and {states['bed_sharded']}")
        for path, (nbytes, n_copies, secs) in h2d.items():
            say("kernels", f"host->device copies of the {path} feed: "
                           f"{nbytes} bytes in {n_copies} copies, "
                           f"{secs * 1e3:.3f} ms (host clock)")
        for note in check.notes:
            say("kernels", note)

        # 5. golden
        n_gold = golden(port_main, tmp, dev)
        say("golden", f"{n_gold} tables byte-equal to tests/golden/ (chr, "
                      f"bed, gene, gene_gc and win (-w 100) from the BAM: "
                      f"encoded windows, raw pairs and no-native; chr from "
                      f"SAM both ways and CRAM)")

        # 6. the real-size main paths, each counted on its own; from here
        # to the graft phase no library sort may meet a CUDA tensor
        # outside a plain twin
        guard = LibrarySortGuard()
        guard.start()

        def cli(out, *extra, inp=bam, device=dev):
            rc = port_main(["pandepth", "-i", inp, "-o",
                            os.path.join(tmp, out), *extra], device=device)
            if rc != 0:
                fail("e2e", f"the port's CLI ({out}) exited {rc}")

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def peak_mb(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            return out, (torch.cuda.max_memory_allocated() - base) / 2**20

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

        # -w 1500: 2M windows, more than one chunk of queries, so the
        # engine finalizes its kept state and evaluates them chunk by chunk
        # on the card, fetching no state
        from pandepth_tpu_torch.device.engine import CoverageEngine

        with engines_made() as made, \
                method_clock(CoverageEngine, "segment_stats") as k3:
            _, paths["win"], wall = counted(
                kernels, "win",
                lambda: cli("winport", "-w", str(WIN_BP), "-v"))
        fetches = made.made[0].state_fetches
        del made
        host_wall = host_sweep(["-i", bam, "-w", str(WIN_BP)],
                               os.path.join(tmp, "winhost"))
        win_tab = table(os.path.join(tmp, "winport"), "win")
        n_windows = sum(not ln.startswith(b"#")   # header, summary
                        for ln in win_tab.splitlines())
        if n_windows <= QUERY_CHUNK or fetches != 0 or \
                paths["win"]["eval_pair"] < 1 + -(-n_windows // QUERY_CHUNK):
            fail("e2e", f"win: {n_windows} windows in "
                        f"{paths['win']['eval_pair']} eval_pair launches "
                        f"and {fetches} state fetches, not the chunked "
                        f"path")
        if win_tab != table(os.path.join(tmp, "winhost"), "win"):
            fail("e2e", "win: table differs from the host sweep's")
        say("e2e", f"win (-w {WIN_BP}, {n_windows} windows): {wall:.3f} s "
                   f"in this process, of it K3's chunked eval "
                   f"(segment_stats, copies included) {sum(k3.seconds):.3f} "
                   f"s in {len(k3.seconds)} calls; no state fetch; launches "
                   f"{paths['win']}; table byte-equal to the host sweep's "
                   f"(host sweep CLI process {host_wall:.3f} s)")

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

        # the sharded engine: 8 rows on the card for chr and -b, then the
        # CLI as a user calls it (every visible card) with
        # PANDEPTH_SHARDED=1
        shard_devs = [dev] * SHARD_ROWS
        for path, out, extra, want in (
                ("chr_sharded", "shard", [], port_tab),
                ("bed_sharded", "bedshard", ["-b", bed], bed_tab),
                ("cli_sharded", "clishard", [], port_tab)):
            devs = None if path == "cli_sharded" else shard_devs
            with env(PANDEPTH_SHARDED=None if devs else "1"), \
                    bucket_clock() as clock:
                (_, paths[path], wall), peak = peak_mb(lambda: counted(
                    kernels, path, lambda: cli(out, "-v", *extra,
                                               device=devs)))
            tab = "bed" if extra else "chr"
            if table(os.path.join(tmp, out), tab) != want:
                fail("e2e", f"{path}: table differs from the single-device "
                            f"run's")
            rows = SHARD_ROWS if devs else torch.cuda.device_count()
            say("e2e", f"{path} ({rows} rows): {wall:.3f} s in this "
                       f"process, host bucketing {clock.seconds} s; peak "
                       f"device memory {peak:.1f} MiB above the smoke's own "
                       f"tensors; launches {paths[path]}; {tab} table "
                       f"byte-equal to the single-device run's and the host "
                       f"sweep's")

        # the multi-process engine: the .list on 2 gloo ranks sharing the
        # card (rank 0 decodes files 0 and 2, rank 1 file 1), then the chr
        # fixture on 1 NCCL rank; each rank a worker process
        for path, world, backend, inp, want in (
                ("multiproc", 2, "gloo", lst, list_tab),
                ("multiproc_nccl", 1, "nccl", bam, port_tab)):
            out = os.path.join(tmp, path)
            ranks, stats, paths[path], wall = spawned(
                path, "cli", world, backend,
                ["-i", inp, "-o", out + "_r{rank}", "-v"], tmp)
            if table(f"{out}_r0") != want:
                fail("e2e", f"{path}: rank 0's table differs from the "
                            f"single-process run's")
            if any(os.path.exists(f"{out}_r{r}.chr.stat.gz")
                   for r in range(1, world)):
                fail("e2e", f"{path}: a rank other than 0 wrote a table")
            say("e2e", f"{path} ({world} {backend} rank(s) on cuda:0): job "
                       f"{wall:.3f} s; {rank_lines(ranks, stats)}; launches "
                       f"{paths[path]}; rank 0's chr table byte-equal to the "
                       f"single-process run's and the host sweep's")

        # sharded_coverage_step on the first batch, its reads split over 2
        # gloo ranks sharing the card, against coverage_step's sums
        import numpy as np

        from pandepth_tpu_torch.device.layout import GenomeLayout

        host = [c.cpu().numpy() for c in fb.cols]
        half = fb.n // 2
        parts = {}
        for r, rows in enumerate((slice(0, half), slice(half, fb.n))):
            ops = (host[6] >= rows.start) & (host[6] < rows.stop)
            parts.update({f"{c}{r}": a[rows] for c, a in
                          zip(COLS[:4], host[:4])})
            parts.update({f"{c}{r}": a[ops] for c, a in
                          zip(COLS[4:6], host[4:6])})
            parts[f"op_read{r}"] = host[6][ops] - rows.start
        step_in = os.path.join(tmp, "mesh_step.npz")
        np.savez(step_in, offsets=fb.offsets.cpu().numpy(),
                 limits=fb.limits.cpu().numpy(),
                 bounds=GenomeLayout(fb.lengths).shard_bounds(2),
                 lo=fb.lo.cpu().numpy(), hi=fb.hi.cpu().numpy(),
                 flags_mask=fb.flags_mask, min_mapq=fb.min_mapq, **parts)
        ranks, stats, paths["mesh_step"], wall = spawned(
            "mesh_step", "step", 2, "gloo", [step_in], tmp)
        for r in range(2):
            got = np.load(f"{step_in}.out{r}.npz")
            if not (np.array_equal(got["cover"], cov.numpy())
                    and np.array_equal(got["dsum"], dsum.numpy())):
                fail("e2e", f"mesh_step: rank {r}'s sums differ from "
                            f"coverage_step's")
        say("e2e", f"mesh_step (the first batch's {fb.n} reads over 2 gloo "
                   f"ranks on cuda:0): job {wall:.3f} s; "
                   f"{rank_lines(ranks, stats)}; launches "
                   f"{paths['mesh_step']}; both ranks' (cover, dsum) equal "
                   f"to coverage_step's")

        # 7. profile: the cigar, bed and both chr runs once more, traced
        with no_native():
            prof = {"cigar": profiled(lambda: cli("cigarprof"))}
        with raw_pairs():
            prof["bed"] = profiled(lambda: cli("bedprof", "-b", bed))
            prof["chr"] = profiled(lambda: cli("chrprof"))
        prof["chr_enc"] = profiled(lambda: cli("encprof"))
        prof["win"] = profiled(lambda: cli("winprof", "-w", str(WIN_BP)))
        prof["chr_sharded"] = profiled(lambda: cli("shardprof",
                                                   device=shard_devs))
        if any(table(os.path.join(tmp, f"{p}prof")) != port_tab
               for p in ("cigar", "chr", "enc", "shard")) or \
                table(os.path.join(tmp, "bedprof"), "bed") != bed_tab or \
                table(os.path.join(tmp, "winprof"), "win") != win_tab:
            fail("profile", "a profiled run's table differs from phase 6's")
        for path, (pwall, dev_ms, h2d_ms, ops, peak) in prof.items():
            top = "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in ops)
            say("profile", f"{path}: wall {pwall:.3f} s, device time "
                           f"{dev_ms:.3f} ms (busy "
                           f"{100 * dev_ms / 1e3 / pwall:.4f}%), host->device "
                           f"copies {h2d_ms:.3f} ms, peak device memory "
                           f"{peak} bytes; largest: {top}")

        # PANDEPTH_PROFILE: the run's own trace, with the port's kernels
        trace_dir = os.path.join(tmp, "trace")
        with env(PANDEPTH_PROFILE=trace_dir):
            cli("envprof")
        traces = os.listdir(trace_dir)
        if len(traces) != 1:
            fail("profile", f"PANDEPTH_PROFILE wrote {traces}")
        with open(os.path.join(trace_dir, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        names = sorted({e["name"] for e in events
                        if e.get("cat") == "kernel"})
        if not all(any(k in n for n in names)
                   for k in ("sweep_scan", "sort_pass")) or \
                table(os.path.join(tmp, "envprof")) != port_tab:
            fail("profile", f"PANDEPTH_PROFILE's trace holds no sweep_scan "
                            f"or sort_pass kernel (kernels: {names}), or "
                            f"its table differs")
        say("profile", f"PANDEPTH_PROFILE: one chr run's trace "
                       f"{os.path.getsize(os.path.join(trace_dir, traces[0]))}"
                       f" bytes, {len(events)} events, kernels "
                       f"{', '.join(n[:40] for n in names)}")

        # 8. site: -a on the 12 Mb genome at 30x, against the host sweep
        paths.update(site_phase(port_main, kernels, site, tmp, dev))

        # 9. win6: -w 100 on the 3 Gb fixture, ~30M windows
        paths["win6"] = win6_phase(port_main, kernels, bam, tmp, dev)

        # 10. daemon: three chr runs through the resident daemon
        paths["daemon"] = daemon_phase(bam, tmp, port_tab)

        # 11. wrap18: the 18-bit depth cells on a pileup past 2^18
        paths.update(wrap18_phase(port_main, kernels, deep, tmp, dev))

        # 12. boot: fresh processes, start-up overlapped and serial
        boot = boot_phase(bam, tmp, port_tab)

        # 13. graft: the twin of __graft_entry__.py
        paths["graft"] = graft_phase(kernels)
        sorts = guard.stop()
        if sorts:
            fail("e2e", f"{len(sorts)} library sorts of CUDA tensors "
                        f"outside a twin in phases 6-13: {sorts[:5]}")
        say("e2e", "phases 6-13: no library sort met a CUDA tensor outside "
                   "a plain twin")

        # 14. host: the host engine's fresh processes, fold, split, daemon
        host_phase({"bam": bam, "bed": bed, "lst": lst, "paf": paf,
                    "site": site, "spliced": spliced}, tmp, boot)

    if "jax" in sys.modules:
        fail("imports", "jax was imported")
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)   # again, beside the results
    # no single PyTorch call computes the other kernels' functions;
    # bucket_events' is the library's stable sort of the destinations,
    # which computes the order alone; sort_pairs' the library's stable
    # sort and the gather of the deltas
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k],
         "launches": sum(p[k] for p in paths.values()),
         "max_abs_err": check.err[k], "ms": check.ms[k],
         "plain_ms": check.plain_ms[k], "bound_ms": check.bound_ms[k],
         "bound_by": "bytes", "library_ms": check.library_ms.get(k)}
        for k in REPLACES]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
