#!/usr/bin/env python3
"""Time the port's redesigned kernels (K2 ``sweep_scan``, K8
``decode_enc``, K6 ``extract_events``, K10 ``bucket_events``, K3
``eval_pair``, K5 ``eval_boundaries``, K9's ``eval_pair_rows`` and
``shard_carry``) at the main paths' shapes, on one NVIDIA GPU, for the
``pandepth_tpu_torch`` of a given checkout:

    python3 tools/kernel_ab.py [--root DIR] [--iters N] [--out FILE]
                               [--only NAME,...]

``--root`` is the directory that holds the package (default: this
repository), so two commits compare in one process each, on one card:
unpack the other commit into a directory that ``.gitignore`` lists and
run both in turns (A, B, B, A). The timing is ``chip_smoke.py``'s own
(``cuda_ms``: CUDA events around ``--iters`` calls after a warm-up;
``device_ms``: the same calls' device time under torch.profiler, which
leaves out the host's gaps between launches, with the kernels and
memsets a call puts on the card), taken from this repository's
``chip_smoke.py`` whatever the root; beside them each device op's own
time and count per call, by name, and the host's time per call
(``host_ms``: a host clock around 100 calls with no synchronisation,
what the wrapper costs the host). The inputs are made from fixed seeds,
the same for every root:

- sweep_scan: 15,199,506 sorted uint32-tier events (the chr fixture's
  count; int64 words, positions below 3e9, deltas of +-1), min_dep 1, no
  wrap18;
- decode_enc: the encoded chr path's const u16 group, blocks of 8 and 6
  windows of 2^19 slots with 8,192 escape entries each (three used),
  through ``sweep.decode_const_group`` as ``chip_smoke.py`` times it;
- extract_events: 2^20 reads of ``synth.make_batch`` on ``synth.GENOME``
  (uint32 tier, int64 output, -x 1796, -Q 0) as two batches: one op of
  150M per read (the CIGAR feed's shape on the fixture; seed 1, the
  reads drawn with no ops) and the seeded multi-op batch (seed 9, 0-8
  ops per read, every op code);
- bucket_events: 15,199,506 uint32-tier events (7,599,753 sorted 150 bp
  reads' starts, then their ends, on the genome's layout) over 2 and 8
  ranges (``layout.shard_bounds``);
- eval_pair on the sweep state of those events (``sweep_scan``, min_dep
  1) at the chr path's 300 segments (25 of 10 Mb a contig:
  ``eval_pair_chr``) and at one 1M-window chunk of a ``-w 150`` grid
  (contig 0's first 150 Mb: ``eval_pair_win``) and of a ``-w 1500``
  grid (the axis' first 1.5 Gb: ``eval_pair_win1500``), and on the state
  of 188,756 sorted 150 bp reads (377,512 events) at 200,000 sorted
  exome-sized regions of 150-300 bp (``eval_pair_bed``); beside each,
  ``torch.searchsorted`` of the same 2B boundaries (the search alone, a
  yardstick);
- eval_boundaries at the 600 boundaries of the 300 chr segments (lo,
  then hi) over the int64 sweep state of extract_events' one-op batch
  with JAX's sentinel (``sweep.sort_events``: 2,097,152 events,
  ``eval_boundaries_step``), over the 15,199,506-event state
  (``eval_boundaries_chr``), and at the 400,000 boundaries of the 200,000
  regions over the 377,512-event state (``eval_boundaries_bed``); beside
  each, ``torch.searchsorted`` of the same boundaries; and on the step
  shape the step path's two calls (lo, then hi) beside one call on
  ``torch.cat([lo, hi])`` (``eval_boundaries_step_split`` and
  ``eval_boundaries_step_cat``);
- eval_pair_rows on the 8-row block of those 15,199,506 events (rows of
  ``layout.shard_bounds(8)``, 2^21 + 1 slots, slot 0 the row's carry,
  sentinel padding, K2 per row) at the 300 chr segments;
- shard_carry on the same 8-row block before its sort (``shard_carry_8``,
  no rows to its left), on its last 4 rows as the second of two 4-row
  blocks with the first block's totals as ``left``
  (``shard_carry_4_of_8``), and on one row of 1 + 15,199,506 slots
  (``shard_carry_1``); beside each, ``delta2d[:, 1:].sum(1,
  dtype=torch.int64)``, the reduction alone.

Yardsticks (``torch.searchsorted``, ``torch.sum``) are timed by CUDA
events and by the profiler; they are not library times (no one PyTorch
call computes these kernels' functions).

Each kernel is first held array-equal to its plain twin (shard_carry
with slot 0 of every row overwritten before the call, so a slot it does
not write shows). ``--only`` keeps the kernels of those names
(``eval_pair`` takes its four shapes, ``eval_boundaries`` its five,
``shard_carry`` its three). Prints one JSON line, and appends it to the file ``--out``
names, if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (bucket_defined, cuda_ms, device_ms,  # noqa: E402
                        host_ms)

sys.path.remove(HERE)

N_EVENTS = 15_199_506
CAP, CE, ROWS = 1 << 19, 8192, (8, 6)
U32_MAX = 0xFFFFFFFF
N_READS = 1 << 20


def sweep_inputs(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    pos = torch.randint(0, 3_000_000_000, (N_EVENTS,), generator=g,
                        device=dev, dtype=torch.int64)
    pos_s = torch.sort(pos)[0]
    delta = (torch.randint(0, 2, (N_EVENTS,), generator=g, device=dev,
                           dtype=torch.int32) * 2 - 1)
    return pos_s, delta


def decode_group(dev):
    """(codes, excs, slots, bases, lens, ns) of the const u16 group, on
    the card: random codes below the escape, three escapes a row."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    codes, excs, slots = [], [], []
    for rows in ROWS:
        c = torch.randint(0, 300, (rows, CAP), generator=g, device=dev,
                          dtype=torch.int32)
        s = torch.full((rows, CE), CAP, dtype=torch.int32, device=dev)
        s[:, :3] = torch.tensor([5, CAP // 2, CAP - 1], dtype=torch.int32)
        c.scatter_(1, s[:, :3].long(), 0xFFFF)
        e = torch.zeros((rows, CE), dtype=torch.int64, device=dev)
        e[:, :3] = torch.tensor([40_000_000, -3_000, 90_000])
        codes.append(c.to(torch.int16))   # uint16 bits
        excs.append(e)
        slots.append(s)
    n = sum(ROWS)
    bases = torch.randint(0, 2_900_000_000, (n,), generator=g, device=dev,
                          dtype=torch.int64)
    lens = torch.full((n,), 150, dtype=torch.int32, device=dev)
    ns = torch.full((n,), CAP, dtype=torch.int32, device=dev)
    ns[-1] = CAP // 3
    return tuple(codes), tuple(excs), tuple(slots), bases, lens, ns


def genome_layout():
    import numpy as np

    from pandepth_tpu_torch import synth
    from pandepth_tpu_torch.device.layout import GenomeLayout

    return GenomeLayout(np.array([g[1] for g in synth.GENOME], np.int64))


def extract_inputs(dev, multi: bool):
    """The seven int32 columns of a 2^20-read batch and the layout's
    offsets and limits, on the card."""
    import numpy as np
    import torch

    from pandepth_tpu_torch import synth

    lay = genome_layout()
    if multi:
        b = synth.make_batch(lay.lengths, N_READS, seed=9)
        ops = (b.op_code, b.op_len, b.op_read)
    else:
        b = synth.make_batch(lay.lengths, N_READS, seed=1, max_ops=0)
        ops = (np.zeros(N_READS, np.int32), np.full(N_READS, 150, np.int32),
               np.arange(N_READS, dtype=np.int32))
    cols = (b.tid, b.pos, b.flag, b.mapq) + ops
    return ([torch.from_numpy(np.ascontiguousarray(c, np.int32)).to(dev)
             for c in cols],
            torch.from_numpy(lay.offsets).to(dev),
            torch.from_numpy(lay.limits).to(dev))


def bucket_inputs(dev):
    """15,199,506 uint32-tier events as int32 words: sorted reads' starts,
    then their ends."""
    import torch

    lay = genome_layout()
    g = torch.Generator(device=dev).manual_seed(3)
    starts = torch.sort(torch.randint(0, int(lay.total) - 200,
                                      (N_EVENTS // 2,), generator=g,
                                      device=dev, dtype=torch.int64))[0]
    pos = torch.cat([starts, starts + 150])
    delta = torch.ones(N_EVENTS // 2, dtype=torch.int32, device=dev)
    words = torch.where(pos >= 1 << 31, pos - (1 << 32), pos).to(torch.int32)
    return lay, words, torch.cat([delta, -delta])


def eval_state(dev, n_reads: int, seed: int):
    """The layout, the sweep state (pos_s, depth, c_cov, c_sum) of
    ``n_reads`` sorted 150 bp reads on the genome's layout (their starts
    and ends) and the sorted deltas."""
    import torch

    from pandepth_tpu_torch.device import kernels

    lay = genome_layout()
    g = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.sort(torch.randint(0, int(lay.total) - 200, (n_reads,),
                                      generator=g, device=dev,
                                      dtype=torch.int64))[0]
    one = torch.ones(n_reads, dtype=torch.int32, device=dev)
    pos_s, order = torch.sort(torch.cat([starts, starts + 150]), stable=True)
    delta_s = torch.cat([one, -one])[order]
    return (lay, (pos_s, *kernels.sweep_scan(pos_s, delta_s, 1, False,
                                             U32_MAX)), delta_s)


def chr_segments(lay, dev):
    """(lo, hi) int64 of 25 segments of 10 Mb a contig."""
    import numpy as np
    import torch

    k = np.arange(25, dtype=np.int64) * 10_000_000
    lo = (lay.offsets[:, None] + k[None, :]).ravel()
    hi = np.minimum(lo + 10_000_000, np.repeat(lay.offsets + lay.lengths, 25))
    return (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))


def bed_inputs(dev):
    """The state of 188,756 sorted reads and 200,000 sorted regions of
    150-300 bp over the genome."""
    import torch

    lay, st, _ = eval_state(dev, 188_756, 5)
    g = torch.Generator(device=dev).manual_seed(6)
    lo = torch.sort(torch.randint(0, int(lay.total) - 400, (200_000,),
                                  generator=g, device=dev,
                                  dtype=torch.int64))[0]
    hi = lo + torch.randint(150, 301, (200_000,), generator=g, device=dev,
                            dtype=torch.int64)
    return st, lo, hi


def carry_block(lay, pos_s, delta_s, rows: int = 8,
                width: int = (1 << 21) + 1):
    """The sharded engine's (rows, width) event block of the sorted
    events, as ``shard_carry`` takes it: row r holds slot 0 = (bounds[r],
    the depth carried in) and then its range's events, sentinel padding
    after them. Returns (pos2d, delta2d, bounds, events per row)."""
    import numpy as np
    import torch

    dev = pos_s.device
    bounds = torch.from_numpy(lay.shard_bounds(rows)).to(dev)
    cut = torch.searchsorted(pos_s, bounds).cpu().numpy()
    cum = torch.cumsum(delta_s.to(torch.int64), 0)
    p2 = torch.full((rows, width), U32_MAX, dtype=torch.int64, device=dev)
    d2 = torch.zeros((rows, width), dtype=torch.int32, device=dev)
    for r in range(rows):
        a, z = int(cut[r]), int(cut[r + 1])
        if z - a + 1 > width:
            raise ValueError(f"row {r} holds {z - a} events")
        p2[r, 0] = bounds[r]
        d2[r, 0] = cum[a - 1] if a else 0
        p2[r, 1:1 + z - a] = pos_s[a:z]
        d2[r, 1:1 + z - a] = delta_s[a:z]
    return p2, d2, bounds, np.diff(cut)


def row_block(lay, pos_s, delta_s, rows: int = 8, width: int = (1 << 21) + 1):
    """:func:`carry_block`'s rows with each row's K2: ((pos2d, depth2,
    c_cov2, c_sum2), bounds, events per row)."""
    import torch

    from pandepth_tpu_torch.device import kernels

    p2, d2, bounds, per_row = carry_block(lay, pos_s, delta_s, rows, width)
    dev = pos_s.device
    dep = torch.empty_like(d2)
    c_cov = torch.empty(p2.shape, dtype=torch.int64, device=dev)
    c_sum = torch.empty_like(c_cov)
    for r in range(rows):
        kernels.sweep_scan(p2[r], d2[r], 1, False, U32_MAX,
                           out=(dep[r], c_cov[r], c_sum[r]))
    return (p2, dep, c_cov, c_sum), bounds, per_row


def step_state(dev):
    """The int64 sweep state (pos_s, depth, c_cov, c_sum) of the CIGAR
    feed's one-op 2^20-read batch, as ``coverage_step`` builds it:
    extract_events with JAX's sentinel and int64 output, then
    ``sweep.sort_events``."""
    import torch

    from pandepth_tpu_torch.device import kernels, sweep

    cols, offsets, limits = extract_inputs(dev, False)
    ev = kernels.extract_events(*cols, offsets, limits, 1796, 0, 1 << 62,
                                torch.int64)
    return sweep.sort_events(*ev)[:4]


def yardstick(fn, iters: int) -> dict:
    """A library call's time by CUDA events and by the profiler."""
    return {"ms": cuda_ms(fn, iters), "device_ms": device_ms(fn, iters)[0]}


def device_ops(fn, iters: int) -> dict:
    """Each device op's own time and count per call, by name, under
    torch.profiler after a warm-up call."""
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
    return {e.key[:80]: {"ms": e.self_device_time_total / 1e3 / iters,
                         "count": e.count / iters}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"}


def timed(fn, want, iters: int, prefix=None, view=None) -> dict:
    """``fn``'s outputs against the twin's ``want`` (each cut by
    ``prefix`` to what is compared, if given; ``fn``'s alone seen through
    ``view``, if given), then its times."""
    got = fn()
    if prefix is not None:
        got, want = prefix(got), prefix(want)
    if view is not None:
        got = view(got)
    same = all(a.equal(b) for a, b in zip(got, want))
    ms = cuda_ms(fn, iters)
    dms, nk, nm = device_ms(fn, iters)
    return {"equal_to_twin": same, "ms": ms, "device_ms": dms,
            "kernels_per_call": nk, "memsets_per_call": nm,
            "host_ms": host_ms(fn), "ops": device_ops(fn, iters)}


def boundaries_entry(kernels, sweep, state, x, iters: int) -> dict:
    """eval_boundaries at ``x`` on ``state`` against its twin, its times,
    and torch.searchsorted of the same boundaries."""
    import torch

    return {"events": int(state[0].numel()), "boundaries": x.numel(),
            "searchsorted": yardstick(
                lambda: torch.searchsorted(state[0], x), iters),
            **timed(lambda: kernels.eval_boundaries(*state, 1, x),
                    sweep.eval_boundaries_reference(*state, 1, x), iters)}


def carry_entry(kernels, steps, p2, d2, bounds, left, iters: int) -> dict:
    """shard_carry on a (rows, width) block against its twin (the totals
    and slot 0 of every row; slot 0 overwritten before the kernel's
    call), its times, and the sum of each row's deltas past slot 0."""
    import torch

    rp, rd = p2.clone(), d2.clone()
    want = steps.shard_carry_reference(rp, rd, bounds, left)
    p2[:, 0] = -5
    d2[:, 0] = 77
    return {"sum": yardstick(lambda: d2[:, 1:].sum(1, dtype=torch.int64),
                             iters),
            **timed(lambda: kernels.shard_carry(p2, d2, bounds, left),
                    (want, rp[:, 0], rd[:, 0]), iters,
                    view=lambda t: (t, p2[:, 0], d2[:, 0]))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="a JSON-lines file to append the result to")
    ap.add_argument("--only", help="comma-separated kernel names to time")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    def wanted(name: str) -> bool:
        return only is None or name in only
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from pandepth_tpu_torch.device import events, kernels, sweep
    from pandepth_tpu_torch.sharding import mesh

    if not kernels.SOURCE.is_relative_to(root):
        print(f"kernel_ab: imported {kernels.SOURCE}, not from {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    kernels.library()
    out = {"root": root, "card": card, "iters": args.iters}

    if wanted("sweep_scan"):
        pos_s, delta = sweep_inputs(dev)
        want = sweep.sweep_scan_reference(pos_s, delta, 1, False, U32_MAX)
        out["sweep_scan"] = {"events": N_EVENTS, **timed(
            lambda: kernels.sweep_scan(pos_s, delta, 1, False, U32_MAX),
            want, args.iters)}
        del pos_s, delta, want

    if wanted("decode_enc"):
        grp = decode_group(dev)
        want = sweep.decode_const_group_reference(*grp, pos_max=U32_MAX)
        out["decode_enc"] = {"windows": sum(ROWS), "blocks": len(ROWS),
                             **timed(lambda: sweep.decode_const_group(
                                 *grp, pos_max=U32_MAX), want, args.iters)}
        del grp, want

    for name, multi in (("extract_events", False),
                        ("extract_events_multi_op", True)):
        if not wanted("extract_events"):
            break
        cols, offsets, limits = extract_inputs(dev, multi)
        xargs = (*cols, offsets, limits, 1796, 0, U32_MAX, torch.int64)
        want = events.extract_events_reference(*xargs)
        out[name] = {"reads": N_READS, "cigar_ops": int(cols[4].numel()),
                     **timed(lambda: kernels.extract_events(*xargs), want,
                             args.iters)}
        del cols, xargs, want

    lay, words, dl = bucket_inputs(dev)
    for world in (2, 8) if wanted("bucket_events") else ():
        bounds = torch.from_numpy(lay.shard_bounds(world)).to(dev)
        want = mesh.bucket_events_reference(words, dl, bounds,
                                            kernels.TIER_U32)
        out[f"bucket_events_{world}"] = {"events": N_EVENTS, **timed(
            lambda: kernels.bucket_events(words, dl, bounds,
                                          kernels.TIER_U32),
            want, args.iters, bucket_defined)}
    del words, dl

    from pandepth_tpu_torch.sharding import steps

    lay, st, delta_s = eval_state(dev, N_EVENTS // 2, 3)
    lo, hi = chr_segments(lay, dev)
    win_lo = int(lay.offsets[0]) + 150 * torch.arange(
        1 << 20, dtype=torch.int64, device=dev)
    bed_st, bed_lo, bed_hi = bed_inputs(dev)
    for name, state, a, z in (("eval_pair_chr", st, lo, hi),
                              ("eval_pair_bed", bed_st, bed_lo, bed_hi),
                              ("eval_pair_win", st, win_lo, win_lo + 150),
                              ("eval_pair_win1500", st, 10 * win_lo,
                               10 * win_lo + 1500)):
        if not wanted("eval_pair"):
            break
        want = sweep.eval_pair_reference(*state, 1, a, z)
        x = torch.cat([a, z])
        out[name] = {"events": int(state[0].numel()), "segments": a.numel(),
                     "searchsorted_ms": cuda_ms(
                         lambda: torch.searchsorted(state[0], x), args.iters),
                     **timed(lambda: kernels.eval_pair(*state, 1, a, z), want,
                             args.iters)}
    for name, state, x in (("eval_boundaries_chr", st, torch.cat([lo, hi])),
                           ("eval_boundaries_bed", bed_st,
                            torch.cat([bed_lo, bed_hi]))):
        if not wanted("eval_boundaries"):
            break
        out[name] = boundaries_entry(kernels, sweep, state, x, args.iters)
    if wanted("eval_boundaries"):
        step = step_state(dev)
        x = torch.cat([lo, hi])
        out["eval_boundaries_step"] = boundaries_entry(kernels, sweep, step,
                                                       x, args.iters)
        want = (*sweep.eval_boundaries_reference(*step, 1, lo),
                *sweep.eval_boundaries_reference(*step, 1, hi))
        out["eval_boundaries_step_split"] = {
            "calls": 2, **timed(lambda: (*kernels.eval_boundaries(*step, 1,
                                                                 lo),
                                         *kernels.eval_boundaries(*step, 1,
                                                                  hi)),
                                want, args.iters)}
        out["eval_boundaries_step_cat"] = {
            "calls": 1, **timed(lambda: kernels.eval_boundaries(
                *step, 1, torch.cat([lo, hi])),
                sweep.eval_boundaries_reference(*step, 1, x), args.iters)}
        del step
    del bed_st, win_lo
    if wanted("shard_carry"):
        p2, d2, bounds, _ = carry_block(lay, st[0], delta_s)
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        n = st[0].numel()
        p1 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        st[0]])[None]
        d1 = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        delta_s])[None]
        b1 = torch.tensor([0, int(lay.total)], dtype=torch.int64, device=dev)
        first = steps.shard_carry_reference(p2[:4].clone(), d2[:4].clone(),
                                            bounds[:5], none)
        for name, blk in (("shard_carry_8", (p2, d2, bounds, none)),
                          ("shard_carry_4_of_8", (p2[4:], d2[4:], bounds[4:],
                                                  first)),
                          ("shard_carry_1", (p1, d1, b1, none))):
            out[name] = carry_entry(kernels, steps, *blk, args.iters)
            out[name]["rows"], out[name]["width"] = blk[0].shape
        out["shard_carry_1"]["events"] = n
        del p1, d1, p2, d2
    state2, bounds, per_row = row_block(lay, st[0], delta_s)
    del st, delta_s
    if wanted("eval_pair_rows"):
        want = steps.eval_pair_rows_reference(*state2, bounds, 1, lo, hi)
        out["eval_pair_rows"] = {
            "rows": int(bounds.numel() - 1),
            "width": int(state2[0].shape[1]),
            "events_per_row": per_row.tolist(), "segments": lo.numel(),
            **timed(lambda: kernels.eval_pair_rows(*state2, bounds, 1, lo,
                                                   hi), want, args.iters)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0 if all(v["equal_to_twin"] for v in out.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
