"""Seeded synthetic inputs, numpy only: read batches for the CIGAR
extraction (``extract_events``) and encoded event windows for their
decode (``decode_enc``), which the port's tests and ``chip_smoke.py``
hold the kernels to; and the input files ``chip_smoke.py`` runs, written
with the port's own writers (``io/bam_writer.py``, ``io/cram_writer.py``)
with the same seeds, draws and file names as the repo's generators:

- the golden fixtures of ``tests/fixtures.py`` (``make_bam``,
  ``make_bed``, ``make_gff``, ``make_fasta``, their SAM and CRAM copies);
- ``bench.py``'s 8M-read 3 Gb-shape BAM (:func:`bench_bam`, its
  ``ensure_fixture``), an exome-sized BED over it (:func:`exome_bed`),
  ``bench3gb.py``'s ``.list`` samples (:func:`list_sample_bam`, its
  ``_gen_list_extra_fixture``) and PAF (:func:`paf_file`, its
  ``_write_paf_fixture``), and bench.py's reads unsorted
  (:func:`unsorted_bam`);
- an indexed BAM deeper than 2^18 at one base (:func:`deep_bam`), where
  the reference's 18-bit depth cells wrap;
- a BAM of random bases and qualities (:func:`literal_bam`), whose BGZF
  blocks are mostly literals.
"""

from __future__ import annotations

import os
import random
import struct
from typing import List, Optional, Tuple

import numpy as np

from pandepth_tpu_torch.device.hosteval import pad_pow2
from pandepth_tpu_torch.io.bam import ReadBatch
from pandepth_tpu_torch.io.bam_writer import (_BlockTrackingBgzf,
                                              cigar_str_to_ops, ref_span,
                                              write_bam, write_uniform_bam)

FLAGS = [0, 0, 0, 16, 4, 256, 512, 1024, 1040, 2048]


def make_batch(lengths, n, seed, max_ops=8, long_read_ops=0) -> ReadBatch:
    """Reads with every op code 0-8, zero-op reads, tid = -1, masked
    flags, pos = -1 and positions overhanging their contig's end; with
    ``long_read_ops`` one read in the middle carries that many ops."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    nt = lengths.shape[0]
    tid = rng.randint(-1, nt, n).astype(np.int32)
    span = np.minimum(lengths[np.maximum(tid, 0)], (1 << 31) - 1000)
    pos = (rng.rand(n) * (span + 400)).astype(np.int64) - 1
    pos = np.minimum(pos, (1 << 31) - 1).astype(np.int32)
    pos[rng.rand(n) < 0.05] = -1
    flag = rng.choice(FLAGS, n).astype(np.int32)
    mapq = rng.randint(0, 61, n).astype(np.int32)
    n_ops = rng.randint(0, max_ops + 1, n).astype(np.int32)
    if long_read_ops:
        n_ops[n // 2] = long_read_ops
        tid[n // 2] = 0
        flag[n // 2] = 0
    m = int(n_ops.sum())
    op_code = rng.randint(0, 9, m).astype(np.int32)
    op_len = rng.randint(0, 200, m).astype(np.int32)
    op_len[rng.rand(m) < 0.05] = 0
    op_read = np.repeat(np.arange(n, dtype=np.int32), n_ops)
    return ReadBatch(tid=tid, pos=pos, flag=flag, mapq=mapq, n_ops=n_ops,
                     op_code=op_code, op_len=op_len, op_read=op_read)


def jax_padded(b: ReadBatch) -> ReadBatch:
    """The batch padded as pandepth_tpu's CoverageEngine.add_batch pads
    it: rows to a power of two with tid = -1, ops with length 0 owned by
    the last real read."""
    n, m = b.n_reads, b.n_total_ops
    npd, mpd = pad_pow2(n), pad_pow2(max(m, 1))

    def pad(a, size, fill):
        out = np.full(size, fill, np.int32)
        out[: a.shape[0]] = a
        return out

    return ReadBatch(tid=pad(b.tid, npd, -1), pos=pad(b.pos, npd, 0),
                     flag=pad(b.flag, npd, 0), mapq=pad(b.mapq, npd, 0),
                     n_ops=pad(b.n_ops, npd, 0),
                     op_code=pad(b.op_code, mpd, 0),
                     op_len=pad(b.op_len, mpd, 0),
                     op_read=pad(b.op_read, mpd, n - 1))


def _zigzag_encode(d: np.ndarray) -> np.ndarray:
    return (d << 1) ^ (d >> 63)


def enc_window(rng, code_dt, lo: int, hi: int, const: bool, n: int,
               cap: int, ce: int):
    """One encoded window of ``n`` live pairs in ``cap`` slots, as the
    native stream's encoder lays it out: (dd, ll, excd, excl, base,
    ulen). The base and four jumps lie in [lo, hi); starts step by small
    deltas (direct codes, some negative) between the jumps (delta escapes
    when they are far, negative ones included, which wrap the uint32
    tier's arithmetic); a mixed window has three escaped lengths, a
    const one the length ``ulen`` on every live pair."""
    esc = int(np.iinfo(code_dt).max)
    dd, ll = np.zeros(cap, code_dt), np.zeros(cap, code_dt)
    excd, excl = np.zeros(ce, np.int64), np.zeros(ce, np.int64)
    base = int(rng.randint(lo, hi))
    if n == 0:
        return dd, ll, excd, excl, base, 0
    deltas = rng.randint(-40, 120, n).astype(np.int64)
    jumps = np.sort(rng.choice(n, min(4, n), replace=False))
    targets = rng.randint(lo, hi, jumps.shape[0])
    for k, t in zip(jumps, targets):
        deltas[k] = t - (base + deltas[:k].sum())
    z = _zigzag_encode(deltas)
    dd[:n] = np.where(z < esc, z, esc)
    big = np.flatnonzero(z >= esc)
    excd[:big.shape[0]] = deltas[big]
    if const:
        ulen = int(rng.randint(1, min(esc, 400)))
        ll[:n] = ulen
        return dd, ll, excd, excl, base, ulen
    lens = rng.randint(0, 250, n).astype(np.int64)
    lbig = np.sort(rng.choice(n, min(3, n), replace=False))
    lens[lbig] = rng.randint(esc, esc + 5000, lbig.shape[0])
    ll[:n] = np.minimum(lens, esc)
    excl[:lbig.shape[0]] = lens[lbig]
    return dd, ll, excd, excl, base, 0


def enc_group(rng, code_dt, pos_dt, lo: int, hi: int, const: bool,
              rows_per_block, cap: int, ce: int):
    """One operand group of ``finalize_encoded`` as numpy arrays, in the
    JAX package's layout: (codes, excs, slots, bases[, lens, ns]) with
    one block per entry of ``rows_per_block``, its windows' bases and
    jumps in [lo, hi); and its windows as (dd, ll, excd, excl, base, n).
    Each block cycles through a zero row, a short row and a full row."""
    codes, excs, slots, bases, lens, ns, wins = [], [], [], [], [], [], []
    esc = int(np.iinfo(code_dt).max)
    for b in rows_per_block:
        c = np.zeros((b, cap) if const else (b, 2, cap), code_dt)
        e = np.zeros((b, ce) if const else (b, 2, ce), np.int64)
        s = np.full(e.shape, cap, np.int32)
        for r in range(b):
            n = [0, 7, cap][r % 3]
            dd, ll, excd, excl, base, ulen = enc_window(rng, code_dt, lo, hi,
                                                        const, n, cap, ce)
            wins.append((dd, ll, excd, excl, base, n))
            fd, fl = np.flatnonzero(dd == esc), np.flatnonzero(ll == esc)
            if const:
                c[r], e[r] = dd, excd
                s[r, :fd.shape[0]] = fd
                lens.append(ulen)
                ns.append(n)
            else:
                c[r, 0], c[r, 1], e[r, 0], e[r, 1] = dd, ll, excd, excl
                s[r, 0, :fd.shape[0]] = fd
                s[r, 1, :fl.shape[0]] = fl
            bases.append(base)
        codes.append(c)
        excs.append(e)
        slots.append(s)
    g = (tuple(codes), tuple(excs), tuple(slots),
         np.array(bases, np.int64).astype(pos_dt))
    if const:
        g += (np.array(lens, np.int32), np.array(ns, np.int32))
    return g, wins


def enc_placeholder(code_dt, pos_dt, const: bool):
    """The JAX engine's tiny depth-neutral block for an unused group."""
    shape = (1, 1) if const else (1, 2, 1)
    g = ((np.zeros(shape, code_dt),), (np.zeros(shape, np.int64),),
         (np.ones(shape, np.int32),), np.zeros(1, pos_dt))
    return g + (np.zeros(1, np.int32),) * 2 if const else g


# ---------------------------------------------------------------------
# the edges of the look-back scans (sweep_scan and decode_enc)

#: events per tile of the sweep_scan kernel and slots per tile of the
#: decode_enc kernel (SWEEP_TILE and DEC_TILE of csrc/sweep_kernels.cu;
#: chip_smoke.py holds them to the built library's)
SWEEP_TILE = 8192
DEC_TILE = 4096

#: each position tier's numpy dtype and the span its positions cover
TIER_SPANS = ((np.int32, 2_000_000_000), (np.uint32, 4_200_000_000),
              (np.int64, 17_000_000_000))


def sweep_edge_events(seed: int = 0):
    """The sweep scan's look-back edges as (name, pos, delta, pos dtype,
    min_dep, wrap18): int64 position values of the tier (sentinel slots
    at the tier's max with delta 0) in seeded order, int32 deltas. On
    every tier: 1, a tile - 1, a tile, a tile + 1 and a few tiles of
    events (min_dep 1 and 3, wrap18 off and on), a delta carry whose
    uint32 sum passes 2^32 many times, and a wrap18 pileup past 2^18
    across a tile boundary; on the int64 tier, c_sum past 2^64."""
    rng = np.random.RandomState(seed)
    t = SWEEP_TILE
    cases = []
    for pos_dt, span in TIER_SPANS:
        sentinel = int(np.iinfo(pos_dt).max)
        tier = np.dtype(pos_dt).name
        for k, n in enumerate((1, t - 1, t, t + 1, 5 * t + 17)):
            pos = rng.randint(0, span, n).astype(np.int64)
            pos[:n // 7] = pos[0]                          # duplicates
            delta = rng.choice([-1, 1, 1, 2], n).astype(np.int32)
            tail = n // 9                                  # sentinel tail
            if tail:
                pos[-tail:], delta[-tail:] = sentinel, 0
            cases.append((f"{tier} {n} events", pos, delta, pos_dt,
                          1 + 2 * (k % 2), bool(k % 2)))
        n = 3 * t + 5
        pos = rng.randint(0, span, n).astype(np.int64)
        delta = rng.randint(1 << 29, 1 << 30, n).astype(np.int32)
        cases.append((f"{tier} carry past 2^32", pos, delta, pos_dt, 1,
                      False))
        # 17 events of +40,000 at sorted slots t - 8 .. t + 8, 17 of
        # -40,000 after them
        p0 = span // 2
        below = rng.randint(0, p0, t - 8)
        above = rng.randint(p0 + 400, span, t + 25)
        pos = np.concatenate([below, np.full(17, p0), np.full(17, p0 + 333),
                              above]).astype(np.int64)
        delta = np.concatenate([rng.choice([-1, 1], t - 8),
                                np.full(17, 40_000), np.full(17, -40_000),
                                rng.choice([-1, 1], t + 25)]).astype(np.int32)
        perm = rng.permutation(pos.shape[0])
        for min_dep in (1, 3):
            cases.append((f"{tier} wrap18 pileup across a tile boundary",
                          pos[perm], delta[perm], pos_dt, min_dep, True))
    # depth near 2^31 over 1.7e10 positions: c_sum wraps past 2^64
    n = 2 * t + 3
    pos = np.sort(rng.randint(0, 17_000_000_000, n)).astype(np.int64)
    delta = np.resize(np.array([-1, 1], np.int32), n)
    delta[0] = (1 << 31) - 9
    perm = rng.permutation(n)
    cases.append(("int64 c_sum past 2^64", pos[perm], delta[perm], np.int64,
                  1, False))
    return cases


def enc_edge_groups(pos_dt, seed: int = 0):
    """decode_enc's look-back edges as finalize_encoded operand groups
    (numpy, JAX's layout), as (name, group): for each code width and
    format, blocks of 3 and 1 rows of CAP = 3 * DEC_TILE + 5 slots and 24
    escape entries per plane. The entries name the first and last slot of
    every tile, in no order, two of them twice (they add), and CAP and
    past it (dropped; unused entries hold CAP); one row's list is full;
    the const rows have ns = 0, ns = CAP and two between."""
    rng = np.random.RandomState(seed)
    t, cap, ce = DEC_TILE, 3 * DEC_TILE + 5, 24
    span = dict(TIER_SPANS)[pos_dt]
    edges = np.array([0, t - 1, t, 2 * t - 1, 2 * t, 3 * t - 1, 3 * t,
                      cap - 1, t, 2 * t], np.int32)

    def entry_list(full: bool):
        if full:
            return rng.randint(0, cap, ce).astype(np.int32)
        s = np.full(ce, cap, np.int32)
        s[:edges.shape[0]] = edges
        s[edges.shape[0]:edges.shape[0] + 3] = [cap + 3, cap, cap + 70]
        return s[rng.permutation(ce)]

    out = []
    for code_dt in (np.uint8, np.uint16):
        esc = int(np.iinfo(code_dt).max)
        for const in (False, True):
            codes, excs, slots, bases, lens, ns = [], [], [], [], [], []
            for rows in (3, 1):
                c = rng.randint(0, 200, (rows, cap) if const
                                else (rows, 2, cap)).astype(code_dt)
                e = np.zeros((rows, ce) if const else (rows, 2, ce),
                             np.int64)
                s = np.zeros(e.shape, np.int32)
                for r in range(rows):
                    full = len(bases) % 4 == 1
                    planes = ((c[r], e[r], s[r]),) if const else \
                        ((c[r, 0], e[r, 0], s[r, 0]),
                         (c[r, 1], e[r, 1], s[r, 1]))
                    for p, (cp, ep, sp) in enumerate(planes):
                        sp[:] = entry_list(full)
                        cp[sp[sp < cap]] = esc
                        ep[:] = rng.randint(-5_000_000, 5_000_000, ce) \
                            if p == 0 else rng.randint(esc, esc + 5000, ce)
                    bases.append(int(rng.randint(10_000, span - 100_000)))
                    lens.append(int(rng.randint(1, 400)))
                    ns.append([0, cap, 777, t][len(ns) % 4])
                codes.append(c)
                excs.append(e)
                slots.append(s)
            g = (tuple(codes), tuple(excs), tuple(slots),
                 np.array(bases, np.int64).astype(pos_dt))
            if const:
                g += (np.array(lens, np.int32), np.array(ns, np.int32))
            out.append((f"{np.dtype(code_dt).name} "
                        f"{'const' if const else 'mixed'}", g))
    return out


# ---------------------------------------------------------------------
# the edges of eval_pair's cooperative search and of its dense tiles

#: event words that a dense tile of the eval_pair kernel stages in shared
#: memory (EP_WIN of csrc/sweep_kernels.cu; chip_smoke.py holds it to the
#: built library's)
SEARCH_WIN = 3072


def _search_queries(rng, first: int, p: np.ndarray, top: int, span: int,
                    m: int):
    """(lo, hi) int64 in seeded order: boundaries before every event, at
    r = 1 (``first``, the least position, is held by one event), on
    events and beside them, at random, and past every event up to
    ``top`` - 1 (an even count of them, paired), some pairs reversed (lo
    > hi); then a zero-length segment on every fifth boundary."""
    k = rng.randint(0, p.shape[0], m)
    x = np.concatenate([[0, first - 1, first, first + 1, top - 2, top - 1],
                        p[k], np.minimum(p[k] + 1, top - 1), p[k] - 1,
                        rng.randint(0, span, m)]).astype(np.int64)
    x = x[rng.permutation(x.shape[0])]
    lo, hi = x[0::2].copy(), x[1::2].copy()
    swap = lo > hi
    swap[::7] = False
    lo[swap], hi[swap] = hi[swap], lo[swap]
    return np.concatenate([lo, x[::5]]), np.concatenate([hi, x[::5]])


def search_edge_cases(seed: int = 0):
    """eval_pair's edges as (name, pos, delta, pos dtype, min_dep, lo,
    hi): events as ``sweep_edge_events`` gives them (int64 position values
    of the tier, sentinel slots at the tier's max with delta 0, in seeded
    order; int32 deltas) and int64 segment bounds. On every tier: 1, 2,
    15, 16, 17, 255, 256 and 257 events (around the 16-way split) and a
    few dense tiles' worth (3 * SEARCH_WIN + 5), each queried before every
    event (r = 0), at r = 1, on events and beside them, and past every
    event up to the tier's max less one, with zero-length segments and
    some with lo > hi, in seeded order; a run of equal positions longer
    than a 16-way round's stride, queried on it and beside it; and 40,000
    sorted adjacent segments over events that are sparse but for one
    cluster, so that a tile of 16 to 400 consecutive segments spans more
    than SEARCH_WIN events over the cluster and fewer elsewhere, then the
    same segments shuffled. On the uint32 tier alone: 2^19 adjacent
    segments over 10 events each, whose tiles of 400 or more segments
    span more than SEARCH_WIN events and whose sub-tiles of 256 fewer."""
    rng = np.random.RandomState(seed)
    cases = []
    for pos_dt, span in TIER_SPANS:
        tier = np.dtype(pos_dt).name
        top = int(np.iinfo(pos_dt).max)

        def events(p, k):
            delta = rng.choice([-1, 1, 1, 2], p.shape[0]).astype(np.int32)
            tail = p.shape[0] // 9 if p.shape[0] >= 16 else 0
            pos = np.concatenate([p, np.full(tail, top, np.int64)])
            delta = np.concatenate([delta, np.zeros(tail, np.int32)])
            perm = rng.permutation(pos.shape[0])
            return pos[perm], delta[perm], pos_dt, 1 + 2 * (k % 2)

        for k, n in enumerate((1, 2, 15, 16, 17, 255, 256, 257,
                               3 * SEARCH_WIN + 5)):
            p = rng.randint(10, span - 10, n).astype(np.int64)
            p[:n // 4] = p[-1]                            # duplicates
            p[0] = 3                                      # the one least
            cases.append((f"{tier} {n} events", *events(p, k),
                          *_search_queries(rng, 3, p, top, span, 40)))
        n, run = 5000, 3000
        p = rng.randint(10, span - 10, n).astype(np.int64)
        p[0], p[1:run + 1] = 3, span // 2
        lo, hi = _search_queries(rng, 3, p, top, span, 40)
        v = np.array([span // 2 - 1, span // 2, span // 2 + 1], np.int64)
        cases.append((f"{tier} a run of {run} equal positions in {n}",
                      *events(p, 0), np.concatenate([lo, v, v]),
                      np.concatenate([hi, v + 5, v[::-1]])))
        c = span // 2
        p = np.concatenate([[3], rng.randint(10, span - 10, 4000),
                            rng.randint(c, c + span // 400, 60_000)])
        w = span // 40_000
        lo = np.arange(40_000, dtype=np.int64) * w
        cases.append((f"{tier} dense tiles, one cluster", *events(p, 1), lo,
                      lo + w))
        perm = rng.permutation(lo.shape[0])
        cases.append((f"{tier} dense tiles, shuffled", *events(p, 0),
                      lo[perm], lo[perm] + w))
    # wide tiles: 2^19 adjacent segments with 10 events each on average,
    # so a tile of 400 or more spans more than SEARCH_WIN events and a
    # sub-tile of 256 fewer
    span = dict(TIER_SPANS)[np.uint32]
    w = span >> 19
    p = np.concatenate([[3], rng.randint(10, w << 19, 10 << 19)])
    delta = rng.choice([-1, 1, 1, 2], p.shape[0]).astype(np.int32)
    lo = np.arange(1 << 19, dtype=np.int64) * w
    cases.append(("uint32 dense wide tiles", p[rng.permutation(p.shape[0])],
                  delta, np.uint32, 1, lo, lo + w))
    return cases


def rows_edge_segments(bounds: np.ndarray, seed: int = 0):
    """eval_pair_rows' edges over the range cuts ``bounds`` ((rows + 1,)
    int64, increasing) as (lo, hi) int64: segments that cross no row
    (zero-length inside a range and on each cut), one (inside a range,
    and each range whole), two (across each inner cut) and every row (the
    whole axis, and its first and last cell), clips on a range's ends (a
    segment ending on a cut, one starting on it, each a cell either side),
    and some reversed (lo > hi) across cuts."""
    rng = np.random.RandomState(seed)
    b = np.asarray(bounds, np.int64)
    a, z = b[:-1], b[1:]
    mid = a + (z - a) // 2
    inner = b[1:-1]
    one = max(int((b[-1] - b[0]) // (7 * a.shape[0])), 1)
    lo = np.concatenate([mid, b, a + one, a, inner - one, [b[0], b[0]],
                         b[1:] - 1, b[1:], inner - 1, inner, inner + 1])
    hi = np.concatenate([mid, b, mid, z, inner + one, [b[-1], b[0] + 1],
                         b[1:], b[1:] + one, inner, inner + 1, inner - one])
    step = max(int((b[-1] - b[0]) // 50), 1)
    far = np.sort(rng.randint(int(b[0]), int(b[-1]), 40)).astype(np.int64)
    return (np.concatenate([lo, far, far + step]),
            np.concatenate([hi, far[::-1], far + 3 * step]))


# ---------------------------------------------------------------------
# the edges of the sharded engine's carry (shard_carry)

#: slots of the shard_carry kernel's runs, the unit of a block's share of
#: the flattened (rows x width) block (CARRY_RUN of csrc/sweep_kernels.cu;
#: chip_smoke.py holds it to the built library's)
CARRY_RUN = 1024

#: rows of carry_edge_blocks' largest block: more than a grid's y
#: dimension takes (65,535)
CARRY_MANY_ROWS = 70_000


def carry_edge_blocks(seed: int = 0):
    """shard_carry's edges as (name, pos2d, delta2d, pos dtype, bounds,
    left): a (rows, width) block of int64 position values of the tier
    (each row's in its range) and int32 deltas, slot 0 of each row holding
    junk that the carry overwrites; the (rows + 1,) int64 range cuts; the
    int64 totals of the rows on earlier devices (maybe none). On the int32
    and the uint32 tier: row payloads (width - 1) of 1, a run - 1, a run,
    a run + 1 and a few runs of the kernel (CARRY_RUN: a row of a run's
    width starts on each run, the others on a run's slots in turn), over
    1, 8 and 37 rows; every block of 8 or more rows has an all-zero row and
    rows of deltas near 2^30 whose carries pass 2^31 at a row edge; every
    other block has a non-empty ``left``. On the int32 tier also
    CARRY_MANY_ROWS rows of payload 2."""
    rng = np.random.RandomState(seed)
    t = CARRY_RUN
    cases = []

    def block(pos_dt, span, rows, payload, with_left):
        b = np.sort(rng.randint(0, span, rows + 1)).astype(np.int64)
        b[0] = 0
        a, z = b[:-1, None], np.maximum(b[1:, None], b[:-1, None] + 1)
        pos = a + (rng.rand(rows, payload + 1) * (z - a)).astype(np.int64)
        delta = rng.choice([-1, 0, 1, 2], (rows, payload + 1)).astype(
            np.int32)
        delta[:, 0] = rng.randint(-9, 9, rows)        # junk in slot 0
        if rows >= 8:
            delta[1, 1:] = 0                          # an all-zero row
            delta[2:6, 1:4] = 1 << 30                 # carries past 2^31
        left = rng.randint(-(1 << 40), 1 << 40, 5).astype(np.int64) \
            if with_left else np.zeros(0, np.int64)
        return pos, delta, pos_dt, b, left

    k = 0
    for pos_dt, span in TIER_SPANS[:2]:
        tier = np.dtype(pos_dt).name
        for payload in (1, t - 1, t, t + 1, 3 * t + 5):
            for rows in (1, 8, 37):
                with_left = k % 2 == 1
                k += 1
                cases.append((f"{tier} {rows} rows of payload {payload}, "
                              f"{'a' if with_left else 'no'} left",
                              *block(pos_dt, span, rows, payload,
                                     with_left)))
    cases.append((f"int32 {CARRY_MANY_ROWS} rows of payload 2, a left",
                  *block(np.int32, 2_000_000_000, CARRY_MANY_ROWS, 2, True)))
    return cases


# ---------------------------------------------------------------------
# the edges of the chained-scan kernels (extract_events and bucket_events)

#: ops per tile of the extract_events kernel and events per tile of the
#: bucket_events kernel (EXT_TILE and BUCKET_TILE of
#: csrc/sweep_kernels.cu; chip_smoke.py holds them to the built library's)
EXTRACT_TILE = 1024
BUCKET_TILE = 4096


def _op_counts(rng, m: int) -> np.ndarray:
    """Ops per read, 0-8 each as make_batch draws them, summing to m."""
    counts = rng.randint(0, 9, m + 1)
    cut = int(np.searchsorted(np.cumsum(counts), m))
    counts = counts[:cut + 1]
    counts[-1] -= int(counts.sum()) - m
    return counts


def _reads_for(rng, lengths, n_ops, kept=(), ops=None) -> ReadBatch:
    """Reads drawn as make_batch draws them, with these op counts; the
    reads in ``kept`` pass every filter at position 1,000 of contig 0.
    ``ops`` maps a read to its own (op_code, op_len) arrays."""
    lengths = np.asarray(lengths, np.int64)
    n_ops = np.asarray(n_ops, np.int32)
    n = n_ops.shape[0]
    tid = rng.randint(-1, lengths.shape[0], n).astype(np.int32)
    span = np.minimum(lengths[np.maximum(tid, 0)], (1 << 31) - 1000)
    pos = np.minimum((rng.rand(n) * (span + 400)).astype(np.int64) - 1,
                     (1 << 31) - 1).astype(np.int32)
    flag = rng.choice(FLAGS, n).astype(np.int32)
    mapq = rng.randint(0, 61, n).astype(np.int32)
    for r in kept:
        tid[r], pos[r], flag[r], mapq[r] = 0, 1000, 0, 60
    m = int(n_ops.sum())
    op_code = rng.randint(0, 9, m).astype(np.int32)
    op_len = rng.randint(0, 200, m).astype(np.int32)
    op_len[rng.rand(m) < 0.05] = 0
    first = np.concatenate([[0], np.cumsum(n_ops)[:-1]])
    for r, (codes, lens) in (ops or {}).items():
        op_code[first[r]:first[r] + n_ops[r]] = codes
        op_len[first[r]:first[r] + n_ops[r]] = lens
    return ReadBatch(tid=tid, pos=pos, flag=flag, mapq=mapq, n_ops=n_ops,
                     op_code=op_code, op_len=op_len,
                     op_read=np.repeat(np.arange(n, dtype=np.int32), n_ops))


def extract_edge_batches(lengths, seed: int = 0):
    """extract_events' tile edges as (name, ReadBatch) on contigs of
    ``lengths``: 1, a tile - 1, a tile, a tile + 1 and a few tiles of ops;
    reads that start on a tile's first op and on its last (one of them
    running into the next tile); a read of more than three tiles of ops
    (two tiles and more with no read starting in them); zero-op reads
    between a tile's last op and the next tile's first; JAX's padding
    (``jax_padded``) across a tile boundary; and a read whose
    ref-consumed lengths pass 2^32 across a tile boundary (18 D ops of
    2^28 - 1, then M ops)."""
    rng = np.random.RandomState(seed)
    t = EXTRACT_TILE
    cases = [(f"{m} ops", _reads_for(rng, lengths, _op_counts(rng, m)))
             for m in (1, t - 1, t, t + 1, 3 * t + 5)]
    n_ops = np.concatenate([_op_counts(rng, t), _op_counts(rng, t - 1), [1],
                            _op_counts(rng, t - 1), [2],
                            _op_counts(rng, 300)])
    cases.append(("reads start on a tile's first op and on its last",
                  _reads_for(rng, lengths, n_ops)))
    head = _op_counts(rng, 50)
    n_ops = np.concatenate([head, [3 * t + 100], _op_counts(rng, 200)])
    cases.append(("a read of more than three tiles of ops",
                  _reads_for(rng, lengths, n_ops, kept=[head.shape[0]])))
    n_ops = np.concatenate([_op_counts(rng, t), [0, 0, 0],
                            _op_counts(rng, 500)])
    cases.append(("zero-op reads at a tile boundary",
                  _reads_for(rng, lengths, n_ops)))
    b = _reads_for(rng, lengths, _op_counts(rng, 2 * t + t // 2))
    cases.append(("JAX's padding across a tile boundary", jax_padded(b)))
    head = _op_counts(rng, t - 25)
    n_ops = np.concatenate([head, [40], _op_counts(rng, 100)])
    codes = np.repeat(np.array([2, 0], np.int32), [18, 22])
    lens = np.repeat(np.array([(1 << 28) - 1, 100], np.int32), [18, 22])
    cases.append(("a read's ref lengths past 2^32 across a tile boundary",
                  _reads_for(rng, lengths, n_ops, kept=[head.shape[0]],
                             ops={head.shape[0]: (codes, lens)})))
    return cases


def bucket_edge_events(seed: int = 0):
    """bucket_events' tile edges as (name, pos, delta, pos dtype,
    bounds): int64 position values of the tier (dead slots with delta 0,
    half of them at the tier's max), int32 deltas, and the (world + 1,)
    int64 cuts of ``world`` equal ranges over the tier's span (an event at
    the span's end goes to the last range). On every tier: 0, 1, a tile
    - 1, a tile, a tile + 1 and a few tiles of events (a third in
    coordinate order, the last at the axis's end) over 1, 2, 8, 37 and
    1,024 ranges; and over 8 ranges a destination change on a tile's
    first event and on its last, an all-dead tile, a destination empty
    everywhere, and a hot range (every live event in range 0 but one at
    the axis's end)."""
    rng = np.random.RandomState(seed)
    t = BUCKET_TILE
    cases = []
    for pos_dt, span in TIER_SPANS:
        tier = np.dtype(pos_dt).name
        sentinel = int(np.iinfo(pos_dt).max)

        def cuts(world):
            step = -(-span // world)
            return np.minimum(np.arange(world + 1, dtype=np.int64) * step,
                              span)

        def events(n, live=1.0):
            pos = rng.randint(0, span, n).astype(np.int64)
            delta = rng.choice([-1, 1, 1, 5], n).astype(np.int32)
            dead = rng.rand(n) >= live
            delta[dead] = 0
            pos[dead & (rng.rand(n) < 0.5)] = sentinel
            return pos, delta

        def in_ranges(b, dst):
            lo, hi = b[dst], b[dst + 1]
            return lo + (rng.rand(dst.shape[0]) * (hi - lo)).astype(np.int64)

        for world in (1, 2, 8, 37, 1024):
            for n in (0, 1, t - 1, t, t + 1, 3 * t + 7):
                pos, delta = events(n, live=0.9)
                pos[:n // 3] = np.sort(pos[:n // 3])
                if n > 1:
                    pos[-1], delta[-1] = span, 1
                cases.append((f"{tier} {n} events, {world} ranges", pos,
                              delta, pos_dt, cuts(world)))
        b = cuts(8)
        dst = np.concatenate([np.zeros(t, np.int64), np.ones(t - 1, np.int64),
                              [2], np.full(t, 3), rng.randint(4, 8, 100)])
        cases.append((f"{tier} a destination change on a tile's first event "
                      f"and on its last, 8 ranges", in_ranges(b, dst),
                      rng.choice([-1, 1, 2], dst.shape[0]).astype(np.int32),
                      pos_dt, b))
        pos, delta = events(3 * t)
        delta[t:2 * t] = 0
        pos[t:2 * t:2] = sentinel
        cases.append((f"{tier} an all-dead tile, 8 ranges", pos, delta,
                      pos_dt, b))
        dst = rng.choice([0, 1, 2, 4, 5, 6, 7], 2 * t + 9)
        pos, delta = events(dst.shape[0], live=0.9)
        pos[delta != 0] = in_ranges(b, dst)[delta != 0]
        cases.append((f"{tier} range 3 empty everywhere, 8 ranges", pos,
                      delta, pos_dt, b))
        pos, delta = events(2 * t + 5, live=0.9)
        pos[delta != 0] = rng.randint(0, 100, int((delta != 0).sum()))
        pos[-1], delta[-1] = span, 1
        cases.append((f"{tier} a hot range, 8 ranges", pos, delta, pos_dt, b))
    return cases


# ---------------------------------------------------------------------
# the edges of K2's sort (sort_pairs)

#: events per tile of the sort_pairs kernel (SORT_TILE of
#: csrc/sweep_kernels.cu; chip_smoke.py holds it to the built library's)
SORT_TILE = 4096

#: each tier's numpy dtype and the least and the greatest word its keys
#: take here: the whole int32 range (negative keys too), the whole uint32
#: range, and int64 words past both ends of 2^32
SORT_RANGES = ((np.int32, -(1 << 31), (1 << 31) - 1),
               (np.uint32, 0, (1 << 32) - 1),
               (np.int64, -(1 << 62), 1 << 62))


def sort_edge_events(seed: int = 0):
    """sort_pairs' edges as (name, pos, delta, pos dtype): int64 values of
    the tier's words, int32 deltas that tell the events apart (a wrong
    order among equal positions shows). On every tier: 0, 1, a tile - 1,
    a tile, a tile + 1 and a few tiles of events drawn over the tier's
    whole range with duplicates; every position equal; positions
    descending and ascending; an encoded buffer's tail (two thirds of
    the events at the tier's max with delta 0, so most tiles hold one
    digit value); a pile-up (three tiles of events on one position
    amid others); positions that differ only in the top or only in the
    bottom byte; the tier's least and greatest words."""
    rng = np.random.RandomState(seed)
    t = SORT_TILE
    cases = []
    for pos_dt, least, most in SORT_RANGES:
        tier = np.dtype(pos_dt).name

        def draw(n):
            pos = rng.randint(least, most, n, dtype=np.int64)
            pos[:n // 5] = pos[n // 5 + 1:2 * (n // 5) + 1]   # duplicates
            return pos

        def tags(n):
            return rng.randint(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64
                               ).astype(np.int32)

        for n in (0, 1, t - 1, t, t + 1, 3 * t + 7):
            cases.append((f"{tier} {n} events", draw(n), tags(n), pos_dt))
        n = 2 * t + 3
        same = np.full(n, rng.randint(least, most, dtype=np.int64))
        cases.append((f"{tier} all {n} positions equal", same,
                      np.arange(n, dtype=np.int32), pos_dt))
        pos = np.sort(draw(n))
        cases.append((f"{tier} descending", pos[::-1].copy(), tags(n),
                      pos_dt))
        cases.append((f"{tier} ascending", pos, tags(n), pos_dt))
        pos, delta = draw(3 * t), tags(3 * t)
        pos[t:], delta[t:] = most, 0
        cases.append((f"{tier} an encoded buffer's sentinel tail", pos,
                      delta, pos_dt))
        pos = draw(5 * t)
        pile = rng.permutation(5 * t)[:3 * t]
        pos[pile] = pos[0]
        cases.append((f"{tier} a pile-up of {3 * t} events", pos,
                      np.arange(5 * t, dtype=np.int32), pos_dt))
        base = rng.randint(least // 2, most // 2, dtype=np.int64) & ~0xFF
        top = 1 << (8 * np.dtype(pos_dt).itemsize - 8)
        for what, step in (("top", top), ("bottom", 1)):
            k = rng.randint(0, 100 if step > 1 else 256, t + 9)
            cases.append((f"{tier} positions apart only in the {what} byte",
                          (least if step > 1 else base) + k * step,
                          tags(t + 9), pos_dt))
        ends = np.array([most, least, most, least + 1, most - 1, least],
                        np.int64)
        cases.append((f"{tier} the least and greatest words", ends,
                      np.arange(6, dtype=np.int32), pos_dt))
    return cases


def sort_edge_rows(seed: int = 0):
    """sort_pairs' row form as (name, pos2d, delta2d, pos dtype): on
    every tier an (8, width) block whose slot 0 is the row's range start
    and whose rows end in sentinel padding (delta 0), as the sharded
    engine's rows are, of widths 1, a tile + 1 and three tiles + 5; an
    empty row; a row whose events all sit on its range start."""
    rng = np.random.RandomState(seed)
    cases = []
    for pos_dt, span in TIER_SPANS:
        tier = np.dtype(pos_dt).name
        sentinel = int(np.iinfo(pos_dt).max)
        cuts = np.linspace(0, span, 9).astype(np.int64)
        for width in (1, SORT_TILE + 1, 3 * SORT_TILE + 5):
            pos = np.full((8, width), sentinel, np.int64)
            delta = np.zeros((8, width), np.int32)
            for r in range(8):
                live = (width * (r + 1)) // 9 if r != 3 else 0
                pos[r, 1:1 + live] = rng.randint(cuts[r], cuts[r + 1], live)
                delta[r, 1:1 + live] = rng.choice([-1, 1, 2], live)
                if r == 5:
                    pos[r, 1:1 + live] = cuts[r]
                pos[r, 0] = cuts[r]
                delta[r, 0] = rng.randint(0, 1 << 20)
            cases.append((f"{tier} (8, {width}) rows", pos, delta, pos_dt))
    return cases


# ---------------------------------------------------------------------
# the golden fixtures (tests/fixtures.py)

CONTIGS = [("chr1", 5000), ("chr2", 3200), ("ctgM", 700)]


def make_fasta(path: str, contigs=CONTIGS, seed: int = 7,
               line_len: int = 60) -> None:
    rng = random.Random(seed)
    with open(path, "w") as fh:
        for name, ln in contigs:
            fh.write(f">{name} extra description\n")
            seq = "".join(rng.choice("ACGTacgtN") for _ in range(ln))
            for i in range(0, ln, line_len):
                fh.write(seq[i: i + line_len] + "\n")


def random_reads(contigs=CONTIGS, n: int = 800, seed: int = 11,
                 max_read: int = 150,
                 end_slack: Optional[int] = None) -> List[Tuple]:
    """Coordinate-sorted (tid, pos0, flag, mapq, cigar) records with a
    spread of CIGAR shapes, FLAG bits and MAPQs; ``end_slack`` caps how
    far past its contig end a read may reach."""
    rng = random.Random(seed)
    recs = []
    while len(recs) < n:
        tid = rng.randrange(len(contigs))
        clen = contigs[tid][1]
        pos = rng.randrange(0, max(clen - 20, 1))
        roll = rng.random()
        if roll < 0.55:
            cigar = f"{rng.randrange(20, max_read)}M"
        elif roll < 0.7:
            a, b, c = (rng.randrange(5, 40) for _ in range(3))
            cigar = f"{a}M{rng.randrange(1, 9)}D{b}M{rng.randrange(1, 5)}I{c}M"
        elif roll < 0.8:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{rng.randrange(1, 20)}S{a}M{rng.randrange(20, 400)}N{b}M"
        elif roll < 0.9:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{a}={rng.randrange(1, 6)}X{b}="
        else:
            cigar = f"{rng.randrange(10, 60)}M{rng.randrange(5, 30)}S"
        flag = 0
        r = rng.random()
        if r < 0.06:
            flag |= 0x100   # secondary
        elif r < 0.1:
            flag |= 0x400   # duplicate
        elif r < 0.13:
            flag |= 0x200   # QC fail
        elif r < 0.15:
            flag = 4        # unmapped
            cigar = "*"
        if rng.random() < 0.5:
            flag |= 0x10
        mapq = rng.choice([0, 1, 10, 30, 60])
        if end_slack is not None and cigar != "*":
            end = pos + ref_span(cigar_str_to_ops(cigar))
            if end > clen + end_slack:
                continue
        recs.append((tid, pos, flag, mapq, cigar))
    recs.sort(key=lambda r: (r[0], r[1]))
    return recs


def make_bam(path: str, contigs=CONTIGS, n: int = 800, seed: int = 11,
             make_index: bool = True,
             end_slack: Optional[int] = None) -> List[Tuple]:
    recs = random_reads(contigs, n, seed, end_slack=end_slack)
    write_bam(path, [c[0] for c in contigs], [c[1] for c in contigs], recs,
              make_index=make_index)
    return recs


def make_gff(path: str, contigs=CONTIGS, feature: str = "CDS",
             overhang: bool = True) -> None:
    """``overhang=True`` includes a segment past a contig end (GC
    fixtures pass False: the reference's GC read there is undefined)."""
    end_c6 = 3300 if overhang else 3150
    lines = [
        "##gff-version 3",
        f"{contigs[0][0]}\tsrc\tgene\t100\t900\t.\t+\t.\tID=gene1",
        f"{contigs[0][0]}\tsrc\t{feature}\t120\t340\t.\t+\t0\tID=cds1;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t300\t520\t.\t+\t0\tID=cds2;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t700\t890\t.\t+\t0\tID=cds3;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t1200\t1500\t.\t-\t0\tID=c4;Parent=mRNA2",
        f"{contigs[1][0]}\tsrc\t{feature}\t50\t400\t.\t+\t0\tID=c5;Parent=mRNA3",
        f"{contigs[1][0]}\tsrc\t{feature}\t2900\t{end_c6}\t.\t+\t0\tID=c6;Parent=mRNA4",
        f"{contigs[2][0]}\tsrc\t{feature}\t1\t700\t.\t+\t0\tID=c7;Parent=mRNA5",
        f"chrNOPE\tsrc\t{feature}\t1\t100\t.\t+\t0\tID=c8;Parent=mRNA6",
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def make_bed(path: str, contigs=CONTIGS) -> None:
    rows = [
        (contigs[0][0], 100, 600),
        (contigs[0][0], 550, 1200),
        (contigs[1][0], 1, 3200),
        (contigs[2][0], 650, 800),   # overhangs the contig end
        (contigs[0][0], 100, 600),   # duplicate row (id-merge quirk)
    ]
    with open(path, "w") as fh:
        for c, s, e in rows:
            fh.write(f"{c}\t{s}\t{e}\n")


def golden_inputs(d: str) -> None:
    """The golden configurations' inputs in ``d``: golden.bam (800 reads,
    seed 11, indexed), the same records as golden.sam (no index: every
    read counts) and as golden.cram (=/X canonicalised to M, the same
    depth), t.bed, t.gff, safe.gff (no overhang) and ref.fa."""
    from pandepth_tpu_torch.io.cram_writer import write_cram

    recs = make_bam(os.path.join(d, "golden.bam"), n=800, seed=11)
    make_bed(os.path.join(d, "t.bed"))
    make_gff(os.path.join(d, "t.gff"))
    make_gff(os.path.join(d, "safe.gff"), overhang=False)
    make_fasta(os.path.join(d, "ref.fa"))
    names = [c[0] for c in CONTIGS]
    with open(os.path.join(d, "golden.sam"), "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for name, ln in CONTIGS:
            fh.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        for i, (tid, pos, flag, mapq, cigar) in enumerate(recs):
            n_seq = sum(ln for op, ln in cigar_str_to_ops(cigar)
                        if op in (0, 1, 4, 7, 8)) if cigar != "*" else 0
            fh.write(f"r{i}\t{flag}\t{names[tid]}\t{pos + 1}\t{mapq}\t"
                     f"{cigar}\t*\t0\t0\t{'A' * n_seq if n_seq else '*'}"
                     f"\t*\n")
    write_cram(os.path.join(d, "golden.cram"), names,
               [c[1] for c in CONTIGS],
               [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
                for t, p, f, q, c in recs])


# ---------------------------------------------------------------------
# the benchmark fixtures (bench.py, bench3gb.py): 12 x 250 Mb contigs,
# 150 bp reads, MAPQ from {0, 10, 30, 60}, 5% duplicates

GENOME = [(f"chr{i + 1}", 250_000_000) for i in range(12)]


#: the site dump's genome: 16 contigs of 750 kb, 12 Mb, the size of
#: S. cerevisiae's, small enough to dump per base
SITE_GENOME = [(f"chr{i + 1}", 750_000) for i in range(16)]
#: reads of the site fixture: 30x of SITE_GENOME at 150 bp
SITE_READS = 2_400_000


def _uniform_reads(rng, n: int, sort: bool, genome=GENOME):
    lens = np.array([g[1] for g in genome])
    tid = rng.randint(0, len(genome), n).astype(np.int32)
    pos = (rng.rand(n) * (lens[tid] - 200)).astype(np.int32)
    if sort:
        order = np.lexsort((pos, tid))
        tid, pos = tid[order], pos[order]
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    return tid, pos, flag, mapq


def _write_genome_bam(path: str, reads, make_index: bool = True,
                      genome=GENOME) -> None:
    """Write to a temporary name, then move it (and its index) in place:
    a killed run never leaves a torn BAM."""
    tmp = path + ".tmp"
    write_uniform_bam(tmp, [g[0] for g in genome], [g[1] for g in genome],
                      *reads, make_index=make_index)
    if make_index:
        os.replace(tmp + ".bai", path + ".bai")
    os.replace(tmp, path)


def bench_bam(bench_dir: str, n_reads: int) -> str:
    """bench.py's fixture (``ensure_fixture``): ``n_reads`` sorted,
    indexed reads, seed 42, as ``bench3gshape_{n_reads}.bam``; reused
    when it exists."""
    os.makedirs(bench_dir, exist_ok=True)
    bam = os.path.join(bench_dir, f"bench3gshape_{n_reads}.bam")
    if not os.path.exists(bam):
        _write_genome_bam(bam, _uniform_reads(np.random.RandomState(42),
                                              n_reads, sort=True))
    return bam


def site_bam(bench_dir: str, n_reads: int = SITE_READS) -> str:
    """The ``-a`` fixture: ``n_reads`` sorted, indexed 150 bp reads over
    SITE_GENOME (30x at SITE_READS), bench.py's draws at seed 42, as
    ``site12mb_{n_reads}.bam``; reused when it exists."""
    os.makedirs(bench_dir, exist_ok=True)
    bam = os.path.join(bench_dir, f"site12mb_{n_reads}.bam")
    if not os.path.exists(bam):
        _write_genome_bam(bam, _uniform_reads(np.random.RandomState(42),
                                              n_reads, sort=True,
                                              genome=SITE_GENOME),
                          genome=SITE_GENOME)
    return bam


def unsorted_bam(bench_dir: str, n_reads: int) -> str:
    """bench.py's reads without their coordinate sort (same seed and
    draws), no index, as ``unsorted_{n_reads}.bam``; reused when it
    exists."""
    bam = os.path.join(bench_dir, f"unsorted_{n_reads}.bam")
    if not os.path.exists(bam):
        _write_genome_bam(bam, _uniform_reads(np.random.RandomState(42),
                                              n_reads, sort=False),
                          make_index=False)
    return bam


#: the spliced fixture's CIGAR: a 5-base deletion and a 3,000-base
#: splice, three segments a read, the last 3,105 bases past the read's
#: start, which is past the next reads' starts at SPLICED_READS on GENOME
SPLICED_CIGAR = "60M5D40M3000N50M"
SPLICED_READS = 2_000_000


def spliced_bam(bench_dir: str, n_reads: int = SPLICED_READS) -> str:
    """``n_reads`` sorted, indexed reads of ``SPLICED_CIGAR`` over GENOME
    (bench.py's draws at seed 43), as ``spliced_{n_reads}.bam``; reused
    when it exists."""
    os.makedirs(bench_dir, exist_ok=True)
    bam = os.path.join(bench_dir, f"spliced_{n_reads}.bam")
    if not os.path.exists(bam):
        tmp = bam + ".tmp"
        write_uniform_bam(tmp, [g[0] for g in GENOME],
                          [g[1] for g in GENOME],
                          *_uniform_reads(np.random.RandomState(43),
                                          n_reads, sort=True),
                          cigar=SPLICED_CIGAR)
        os.replace(tmp + ".bai", bam + ".bai")
        os.replace(tmp, bam)
    return bam


DEEP_READS = 270_000


def deep_bam(bench_dir: str) -> str:
    """The 18-bit depth wrap's fixture (quirk Q1): one 400 bp contig
    ``c1``, DEEP_READS ``20M`` reads at 0-based 100 and five ``50M``
    reads at 300, sorted and indexed, as ``deep18.bam``; reused when it
    exists (the Python writer takes ~10 s)."""
    os.makedirs(bench_dir, exist_ok=True)
    bam = os.path.join(bench_dir, "deep18.bam")
    if not os.path.exists(bam):
        tmp = bam + ".tmp"
        write_bam(tmp, ["c1"], [400], [(0, 100, 0, 60, "20M")] * DEEP_READS
                  + [(0, 300, 0, 60, "50M")] * 5)
        os.replace(tmp + ".bai", bam + ".bai")
        os.replace(tmp, bam)
    return bam


def literal_bam(path: str, n_reads: int, seed: int = 5) -> None:
    """``n_reads`` sorted 150M reads on one 250 Mb contig with random
    bases (A, C, G, T) and base qualities (2 to 41), BGZF at zlib's level
    6 as samtools writes it, no index: blocks of mostly literals, shaped
    like a real sample's, where the other fixtures' ``=`` bases and
    missing qualities compress 30-fold. Read names have 7 digits: fewer
    than 10,000,000 reads."""
    if not 0 <= n_reads < 10_000_000:
        raise ValueError(f"literal_bam: {n_reads} reads")
    rng = np.random.default_rng(seed)
    read_len, qname_len = 150, 9  # "rXXXXXXX" and its NUL
    body = 32 + qname_len + 4 + read_len // 2 + read_len
    rec = np.zeros((n_reads, 4 + body), np.uint8)

    def put(col, arr, dtype):
        a = np.ascontiguousarray(np.broadcast_to(np.asarray(arr, dtype),
                                                 (n_reads,)))
        rec[:, col: col + a.itemsize] = a.view(np.uint8).reshape(
            n_reads, a.itemsize)

    pos = np.sort(rng.integers(0, 2_000_000, n_reads))
    put(0, body, "<i4")
    put(8, pos, "<i4")
    rec[:, 12] = qname_len
    rec[:, 13] = 60
    bins = np.zeros(n_reads, np.int64)  # reg2bin (SAMv1 5.3)
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (pos >> shift) == ((pos + read_len - 1) >> shift)
        bins = np.where(same, base + (pos >> shift), bins)
    put(14, bins, "<u2")
    put(16, 1, "<u2")
    put(20, read_len, "<i4")
    put(24, -1, "<i4")
    put(28, -1, "<i4")
    names = np.char.add("r", np.char.zfill(
        np.arange(n_reads).astype("U7"), 7)).astype("S8")
    rec[:, 36:44] = names.view(np.uint8).reshape(n_reads, 8)
    put(45, read_len << 4, "<u4")  # 150M
    nt = np.array([1, 2, 4, 8], np.uint8)  # A C G T
    rec[:, 49: 49 + read_len // 2] = \
        nt[rng.integers(0, 4, (n_reads, read_len // 2))] << 4 | \
        nt[rng.integers(0, 4, (n_reads, read_len // 2))]
    rec[:, 49 + read_len // 2:] = rng.integers(2, 42, (n_reads, read_len))
    hdr = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 1) + \
        struct.pack("<i", 5) + b"chr1\x00" + struct.pack("<i", 250_000_000)
    with open(path + ".tmp", "wb") as fh:
        w = _BlockTrackingBgzf(fh)
        w.write(hdr + rec.tobytes())
        w.close()
    os.replace(path + ".tmp", path)


def list_sample_bam(path: str, seed: int, n_reads: int) -> None:
    """One extra sample of bench3gb.py's ``.list`` configuration
    (``_gen_list_extra_fixture``): ``n_reads`` sorted, indexed reads,
    seed 100 + ``seed``."""
    _write_genome_bam(path, _uniform_reads(np.random.RandomState(100 + seed),
                                           n_reads, sort=True))


def exome_bed(path: str, n_bed: int) -> None:
    """``n_bed`` regions of 150-300 bp over the genome (seed 5), sorted;
    reused when it exists."""
    if os.path.exists(path):
        return
    rng = np.random.RandomState(5)
    tid = np.sort(rng.randint(0, len(GENOME), n_bed))
    ln = np.array([g[1] for g in GENOME])[tid]
    start = (rng.rand(n_bed) * (ln - 400)).astype(np.int64)
    end = start + rng.randint(150, 301, n_bed)
    order = np.lexsort((start, tid))
    with open(path + ".tmp", "w") as fh:
        for k in order:
            fh.write(f"{GENOME[tid[k]][0]}\t{start[k]}\t{end[k]}\n")
    os.replace(path + ".tmp", path)


def paf_file(path: str, n_lines: int) -> None:
    """bench3gb.py's PAF (``_write_paf_fixture``): ``n_lines`` lines of
    ``cg:Z:150M`` over the genome, seed 5."""
    rng = np.random.RandomState(5)
    names = [g[0] for g in GENOME]
    length = GENOME[0][1]
    tid = rng.randint(0, len(GENOME), n_lines)
    pos = rng.randint(0, length - 200, n_lines)
    mapq = rng.choice([0, 10, 30, 60], n_lines)
    with open(path + ".tmp", "w", buffering=1 << 22) as fh:
        chunk = 200_000
        for i in range(0, n_lines, chunk):
            rows = [f"r\t150\t0\t150\t+\t{names[t]}\t{length}\t{p}\t"
                    f"{p + 150}\t150\t150\t{q}\tcg:Z:150M"
                    for t, p, q in zip(tid[i:i + chunk], pos[i:i + chunk],
                                       mapq[i:i + chunk])]
            fh.write("\n".join(rows) + "\n")
    os.replace(path + ".tmp", path)
