"""Seeded synthetic inputs for checking kernels against their twins:
read batches for the CIGAR extraction (``extract_events``) and encoded
event windows for their decode (``decode_enc``). The port's tests and
``chip_smoke.py`` build theirs here. numpy only.
"""

from __future__ import annotations

import numpy as np

from pandepth_tpu.device.hosteval import pad_pow2
from pandepth_tpu.io.bam import ReadBatch

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
