"""Seeded synthetic read batches for checking the CIGAR extraction
(``extract_events``) against its twins: the port's tests and
``chip_smoke.py`` build their batches here. numpy only.
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
