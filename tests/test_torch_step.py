"""The port's boundary evaluation and fused coverage step
(pandepth_tpu_torch/device/{sweep,step}.py) against
pandepth_tpu.device.sweep.eval_boundaries and
pandepth_tpu.device.step.coverage_step on the same numpy-seeded inputs,
on the CPU, where the port runs the plain twins of its CUDA kernels.

Tolerance: exact equality. All of the arithmetic is integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandepth_tpu.device import sweep as jsweep
from pandepth_tpu.device.hosteval import WRAP18_MASK
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.device.step import coverage_step as jax_step
from pandepth_tpu.io.bam import ReadBatch
from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.step import coverage_step
from pandepth_tpu_torch.synth import make_batch

from tests.test_torch_events import COLS

CONTIGS = [5000, 3200, 700]


def _events(np_dt, n, seed, span):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, span - 500, n).astype(np.int64)
    s[: n // 8] = s[0]
    e = s + rng.randint(0, 300, n)
    sent = int(np.iinfo(np_dt).max)
    pos = np.concatenate([s, e, np.full(31, sent, np.int64)])
    delta = np.concatenate([np.ones(n), -np.ones(n),
                            np.zeros(31)]).astype(np.int32)
    perm = rng.permutation(pos.shape[0])
    return pos[perm].astype(np_dt), delta[perm]


@pytest.mark.parametrize("min_dep", [1, 3])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64],
                         ids=["int32", "int64"])
def test_eval_boundaries_matches_jax(np_dt, min_dep):
    span = 2_000_000_000 if np_dt is np.int32 else 17_000_000_000
    pos, delta = _events(np_dt, 1500, seed=1, span=span)
    js = jsweep.sort_events(jnp.asarray(pos), jnp.asarray(delta),
                            min_dep=min_dep)
    rng = np.random.RandomState(2)
    x = rng.randint(0, span, 500).astype(np.int64)
    x[:40] = pos[:40]                             # on event positions
    x[-3:] = [0, span, np.iinfo(np_dt).max - 1]   # before and past all
    x = x.astype(np_dt)
    jq = jsweep.eval_boundaries(*js[:4], jnp.int32(min_dep),
                                jnp.asarray(x))
    st = sweep.sort_events(torch.from_numpy(pos), torch.from_numpy(delta),
                           min_dep=min_dep)
    q = sweep.eval_boundaries(*st[:4], min_dep, torch.from_numpy(x))
    assert [t.dtype for t in q] == [torch.int64, torch.int64]
    for j, p in zip(jq, q):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


def _pileup(b: ReadBatch, depth: int) -> ReadBatch:
    """``b`` plus ``depth`` single-op 50M reads at chr1:1000, appended
    after b's rows (op_read stays non-decreasing)."""
    n = b.n_reads
    one = np.ones(depth, np.int32)
    return ReadBatch(
        tid=np.concatenate([b.tid, 0 * one]),
        pos=np.concatenate([b.pos, 1000 * one]),
        flag=np.concatenate([b.flag, 0 * one]),
        mapq=np.concatenate([b.mapq, 60 * one]),
        n_ops=np.concatenate([b.n_ops, one]),
        op_code=np.concatenate([b.op_code, 0 * one]),
        op_len=np.concatenate([b.op_len, 50 * one]),
        op_read=np.concatenate([b.op_read,
                                np.arange(n, n + depth, dtype=np.int32)]))


@pytest.mark.parametrize("wrap18", [False, True])
@pytest.mark.parametrize("min_dep", [1, 3])
def test_coverage_step_matches_jax(min_dep, wrap18):
    lay = GenomeLayout(np.array(CONTIGS))
    b = make_batch(lay.lengths, 900, seed=11)
    if wrap18:  # depth past 18 bits: the mask changes the answer
        b = _pileup(b, WRAP18_MASK + 10)
    rng = np.random.RandomState(12)
    tid = rng.randint(0, 3, 200)
    lo = lay.offsets[tid] + rng.randint(0, 5000, 200) % lay.lengths[tid]
    hi = np.minimum(lo + rng.randint(0, 2000, 200), lay.limits[tid])
    lo = np.concatenate([lo, lay.offsets]).astype(np.int64)
    hi = np.concatenate([hi, lay.limits]).astype(np.int64)
    kw = dict(flags_mask=1796, min_mapq=20, min_dep=min_dep, wrap18=wrap18)
    jcov, jsum = jax_step(*(jnp.asarray(getattr(b, c)) for c in COLS),
                          jnp.asarray(lay.offsets), jnp.asarray(lay.limits),
                          jnp.asarray(lo), jnp.asarray(hi), **kw)
    cov, dsum = coverage_step(*(torch.from_numpy(getattr(b, c))
                                for c in COLS),
                              torch.from_numpy(lay.offsets),
                              torch.from_numpy(lay.limits),
                              torch.from_numpy(lo), torch.from_numpy(hi),
                              **kw)
    np.testing.assert_array_equal(np.asarray(jcov), cov.numpy())
    np.testing.assert_array_equal(np.asarray(jsum), dsum.numpy())
    assert cov.numpy().any()

