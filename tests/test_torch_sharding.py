"""The port's ShardedCoverageEngine (K9) with ``devices=["cpu"] * n`` (the
plain twins of ``shard_carry`` and ``eval_pair_rows``, K2's twin on each
row) against pandepth_tpu's ShardedCoverageEngine on
``jax.devices()[:n]``, fed the same numpy-seeded events, for n in
{1, 2, 4, 8}, every position tier (int32, uint32 beyond 2 Gb, int64
beyond 4 Gb, few events), wrap18 on and off and min_dep 1 and 2: the
bucketed rows, ``segment_stats`` (the first chunk's finalize and the
later chunks' clipped eval) and every row's sweep state; and each
kernel's twin against the JAX program it replaces.

Tolerance: none, every output is array-equal (all arithmetic is integer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import ReadBatch
from pandepth_tpu.sharding.engine import ShardedCoverageEngine as JaxSharded
from pandepth_tpu.sharding.engine import _flat_mesh, _sharded_steps
from pandepth_tpu_torch import synth
from pandepth_tpu_torch.device.convert import positions_to_words
from pandepth_tpu_torch.device import kernels
from pandepth_tpu_torch.sharding import steps
from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine

TIERS = {"int32": [7000, 4000, 900],
         "uint32": [1_500_000_000, 1_000_000_000],
         "int64": [3_000_000_000, 2_000_000_000]}


def _segments(lay):
    """Per contig: the whole contig (it straddles range cuts), its first
    half, a short segment inside one range, and a zero-length one."""
    nt = lay.n_targets
    seg_tid = np.repeat(np.arange(nt, dtype=np.int32), 4)
    ln = lay.lengths
    seg_start = np.tile(np.array([1, 11, 500, 20], np.int64), nt)
    seg_end = np.stack([ln, ln // 2, np.full(nt, 600), np.full(nt, 19)],
                       1).ravel()
    return seg_tid, seg_start, seg_end


def _feed(engines, lay, seed, hot):
    """The same events into every engine: random intervals over every
    contig and a read batch through add_batch (the JAX package's
    ReadBatch, which the port takes as it is); with ``hot``, every
    interval in the first 700 cells (row 0, the other rows empty but the
    last), deltas whose carry passes int32, and an event at the end of
    the axis, which lands in the last row."""
    rng = np.random.RandomState(seed)
    m = 300
    if hot:
        tid = np.zeros(m, np.int64)
        s = rng.randint(0, 100, m).astype(np.int64)
    else:
        tid = rng.randint(0, lay.n_targets, m)
        s = (rng.rand(m) * lay.lengths[tid]).astype(np.int64)
    e = s + rng.randint(1, 600, m)
    n = 40
    btid = rng.randint(0, lay.n_targets, n).astype(np.int32)
    if hot:
        btid[:] = 0
    bpos = rng.randint(0, 100 if hot else 5000, n).astype(np.int32)
    batch = ReadBatch(tid=btid, pos=bpos,
                      flag=np.where(rng.rand(n) < 0.2, 1024, 0).astype(
                          np.int32),
                      mapq=rng.randint(0, 61, n).astype(np.int32),
                      n_ops=np.full(n, 2, np.int32),
                      op_code=np.tile(np.array([0, 2], np.int32), n),
                      op_len=rng.randint(1, 90, 2 * n).astype(np.int32),
                      op_read=np.repeat(np.arange(n, dtype=np.int32), 2))
    for eng in engines:
        eng.add_intervals(tid, s, e)
        eng.add_batch(batch)
        if hot:
            eng.add_events(np.array([30, 31, 40, lay.total], np.int64),
                           np.array([1 << 30, 1 << 30, 1 << 30, 1],
                                    np.int32))


def _port_state(eng):
    """The port's per-row state (pos_s2, depth2, c_cov2, c_sum2), every
    block's rows stacked, as int64 numpy."""
    return [torch.cat([blk.state[k] for blk in eng._blocks]).numpy().astype(
        np.int64) for k in range(4)]


def _assert_same_state(port, ref):
    for p, j in zip(_port_state(port), ref._state):
        j = np.asarray(j)
        assert p.shape == j.shape
        np.testing.assert_array_equal(p, j.astype(np.int64))


def _engines(tier, n, wrap18, min_dep, devices=None):
    lay = GenomeLayout(np.asarray(TIERS[tier], np.int64))
    kw = dict(min_mapq=20, min_dep=min_dep, wrap18=wrap18)
    return (lay, ShardedCoverageEngine(lay, devices=devices or ["cpu"] * n,
                                       **kw),
            JaxSharded(lay, devices=jax.devices()[:n], **kw))


def _check(lay, port, ref, chunk):
    segs = _segments(lay)
    pr, jr = port._bucketed(), ref._bucketed()
    for p, j in zip(pr, jr):      # slot 0 is the carry's
        np.testing.assert_array_equal(p[:, 1:], j)
    a = ref.segment_stats(*segs, chunk=chunk)
    b = port.segment_stats(*segs, chunk=chunk)
    np.testing.assert_array_equal(b.cover, a.cover)
    np.testing.assert_array_equal(b.depth_sum, a.depth_sum)
    assert np.asarray(ref._state[1]).any()   # not all depth 0
    _assert_same_state(port, ref)


@pytest.mark.parametrize("wrap18,min_dep", [(False, 1), (True, 2)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("tier", list(TIERS))
def test_sharded_engine_matches_jax(tier, n, wrap18, min_dep):
    """Random events over every contig; then a second segment_stats in
    chunks of 3, which runs the clipped eval alone on the kept state."""
    lay, port, ref = _engines(tier, n, wrap18, min_dep)
    assert port.pos_dtype is ref.pos_dtype
    _feed((port, ref), lay, seed=n, hot=False)
    _check(lay, port, ref, chunk=1 << 20)
    state = [blk.state for blk in port._blocks]
    segs = _segments(lay)
    a = ref.segment_stats(*segs, chunk=3)
    b = port.segment_stats(*segs, chunk=3)
    assert [blk.state for blk in port._blocks] == state  # not refinalized
    np.testing.assert_array_equal(b.cover, a.cover)
    np.testing.assert_array_equal(b.depth_sum, a.depth_sum)


@pytest.mark.parametrize("wrap18,min_dep", [(False, 1), (True, 2)])
@pytest.mark.parametrize("tier", list(TIERS))
def test_hot_range_empty_rows_and_wide_carry(tier, wrap18, min_dep):
    """Every event in row 0 (a hot range), the rows between empty (only
    their carry), a carry past int32 that wraps as JAX's astype(int32),
    an event at bounds[-1]; finalized in chunks of 5 from the start."""
    lay, port, ref = _engines(tier, 8, wrap18, min_dep)
    _feed((port, ref), lay, seed=3, hot=True)
    counts = [int((r[1:] != 0).sum()) for r in port._bucketed()[1]]
    assert counts[0] > 0 and counts[-1] == 1 and not any(counts[1:-1])
    _check(lay, port, ref, chunk=5)
    carry = _port_state(port)[1][:, 0]     # depth after each row's carry
    assert carry.min() < 0 or wrap18       # the int32 carry wrapped


def test_rows_in_two_blocks_match_jax():
    """Four rows on one device and four on another (here two names of the
    CPU): the second block's carry starts from the first block's totals,
    copied over as JAX all-gathers them."""
    lay, port, ref = _engines("int32", 8, False, 1,
                              devices=["cpu"] * 4 + ["cpu:0"] * 4)
    assert [b.rows for b in port._blocks] == [4, 4]
    _feed((port, ref), lay, seed=7, hot=True)
    _feed((port, ref), lay, seed=8, hot=False)
    _check(lay, port, ref, chunk=1 << 20)


@pytest.mark.parametrize("tier", list(TIERS))
def test_kernel_twins_match_jax_programs(tier):
    """The twins against JAX's two shard_map programs on the same inputs:
    shard_carry's twin, then the rows' sort and K2 twin, against
    ``finalize``'s state; eval_pair_rows' twin on JAX's own state against
    ``eval_only``."""
    n, wrap18, min_dep = 4, True, 1
    lay, port, ref = _engines(tier, n, wrap18, min_dep)
    _feed((port, ref), lay, seed=11, hot=False)
    lo, hi = port.segment_bounds(*_segments(lay))
    fin, ev = _sharded_steps(ref.mesh, n, min_dep, wrap18, "scan_unrolled")
    bounds = jnp.asarray(ref.bounds)
    pos2d, delta2d = ref._bucketed()
    jout = fin(pos2d, delta2d, bounds, jnp.asarray(lo), jnp.asarray(hi))
    jstate = [np.asarray(x) for x in jout[2:6]]

    prow, drow = port._bucketed()
    p2 = torch.from_numpy(prow.astype(np.int64) if tier == "uint32"
                          else prow)
    d2 = torch.from_numpy(drow)
    tb = torch.from_numpy(ref.bounds)
    steps.shard_carry_reference(p2, d2, tb, torch.zeros(0, dtype=torch.int64))
    state = steps.sort_scan_rows(p2, d2, min_dep, wrap18, port.pos_sentinel)
    for p, j in zip(state, jstate):
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      j.astype(np.int64))

    j_state = [torch.from_numpy(np.array(j, j.dtype if j.dtype != np.uint32
                                         else np.int64)) for j in jstate]
    want = ev(*jout[2:6], bounds, jnp.asarray(lo), jnp.asarray(hi))
    got = steps.eval_pair_rows_reference(*j_state, tb, min_dep,
                                         torch.from_numpy(lo),
                                         torch.from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("tier", list(TIERS))
def test_eval_pair_rows_edges_match_jax_programs(tier, hot):
    """eval_pair_rows' twin on JAX's own state against ``finalize`` and
    ``eval_only`` at ``synth.rows_edge_segments`` over 8 rows (segments
    crossing no row, one, two and every row; clips on a range's ends;
    reversed ones); with ``hot``, the rows between the first and the last
    hold no event."""
    n, min_dep = 8, 1
    lay, port, ref = _engines(tier, n, False, min_dep)
    _feed((port, ref), lay, seed=13, hot=hot)
    lo, hi = synth.rows_edge_segments(ref.bounds, seed=2)
    fin, ev = _sharded_steps(ref.mesh, n, min_dep, False, "scan_unrolled")
    bounds = jnp.asarray(ref.bounds)
    jout = fin(*ref._bucketed(), bounds, jnp.asarray(lo), jnp.asarray(hi))
    state = [torch.from_numpy(np.asarray(j).astype(np.int64)
                              if np.asarray(j).dtype == np.uint32
                              else np.array(j)) for j in jout[2:6]]
    if hot:
        counts = [int((r[1:] != 0).sum()) for r in port._bucketed()[1]]
        assert counts[0] > 0 and not any(counts[1:-1])
    want = ev(*jout[2:6], bounds, jnp.asarray(lo), jnp.asarray(hi))
    got = steps.eval_pair_rows_reference(*state, torch.from_numpy(ref.bounds),
                                         min_dep, torch.from_numpy(lo),
                                         torch.from_numpy(hi))
    for g, w, f in zip(got, want, jout[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(f))


def test_rows_edge_segments_reach_their_edges():
    """``synth.rows_edge_segments`` has segments crossing 0, 1, 2 and
    every row, segments with an end on a cut, and reversed ones."""
    for lengths in TIERS.values():
        b = GenomeLayout(np.asarray(lengths, np.int64)).shard_bounds(8)
        lo, hi = synth.rows_edge_segments(b, seed=2)
        crossed = sum((np.clip(lo, b[r], b[r + 1]) != np.clip(hi, b[r],
                                                                b[r + 1]))
                      .astype(int) for r in range(8))
        assert {0, 1, 2, 8} <= set(crossed.tolist())
        assert np.isin(lo, b).any() and np.isin(hi, b).any()
        assert (lo > hi).any()


CARRY_EDGES = synth.carry_edge_blocks(seed=8)


def _jax_carry(payload: np.ndarray, left: np.ndarray):
    """pandepth_tpu/sharding/engine.py:88-93 on each row of a block whose
    rows follow ``left``'s on earlier devices: the row's delta total
    (``total``), every device's totals (``sums``, JAX's all_gather), and
    the sum of those left of the row cast to int32 (``carry``). Returns
    (totals, carries)."""
    totals = jnp.sum(jnp.asarray(payload), axis=1, dtype=jnp.int64)
    sums = jnp.concatenate([jnp.asarray(left, jnp.int64), totals])
    n_dev = sums.shape[0]

    def carry(rid):
        return jnp.sum(jnp.where(jnp.arange(n_dev) < rid, sums,
                                 0)).astype(jnp.int32)

    rids = left.shape[0] + jnp.arange(payload.shape[0])
    return totals, jax.lax.map(carry, rids, batch_size=256)


@pytest.mark.parametrize("case", range(len(CARRY_EDGES)),
                         ids=[f"{k}-{c[0]}" for k, c in
                              enumerate(CARRY_EDGES)])
def test_shard_carry_edges_match_jax(case):
    """shard_carry's twin (the CPU's route of ``steps.shard_carry``) on
    ``synth.carry_edge_blocks`` (the cases chip_smoke.py holds the kernel
    to its twin on) against JAX's carry expressions: the totals, every
    row's slot 0 (the carry cast to int32, the range's start) and the
    rest of the block untouched. Where the CPU mesh has a device a row and
    nothing lies to the left, also against JAX's ``finalize``: the sweep
    state after the rows' sort and scans."""
    _, pos, delta, pos_dt, bounds, left = CARRY_EDGES[case]
    rows = pos.shape[0]
    p2 = torch.from_numpy(positions_to_words(pos, pos_dt))
    d2 = torch.from_numpy(delta.copy())
    totals = steps.shard_carry(p2, d2, torch.from_numpy(bounds),
                               torch.from_numpy(left))
    jt, jc = _jax_carry(delta[:, 1:], left)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(d2[:, 0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        p2[:, 0].numpy(), positions_to_words(bounds[:rows], pos_dt))
    np.testing.assert_array_equal(d2[:, 1:].numpy(), delta[:, 1:])
    np.testing.assert_array_equal(p2[:, 1:].numpy(),
                                  positions_to_words(pos[:, 1:], pos_dt))
    if rows > len(jax.devices()) or left.size:
        return
    fin, _ = _sharded_steps(_flat_mesh(tuple(jax.devices()[:rows])), rows, 1,
                            False, "scan_unrolled")
    seg = jnp.asarray(bounds[[0, -1]])
    jout = fin(jnp.asarray(pos[:, 1:].astype(pos_dt)),
               jnp.asarray(delta[:, 1:]), jnp.asarray(bounds), seg[:1],
               seg[1:])
    state = steps.sort_scan_rows(p2, d2, 1, False, int(np.iinfo(pos_dt).max))
    for p, j in zip(state, jout[2:6]):
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      np.asarray(j).astype(np.int64))


def test_carry_edge_blocks_reach_their_edges():
    """``synth.carry_edge_blocks`` has row payloads of 1, a run - 1, a
    run, a run + 1 and a few runs of the kernel's blocks, 1, 8, 37 and
    more than 65,535 rows, an all-zero row, a carry that passes 2^31 at a
    row edge, non-empty and empty ``left``, on both 32-bit tiers."""
    t = synth.CARRY_RUN
    payloads, rows, tiers, lefts = set(), set(), set(), set()
    zero_row = crossing = False
    for _, pos, delta, pos_dt, bounds, left in CARRY_EDGES:
        payloads.add(delta.shape[1] - 1)
        rows.add(delta.shape[0])
        tiers.add(pos_dt)
        lefts.add(left.size > 0)
        totals = delta[:, 1:].sum(1, dtype=np.int64)
        zero_row |= bool((~delta[:, 1:].any(1)).any())
        carry = left.sum() + np.cumsum(totals) - totals
        crossing |= bool(((carry[:-1] < 1 << 31)
                          & (carry[1:] >= 1 << 31)).any())
        assert bounds.shape[0] == delta.shape[0] + 1
        assert (np.diff(bounds) >= 0).all()
    assert {1, t - 1, t, t + 1, 3 * t + 5} <= payloads
    assert {1, 8, 37} <= rows and max(rows) > 65_535
    assert tiers == {np.int32, np.uint32} and lefts == {False, True}
    assert zero_row and crossing


def test_range_cuts_must_not_decrease():
    """The eval_pair_rows kernel searches the range cuts, so the host
    refuses decreasing cuts where they are made or handed in; equal
    neighbours (an empty range) pass."""
    lay = GenomeLayout(np.array([5000, 700], np.int64))
    cuts = lay.shard_bounds(8)
    assert steps.check_cuts(cuts) is cuts
    assert steps.check_cuts([0, 10, 10, 20]) == [0, 10, 10, 20]
    with pytest.raises(ValueError, match="non-decreasing"):
        steps.check_cuts([0, 20, 10, 30])
    eng = ShardedCoverageEngine(lay, devices=["cpu"] * 3)
    assert (np.diff(eng.bounds) >= 0).all()


def test_kernels_take_no_cpu_tensors():
    """The K9 kernels' wrappers launch on CUDA tensors or raise; the CPU
    runs the twins only through ``steps``."""
    p2 = torch.zeros((2, 5), dtype=torch.int32)
    d2 = torch.zeros((2, 5), dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.shard_carry(p2, d2, b, torch.zeros(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        c2 = torch.zeros((2, 5), dtype=torch.int64)
        kernels.eval_pair_rows(p2, d2, c2, c2, b, 1, b[:1], b[:1])
