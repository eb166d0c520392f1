"""The port's CoverageEngine (device="cpu", the kernels' plain twins)
against pandepth_tpu.device.engine.CoverageEngine on the same feeds.

Tolerance: exact equality of SegmentStats (all arithmetic is integer).
The port does not pad events or queries, so engines are compared by
their answers, not their padded state.
"""

import numpy as np
import pytest

from pandepth_tpu.device.engine import CoverageEngine as JaxEngine
from pandepth_tpu.device.hosteval import WRAP18_MASK
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu_torch.device.engine import CoverageEngine
from pandepth_tpu_torch.synth import make_batch

# contig lengths per tier: int32 below 2 Gb, uint32 to 4 Gb, int64 above
LAYOUTS = {"int32": [5000, 3200, 700],
           "uint32": [1_900_000_000, 1_500_000_000],
           "int64": [3_000_000_000, 2_500_000_000]}


def _engines(tier, **kw):
    lay = GenomeLayout(np.array(LAYOUTS[tier], np.int64))
    port = CoverageEngine(lay, device="cpu", **kw)
    ref = JaxEngine(lay, **kw)
    assert port.pos_dtype is ref.pos_dtype
    assert port.pos_dtype.__name__ == tier
    return lay, port, ref


def _segments(lay, n, seed):
    rng = np.random.RandomState(seed)
    tid = rng.randint(0, lay.n_targets, n)
    ln = lay.lengths[tid]
    s1 = (rng.rand(n) * (ln + 40)).astype(np.int64) + 1
    e1 = s1 + rng.randint(0, 5000, n)
    # whole contigs and overhangs past the contig end too
    tid = np.concatenate([tid, np.arange(lay.n_targets)])
    s1 = np.concatenate([s1, np.ones(lay.n_targets, np.int64)])
    e1 = np.concatenate([e1, lay.lengths + 300])
    return tid.astype(np.int32), s1, e1


def _feed(lay, engines, seed, n=3000):
    """The same start/end pairs, padded native-style batches and
    intervals into every engine."""
    rng = np.random.RandomState(seed)
    tid = rng.randint(0, lay.n_targets, n)
    ln = lay.lengths[tid]
    s0 = (rng.rand(n) * ln).astype(np.int64)
    e0 = s0 + rng.randint(1, 400, n)
    s0[: n // 10] = s0[0]  # a pileup of duplicates
    e0[: n // 10] = s0[0] + 150
    tid[: n // 10] = tid[0]
    gs = lay.offsets[tid] + s0
    ge = np.minimum(lay.offsets[tid] + e0, lay.limits[tid])
    third = n // 3
    for eng in engines:
        eng.add_start_end(gs[:third], ge[:third])
        # a native-style window: pos_dtype buffer with a sentinel tail
        pad = np.full(2 * third + 50, eng.pos_sentinel, np.int64)
        pe = pad.copy()
        pad[: third] = gs[third: 2 * third]
        pe[: third] = ge[third: 2 * third]
        eng.add_padded_events(pad.astype(eng.pos_dtype),
                              pe.astype(eng.pos_dtype))
        eng.add_intervals(tid[2 * third:], s0[2 * third:], e0[2 * third:])


def _assert_stats_equal(a, b):
    np.testing.assert_array_equal(a.cover, b.cover)
    np.testing.assert_array_equal(a.depth_sum, b.depth_sum)


@pytest.mark.parametrize("wrap18", [False, True])
@pytest.mark.parametrize("tier", sorted(LAYOUTS))
def test_segment_stats_matches_jax(tier, wrap18):
    lay, port, ref = _engines(tier, wrap18=wrap18)
    _feed(lay, (port, ref), seed=21)
    seg = _segments(lay, 300, seed=22)
    _assert_stats_equal(port.segment_stats(*seg), ref.segment_stats(*seg))


@pytest.mark.parametrize("tier", sorted(LAYOUTS))
def test_min_dep_and_kept_state_match_jax(tier):
    """min_dep=3, then a second query batch off the kept state, chunked
    smaller than the batch."""
    lay, port, ref = _engines(tier, min_dep=3)
    _feed(lay, (port, ref), seed=31)
    seg = _segments(lay, 200, seed=32)
    _assert_stats_equal(port.segment_stats(*seg, keep_state=True),
                        ref.segment_stats(*seg, keep_state=True))
    seg2 = _segments(lay, 500, seed=33)
    _assert_stats_equal(port.segment_stats(*seg2, chunk=128),
                        ref.segment_stats(*seg2, chunk=128))


def test_add_events_clamp_matches_jax():
    """Pre-built events, some at the int64 SENTINEL, clamp to the tier's
    sentinel in both engines (uint32 tier)."""
    lay, port, ref = _engines("uint32")
    rng = np.random.RandomState(41)
    pos = rng.randint(0, lay.total, 400).astype(np.int64)
    pos[-20:] = 1 << 62
    delta = np.where(np.arange(400) % 2 == 0, 1, -1).astype(np.int32)
    for eng in (port, ref):
        eng.add_events(pos, delta)
    seg = _segments(lay, 100, seed=42)
    _assert_stats_equal(port.segment_stats(*seg), ref.segment_stats(*seg))


def test_flush_threshold_matches_jax(monkeypatch):
    """Several staged flushes (several device chunks) finalize the same."""
    monkeypatch.setenv("PANDEPTH_FLUSH_EVENTS", "700")
    lay, port, ref = _engines("int32")
    _feed(lay, (port, ref), seed=51)
    assert len(port._chunks) > 1
    seg = _segments(lay, 100, seed=52)
    _assert_stats_equal(port.segment_stats(*seg), ref.segment_stats(*seg))


def test_wrap18_pileup():
    """Depth past 18 bits wraps like the reference's SiteInfo cells."""
    lay = GenomeLayout(np.array([100]))
    port = CoverageEngine(lay, wrap18=True, device="cpu")
    ref = JaxEngine(lay, wrap18=True)
    n = WRAP18_MASK + 5
    args = (np.zeros(n, np.int32), np.full(n, 10, np.int64),
            np.full(n, 20, np.int64))
    port.add_intervals(*args)
    ref.add_intervals(*args)
    seg = (np.array([0], np.int32), np.array([1]), np.array([100]))
    st = port.segment_stats(*seg)
    assert st.cover[0] == 10
    assert st.depth_sum[0] == 10 * (n & WRAP18_MASK)
    _assert_stats_equal(st, ref.segment_stats(*seg))


@pytest.mark.parametrize("tier", sorted(LAYOUTS))
def test_add_batch_matches_jax(tier):
    """Read batches (the CIGAR feed) mixed with native-style pairs, the
    batch filters applied by the engine (min_mapq=20, default -x)."""
    lay, port, ref = _engines(tier, min_mapq=20)
    batches = [make_batch(lay.lengths, n, seed=60 + n) for n in (500, 1)]
    batches.append(make_batch(lay.lengths, 40, seed=62, max_ops=0))
    for eng in (port, ref):
        eng.add_batch(batches[0])
    _feed(lay, (port, ref), seed=63, n=600)
    for eng in (port, ref):
        for b in batches[1:]:
            eng.add_batch(b)
    assert port.n_reads_seen == ref.n_reads_seen == 541
    seg = _segments(lay, 300, seed=64)
    _assert_stats_equal(port.segment_stats(*seg), ref.segment_stats(*seg))


def test_empty_engine():
    lay = GenomeLayout(np.array([50, 60]))
    st = CoverageEngine(lay, device="cpu").segment_stats(
        np.array([0, 1], np.int32), np.array([1, 10]), np.array([50, 20]))
    np.testing.assert_array_equal(st.cover, [0, 0])
    np.testing.assert_array_equal(st.depth_sum, [0, 0])


@pytest.mark.parametrize("tier", sorted(LAYOUTS))
def test_engine_surface(tier, monkeypatch):
    """What the shared run helpers read; PANDEPTH_ENC elects encoded
    windows as in the JAX engine, and the encoder's window sizes are the
    JAX engine's."""
    monkeypatch.setenv("PANDEPTH_ENC", "1")
    lay, port, ref = _engines(tier)
    assert port.wants_padded_events
    assert port.wants_encoded_windows is True is ref.wants_encoded_windows
    assert (port.enc_cap, port.enc_exc, port.enc_block) == \
        (ref.enc_cap, ref.enc_exc, ref.enc_block)
    assert port.pos_sentinel == ref.pos_sentinel
    assert port.pos_sentinel32 == ref.pos_sentinel32
    assert port.pos_bits32 == ref.pos_bits32
    assert port.keep_state and port.n_reads_seen == 0
