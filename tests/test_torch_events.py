"""The port's CIGAR extraction (pandepth_tpu_torch/device/events.py)
against pandepth_tpu.device.events.extract_events on the same
numpy-seeded batches, on the CPU, where the port runs the plain twin of
its CUDA kernel.

Tolerance: exact equality. All of the arithmetic is integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandepth_tpu.device.events import SENTINEL
from pandepth_tpu.device.events import extract_events as jax_extract
from pandepth_tpu.device.hosteval import host_extract_events, pos_dtype_for
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import ReadBatch
from pandepth_tpu_torch.device import events
from pandepth_tpu_torch.device.convert import device_pos_dtype
from pandepth_tpu_torch.synth import jax_padded, make_batch

# contig lengths per position tier
LAYOUTS = {"int32": [5000, 3200, 700],
           "uint32": [1_900_000_000, 1_500_000_000],
           "int64": [3_000_000_000, 2_500_000_000]}

COLS = ("tid", "pos", "flag", "mapq", "op_code", "op_len", "op_read")


def run_jax(b: ReadBatch, lay: GenomeLayout, min_mapq: int,
            flags_mask: int = 1796):
    out = jax_extract(*(jnp.asarray(getattr(b, c)) for c in COLS),
                      jnp.asarray(lay.offsets), jnp.asarray(lay.limits),
                      flags_mask=flags_mask, min_mapq=min_mapq)
    return tuple(np.asarray(a) for a in out)


def run_port(b: ReadBatch, lay: GenomeLayout, min_mapq: int,
             flags_mask: int = 1796, **tier):
    out = events.extract_events(
        *(torch.from_numpy(getattr(b, c)) for c in COLS),
        torch.from_numpy(lay.offsets), torch.from_numpy(lay.limits),
        flags_mask, min_mapq, **tier)
    return tuple(a.numpy() for a in out)


def _assert_same(want, got):
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.parametrize("padded", [False, True], ids=["bare", "jax_pad"])
@pytest.mark.parametrize("min_mapq", [-1, 0, 20])
def test_extract_events_matches_jax(min_mapq, padded):
    lay = GenomeLayout(np.array(LAYOUTS["int32"]))
    b = make_batch(lay.lengths, 700, seed=3)
    if padded:
        b = jax_padded(b)
    want = run_jax(b, lay, min_mapq)
    got = run_port(b, lay, min_mapq)
    _assert_same(want, got)
    live = got[1][: b.n_total_ops] != 0
    assert live.any() and not live.all()


def test_extract_events_flag_mask_matches_jax():
    """Another -x mask keeps secondary and duplicate reads."""
    lay = GenomeLayout(np.array(LAYOUTS["int32"]))
    b = make_batch(lay.lengths, 500, seed=4)
    _assert_same(run_jax(b, lay, 10, flags_mask=4),
                 run_port(b, lay, 10, flags_mask=4))


def test_extract_events_long_cigar_matches_jax():
    """One read owns 70,000 ops (past the BAM's 65,535 CIGAR cap, as a
    long-CIGAR read decodes), JAX-padded."""
    lay = GenomeLayout(np.array(LAYOUTS["int32"]))
    b = jax_padded(make_batch(lay.lengths, 300, seed=5,
                              long_read_ops=70_000))
    _assert_same(run_jax(b, lay, -1), run_port(b, lay, -1))


@pytest.mark.parametrize("tier", sorted(LAYOUTS))
def test_extract_events_engine_tier_matches_jax(tier):
    """With the tier's sentinel and device dtype: JAX's extraction
    followed by add_batch's clamp-and-cast."""
    lay = GenomeLayout(np.array(LAYOUTS[tier], np.int64))
    np_dt = pos_dtype_for(lay.total)
    assert np.dtype(np_dt).name == tier
    sent = int(np.iinfo(np_dt).max)
    b = make_batch(lay.lengths, 600, seed=6)
    jpos, jdelta = run_jax(b, lay, 30)
    jpos = np.minimum(jpos, sent).astype(np_dt).astype(np.int64)
    pos, delta = run_port(b, lay, 30, sentinel=sent,
                          pos_dtype=device_pos_dtype(np_dt))
    assert pos.dtype == (np.int32 if tier == "int32" else np.int64)
    np.testing.assert_array_equal(jpos, pos.astype(np.int64))
    np.testing.assert_array_equal(jdelta, delta)


def test_extract_events_matches_host_twin():
    """The live events are pandepth_tpu.device.hosteval's numpy twin's, in
    op order."""
    lay = GenomeLayout(np.array(LAYOUTS["int32"]))
    b = make_batch(lay.lengths, 800, seed=7)
    pos, delta = run_port(b, lay, 1)
    m = b.n_total_ops
    hs, he = host_extract_events(b, lay.offsets, lay.limits, 1796, 1)
    np.testing.assert_array_equal(pos[:m][delta[:m] == 1], hs)
    np.testing.assert_array_equal(pos[m:][delta[m:] == -1], he)


def test_extract_events_no_ops():
    lay = GenomeLayout(np.array(LAYOUTS["int32"]))
    b = make_batch(lay.lengths, 5, seed=8, max_ops=0)
    assert b.n_total_ops == 0
    pos, delta = run_port(b, lay, -1)
    assert pos.shape == (0,) and delta.shape == (0,)
    # JAX pads the ops to 1024 dead slots
    jpos, jdelta = run_jax(jax_padded(b), lay, -1)
    assert (jpos == SENTINEL).all() and not jdelta.any()

