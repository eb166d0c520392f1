"""K2's sort in the port (``sweep.sort_pairs``; on the CPU the twin of
the ``sort_pairs`` kernel, the library's stable sort and a gather)
against the JAX package's ``jax.lax.sort_key_val``
(``pandepth_tpu/device/sweep.py:49``) and, row by row, its
``sort_events``, on the same numpy inputs (``synth.sort_edge_events``
and ``synth.sort_edge_rows``, which chip_smoke.py also holds the kernel
to on the card); the kernel's plan (``kernels.sort_plan``); and a numpy
emulation of the kernel's passes (its key transform, 8-bit digits, the
histograms of every digit from one read, a stable counting scatter a
pass, the words back) against JAX's order.

Tolerance: exact equality. Keys and values are integers, and the order
of equal positions (stability) is part of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pandepth_tpu.device import sweep as jsweep
from pandepth_tpu_torch import synth
from pandepth_tpu_torch.device import kernels, sweep
from pandepth_tpu_torch.device.convert import positions_to_words, tier_of
from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32
from pandepth_tpu_torch.sharding import steps

EDGES = synth.sort_edge_events(seed=3)
ROWS = synth.sort_edge_rows(seed=4)


def _words(pos: np.ndarray, pos_dt) -> torch.Tensor:
    """Positions of the tier as the port's device words."""
    return torch.from_numpy(positions_to_words(pos, pos_dt))


def _jax_sort(pos: np.ndarray, delta: np.ndarray, pos_dt):
    """JAX's sort_key_val, its keys as the port's words."""
    k, v = jax.lax.sort_key_val(jnp.asarray(pos.astype(pos_dt)),
                                jnp.asarray(delta))
    return positions_to_words(np.asarray(k), pos_dt), np.asarray(v)


def _emulate(words: np.ndarray, delta: np.ndarray, tier: int):
    """The kernel's sort in numpy: (words, deltas) out."""
    plan = kernels.sort_plan(tier, words.shape[0])
    mask = np.uint64(0xFFFFFFFF)
    if tier == TIER_I32:     # the sign bit flipped
        keys = (words.astype(np.int64).astype(np.uint64) & mask) \
            ^ np.uint64(1 << 31)
    elif tier == TIER_U32:   # the carrier's low word
        keys = words.astype(np.uint64) & mask
    else:                    # the sign bit flipped
        keys = words.view(np.uint64) ^ np.uint64(1 << 63)
    digits = [((keys >> np.uint64(8 * p)) & np.uint64(0xFF)).astype(np.int64)
              for p in range(plan["passes"])]
    # every pass's histogram from one read of the input's keys
    starts = [np.concatenate([[0], np.cumsum(np.bincount(d, minlength=256))
                              [:-1]]) for d in digits]
    k, v = keys, delta
    for p in range(plan["passes"]):
        dig = ((k >> np.uint64(8 * p)) & np.uint64(0xFF)).astype(np.int64)
        dest = np.empty(k.shape[0], np.int64)
        for val in np.unique(dig):   # input order within a value: stable
            at = np.flatnonzero(dig == val)
            dest[at] = starts[p][val] + np.arange(at.shape[0])
        nk, nv = np.empty_like(k), np.empty_like(v)
        nk[dest], nv[dest] = k, v
        k, v = nk, nv
    if tier == TIER_I32:
        out = (k ^ np.uint64(1 << 31)).astype(np.uint32).view(np.int32)
    elif tier == TIER_U32:
        out = k.astype(np.int64)
    else:
        out = (k ^ np.uint64(1 << 63)).view(np.int64)
    return out, v


@pytest.mark.parametrize("case", range(len(EDGES)),
                         ids=[c[0] for c in EDGES])
def test_sort_pairs_matches_jax(case):
    _, pos, delta, pos_dt = EDGES[case]
    want_pos, want_delta = _jax_sort(pos, delta, pos_dt)
    got_pos, got_delta = sweep.sort_pairs(_words(pos, pos_dt),
                                          torch.from_numpy(delta),
                                          int(np.iinfo(pos_dt).max))
    assert got_pos.dtype == _words(pos[:0], pos_dt).dtype
    assert np.array_equal(got_pos.numpy(), want_pos)
    assert np.array_equal(got_delta.numpy(), want_delta)


@pytest.mark.parametrize("case", range(len(EDGES)),
                         ids=[c[0] for c in EDGES])
def test_planned_passes_match_jax(case):
    """The kernel's passes, emulated, give JAX's order: the key transform
    the card runs (sign flip, the uint32 tier's low word), its digits and
    its stable scatters."""
    _, pos, delta, pos_dt = EDGES[case]
    got = _emulate(positions_to_words(pos, pos_dt), delta, tier_of(pos_dt))
    want = _jax_sort(pos, delta, pos_dt)
    assert got[0].dtype == want[0].dtype
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("min_dep,wrap18", [(1, False), (2, True)])
@pytest.mark.parametrize("case", range(len(ROWS)), ids=[c[0] for c in ROWS])
def test_sort_scan_rows_matches_jax_row_by_row(case, min_dep, wrap18):
    """K9's rows: each row sorted on its own (the row form) and scanned,
    against JAX's sort_key_val and sort_events on each row."""
    _, pos, delta, pos_dt = ROWS[case]
    pm = int(np.iinfo(pos_dt).max)
    p2, d2 = _words(pos.ravel(), pos_dt).reshape(pos.shape), \
        torch.from_numpy(delta)
    got_pos, got_delta = sweep.sort_pairs(p2, d2, pm)
    state = steps.sort_scan_rows(p2.clone(), d2.clone(), min_dep, wrap18, pm)
    for r in range(pos.shape[0]):
        want = _jax_sort(pos[r], delta[r], pos_dt)
        assert np.array_equal(got_pos[r].numpy(), want[0])
        assert np.array_equal(got_delta[r].numpy(), want[1])
        js = jsweep.sort_events(jnp.asarray(pos[r].astype(pos_dt)),
                                jnp.asarray(delta[r]), min_dep=min_dep,
                                wrap18=wrap18)
        assert np.array_equal(state[0][r].numpy(),
                              positions_to_words(np.asarray(js[0]), pos_dt))
        for k in (1, 2, 3):
            assert np.array_equal(state[k][r].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("tier,n,rows,plan", [
    # 15,199,506 events (the raw chr path's) in 3,711 tiles: 4 counter
    # words, 4 x 128 histogram words, 3,711 x 256 status words, then
    # 15,199,506 x (4 + 4) / 8 words of keys and deltas
    (TIER_U32, 15_199_506, 1,
     dict(key_bits=32, passes=4, tiles=3_711, zeroed_bytes=7_604_256,
          scratch_bytes=129_200_304)),
    (TIER_I32, 4097, 1,
     dict(key_bits=32, passes=4, tiles=2, zeroed_bytes=8_224,
          scratch_bytes=41_008)),
    # 8 rows of 2^21 + 1 slots: 513 tiles a row; 8 x 8 x 128 histogram
    # words; keys of 8 B
    (TIER_I64, 8 * ((1 << 21) + 1), 8,
     dict(key_bits=64, passes=8, tiles=4_104, zeroed_bytes=8_470_560,
          scratch_bytes=209_797_248)),
    (TIER_I64, 0, 1,
     dict(key_bits=64, passes=8, tiles=0, zeroed_bytes=8_224,
          scratch_bytes=8_224)),
])
def test_sort_plan(tier, n, rows, plan):
    assert kernels.sort_plan(tier, n, rows) == plan


@pytest.mark.parametrize("args", [(3, 10), (TIER_I32, 1 << 31),
                                  (TIER_U32, 8 << 31, 8), (TIER_I64, 7, 2),
                                  (TIER_I64, 8, 0)])
def test_sort_plan_refuses(args):
    with pytest.raises(ValueError, match="sort_pairs"):
        kernels.sort_plan(*args)


def test_sort_pairs_wrapper_refuses():
    """The kernel's wrapper raises on an unknown tier, a wrong rank, a
    wrong word and a CPU tensor; it launches nothing."""
    p = torch.tensor([5, 2, 9], dtype=torch.int32)
    d = torch.tensor([1, -1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="no position tier"):
        kernels.sort_pairs(p, d, 5)
    with pytest.raises(ValueError, match="rows"):
        kernels.sort_pairs(p.reshape(1, 1, 3), d.reshape(1, 1, 3), TIER_I32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernels.sort_pairs(p, d, TIER_I32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernels.sort_pairs(p.to(torch.int64), d, TIER_U32)
    assert kernels.launches["sort_pairs"] == 0


def test_sort_tile_is_the_kernels():
    assert synth.SORT_TILE == kernels.SORT_TILE
