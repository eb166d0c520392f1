"""The port's sweep functions (pandepth_tpu_torch/device/sweep.py)
against the JAX package's on the same numpy inputs, on the CPU, where the
port runs the plain PyTorch twins of its CUDA kernels.

Tolerance: exact equality. All of the arithmetic is integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandepth_tpu.device import sweep as jsweep
from pandepth_tpu.device.engine import _pack_events as jax_pack_events
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import ReadBatch
from pandepth_tpu_torch import synth
from pandepth_tpu_torch.device import convert, events, kernels, sweep
from pandepth_tpu_torch.device.engine import CoverageEngine

# tier -> (numpy position dtype, span of the positions drawn)
TIERS = {"int32": (np.int32, 2_000_000_000),
         "uint32": (np.uint32, 4_200_000_000),
         "int64": (np.int64, 17_000_000_000)}


def _sentinel(np_dt) -> int:
    return int(np.iinfo(np_dt).max)


def _pairs(tier: str, n: int, seed: int, tail: int = 0, pileup: int = 0):
    """(starts, ends) int64 global pairs with duplicate starts, an
    optional deep pileup at one spot, and ``tail`` sentinel slots."""
    np_dt, span = TIERS[tier]
    rng = np.random.RandomState(seed)
    s = rng.randint(0, span - 1000, n).astype(np.int64)
    s[: n // 8] = s[0]
    e = s + rng.randint(0, 300, n)
    mid = span // 2
    s = np.concatenate([s, np.full(pileup, mid, np.int64)])
    e = np.concatenate([e, np.full(pileup, mid + 41, np.int64)])
    sent = _sentinel(np_dt)
    s = np.concatenate([s, np.full(tail, sent, np.int64)])
    e = np.concatenate([e, np.full(tail, sent, np.int64)])
    return s, e


def _raw(a: np.ndarray, np_dt) -> torch.Tensor:
    """Positions as the raw words the port uploads (uint32 bit patterns
    as int32)."""
    words = np.int64 if np_dt is np.int64 else np.int32
    return torch.from_numpy(a.astype(np_dt).view(words))


def _dev(a: np.ndarray, np_dt) -> torch.Tensor:
    """Positions in the port's device dtype."""
    return torch.from_numpy(a.astype(np_dt).astype(
        np.int32 if np_dt is np.int32 else np.int64))


def _events(tier: str, n: int, seed: int, pileup: int = 0):
    """Packed events (pos int64 values, delta int32) as numpy, with a
    sentinel tail and a few unbalanced extra events."""
    np_dt, span = TIERS[tier]
    s, e = _pairs(tier, n, seed, tail=37, pileup=pileup)
    rng = np.random.RandomState(seed + 1)
    extra = rng.randint(0, span, 25).astype(np.int64)
    pos = np.concatenate([s, e, extra])
    sent = _sentinel(np_dt)
    delta = np.concatenate([np.where(s < sent, 1, 0),
                            np.where(e < sent, -1, 0),
                            rng.randint(-1, 2, 25)]).astype(np.int32)
    perm = rng.permutation(pos.shape[0])
    return pos[perm], delta[perm]


def _as_i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _assert_same(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        np.testing.assert_array_equal(_as_i64(j), _as_i64(p.numpy()))


@pytest.mark.parametrize("tail", [0, 64])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_pack_events_matches_jax(tier, tail):
    np_dt, _ = TIERS[tier]
    s, e = _pairs(tier, 1500, seed=1, tail=tail)
    sent = _sentinel(np_dt)
    jpos, jdelta = jax_pack_events(jnp.asarray(s.astype(np_dt)),
                                   jnp.asarray(e.astype(np_dt)), sent)
    pos, delta = sweep.pack_events(_raw(s, np_dt), _raw(e, np_dt), sent)
    assert pos.dtype == convert.device_pos_dtype(np_dt)
    assert delta.dtype == torch.int32
    _assert_same((jpos, jdelta), (pos, delta))


@pytest.mark.parametrize("min_dep", [1, 3])
@pytest.mark.parametrize("wrap18", [False, True])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_sort_events_matches_jax(tier, wrap18, min_dep):
    np_dt, _ = TIERS[tier]
    # the pileup drives depth past 18 bits: under wrap18 the mask changes
    # the answer; without it (checked on one tier) the depth stays whole
    deep = wrap18 or tier == "int32"
    pos, delta = _events(tier, 2000, seed=2,
                         pileup=(1 << 18) + 9 if deep else 0)
    jout = jsweep.sort_events(jnp.asarray(pos.astype(np_dt)),
                              jnp.asarray(delta), min_dep=min_dep,
                              wrap18=wrap18)
    out = sweep.sort_events(_dev(pos, np_dt), torch.from_numpy(delta),
                            min_dep=min_dep, wrap18=wrap18,
                            pos_max=_sentinel(np_dt))
    assert [t.dtype for t in out[1:]] == [torch.int32, torch.int64,
                                          torch.int64, torch.int32]
    _assert_same(jout, out)


SWEEP_EDGES = synth.sweep_edge_events(seed=5)


@pytest.mark.parametrize("case", range(len(SWEEP_EDGES)),
                         ids=[f"{k}-{c[0]}" for k, c in enumerate(SWEEP_EDGES)])
def test_sort_events_lookback_edges_match_jax(case):
    """The edges of the sweep_scan kernel's tiles and look-backs (the
    cases chip_smoke.py holds the kernel to its twin on): event counts
    around the tile size, a carry past 2^32, a wrap18 pileup across a
    tile boundary, c_sum past 2^64, min_dep 3."""
    _, pos, delta, np_dt, min_dep, wrap18 = SWEEP_EDGES[case]
    jout = jsweep.sort_events(jnp.asarray(pos.astype(np_dt)),
                              jnp.asarray(delta), min_dep=min_dep,
                              wrap18=wrap18)
    out = sweep.sort_events(_dev(pos, np_dt), torch.from_numpy(delta),
                            min_dep=min_dep, wrap18=wrap18,
                            pos_max=_sentinel(np_dt))
    _assert_same(jout, out)


def test_sweep_edge_events_reach_their_edges():
    """Each special case of ``synth.sweep_edge_events`` drives its sums
    where its name says (exact integer sums of the sorted events)."""
    t = synth.SWEEP_TILE
    counts = set()
    for name, pos, delta, np_dt, _, _ in SWEEP_EDGES:
        order = np.argsort(pos, kind="stable")
        run = np.cumsum(delta[order].astype(np.int64))
        counts.add(pos.shape[0])
        if "carry" in name:
            assert run[-1] >= 1 << 34
        elif "pileup" in name:
            assert run[t - 1] >= 1 << 18 and run[t] >= 1 << 18
            assert run[t - 10] < 1 << 18
        elif "2^64" in name:
            p = pos[order].astype(object)
            dep = run[:-1].astype(np.int32).astype(object)
            # before the last piece, the one against the tier's max
            assert sum((p[1:] - p[:-1]) * dep * (dep >= 1)) >= 1 << 64
    assert {1, t - 1, t, t + 1} <= counts


def _queries(tier: str, pos: np.ndarray, seed: int):
    np_dt, span = TIERS[tier]
    rng = np.random.RandomState(seed)
    q = np.sort(rng.randint(0, span, 400)).astype(np.int64)
    q[:40] = np.sort(pos[pos < _sentinel(np_dt)][:40])  # on events
    q[-3:] = _sentinel(np_dt) - 1                         # past them all
    return q[0::2], q[1::2]


@pytest.mark.parametrize("min_dep", [1, 3])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_eval_pair_matches_jax(tier, min_dep):
    np_dt, _ = TIERS[tier]
    pos, delta = _events(tier, 2000, seed=3)
    lo, hi = _queries(tier, pos, seed=4)
    js = jsweep.sort_events(jnp.asarray(pos.astype(np_dt)),
                            jnp.asarray(delta), min_dep=min_dep)
    jcov, jsum = jsweep.eval_pair(*js[:4], jnp.int32(min_dep),
                                  jnp.asarray(lo.astype(np_dt)),
                                  jnp.asarray(hi.astype(np_dt)),
                                  method="scan_unrolled")
    st = sweep.sort_events(_dev(pos, np_dt), torch.from_numpy(delta),
                           min_dep=min_dep, pos_max=_sentinel(np_dt))
    cov, dsum = sweep.eval_pair(*st[:4], min_dep, _dev(lo, np_dt),
                                _dev(hi, np_dt))
    _assert_same((jcov, jsum), (cov, dsum))


SEARCH_EDGES = synth.search_edge_cases(seed=6)


@pytest.mark.parametrize("case", range(len(SEARCH_EDGES)),
                         ids=[f"{k}-{c[0]}" for k, c in
                              enumerate(SEARCH_EDGES)])
def test_eval_pair_search_edges_match_jax(case):
    """The edges of the eval_pair kernel's cooperative search and dense
    tiles (the cases chip_smoke.py holds the kernel to its twin on):
    event counts around the 16-way split, boundaries before, on, beside
    and past the events, zero-length and reversed segments, a long run of
    equal positions, dense tiles wider and narrower than the staging
    window, unsorted segments."""
    _, pos, delta, np_dt, min_dep, lo, hi = SEARCH_EDGES[case]
    js = jsweep.sort_events(jnp.asarray(pos.astype(np_dt)),
                            jnp.asarray(delta), min_dep=min_dep)
    jout = jsweep.eval_pair(*js[:4], jnp.int32(min_dep),
                            jnp.asarray(lo.astype(np_dt)),
                            jnp.asarray(hi.astype(np_dt)))
    st = sweep.sort_events(_dev(pos, np_dt), torch.from_numpy(delta),
                           min_dep=min_dep, pos_max=_sentinel(np_dt))
    out = sweep.eval_pair(*st[:4], min_dep, _dev(lo, np_dt), _dev(hi, np_dt))
    _assert_same(jout, out)


def _tile_spans(pos_s: np.ndarray, lo: np.ndarray, hi: np.ndarray, t: int):
    """r(max) - r(min) over each tile of ``t`` consecutive segments."""
    n = lo.shape[0] // t * t
    x = np.stack([lo[:n], hi[:n]], 1).reshape(-1, 2 * t)
    return (np.searchsorted(pos_s, x.max(1))
            - np.searchsorted(pos_s, x.min(1)))


def test_search_edge_cases_reach_their_edges():
    """Each case of ``synth.search_edge_cases`` has the boundaries its
    name promises: r = 0, r = 1, on an event and past every event; zero-
    length and reversed segments; a run longer than a 16-way stride;
    tiles of 16 to 400 sorted segments both wider and narrower than the
    staging window; and tiles of 400 or more wider than it whose sub-tiles
    of 256 are narrower."""
    counts = set()
    for name, pos, delta, np_dt, _, lo, hi in SEARCH_EDGES:
        pos_s = np.sort(pos)
        x = np.concatenate([lo, hi])
        r = np.searchsorted(pos_s, x)
        live = int((pos < _sentinel(np_dt)).sum())
        counts.add(live)
        if "dense" not in name:
            assert (r == 0).any() and (r == 1).any()
            assert np.isin(x, pos_s).any()
            assert (x == _sentinel(np_dt) - 1).any() and r.max() == live
            assert (lo == hi).any() and (lo > hi).any()
        if "run" in name:
            v, c = np.unique(pos_s, return_counts=True)
            assert c.max() > live / 17 and np.isin(v[c.argmax()], x)
        if "one cluster" in name:
            for t in (16, 32, 64, 128, 256, 400):
                spans = _tile_spans(pos_s, lo, hi, t)
                assert spans.max() > synth.SEARCH_WIN
                assert spans.min() <= synth.SEARCH_WIN
        if "shuffled" in name:
            assert (np.diff(lo) < 0).any()
        if "wide" in name:
            for t in (400, 500, 1000):
                assert _tile_spans(pos_s, lo, hi, t).min() > synth.SEARCH_WIN
            assert _tile_spans(pos_s, lo, hi, 256).max() <= synth.SEARCH_WIN
    assert {1, 2, 15, 16, 17, 255, 256, 257} <= counts


@pytest.mark.parametrize("wrap18", [False, True])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_finalize_chunked_matches_jax(tier, wrap18):
    np_dt, _ = TIERS[tier]
    chunks = [_events(tier, 700, seed=10 + k) for k in range(3)]
    lo, hi = _queries(tier, chunks[0][0], seed=5)
    args = dict(min_dep=2, wrap18=wrap18)
    for want_state in (True, False):
        jout = jsweep.finalize_chunked(
            tuple(jnp.asarray(p.astype(np_dt)) for p, _ in chunks),
            tuple(jnp.asarray(d) for _, d in chunks),
            jnp.asarray(lo.astype(np_dt)), jnp.asarray(hi.astype(np_dt)),
            want_state=want_state, **args)
        out = sweep.finalize_chunked(
            tuple(_dev(p, np_dt) for p, _ in chunks),
            tuple(torch.from_numpy(d) for _, d in chunks),
            _dev(lo, np_dt), _dev(hi, np_dt), want_state=want_state,
            pos_max=_sentinel(np_dt), **args)
        assert len(out) == (7 if want_state else 2)
        _assert_same(jout, out)
        ref = sweep.finalize_chunked_reference(
            tuple(_dev(p, np_dt) for p, _ in chunks),
            tuple(torch.from_numpy(d) for _, d in chunks),
            _dev(lo, np_dt), _dev(hi, np_dt), want_state=want_state,
            pos_max=_sentinel(np_dt), **args)
        _assert_same(jout, ref)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_empty_feed_matches_jax(tier):
    """No pairs: pack gives nothing, and the engine's lone sentinel event
    finalizes to zero stats in both packages."""
    np_dt, _ = TIERS[tier]
    sent = _sentinel(np_dt)
    none = np.zeros(0, np.int64)
    pos, delta = sweep.pack_events(_raw(none, np_dt), _raw(none, np_dt),
                                   sent)
    assert pos.numel() == 0 and delta.numel() == 0
    lo = np.array([0, 10, 1000], np.int64)
    hi = np.array([5, 10, 99999], np.int64)
    jout = jsweep.finalize_chunked(
        (jnp.full((1,), sent, np_dt),), (jnp.zeros((1,), jnp.int32),),
        jnp.asarray(lo.astype(np_dt)), jnp.asarray(hi.astype(np_dt)))
    out = sweep.finalize_chunked(
        (_dev(np.array([sent]), np_dt),), (torch.zeros(1, dtype=torch.int32),),
        _dev(lo, np_dt), _dev(hi, np_dt), pos_max=sent)
    _assert_same(jout, out)
    assert not out[0].any() and not out[1].any()


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_jax_state_through_convert(tier):
    """JAX's sweep state, carried across by convert.state_from_numpy,
    evaluates in the port exactly as in JAX, and converts back."""
    np_dt, _ = TIERS[tier]
    pos, delta = _events(tier, 1500, seed=6)
    lo, hi = _queries(tier, pos, seed=7)
    js = jsweep.sort_events(jnp.asarray(pos.astype(np_dt)),
                            jnp.asarray(delta), min_dep=1)
    host = [np.asarray(a) for a in js[:4]]
    state = convert.state_from_numpy(*host, np_dt, "cpu")
    assert state[0].dtype == convert.device_pos_dtype(np_dt)
    jcov, jsum = jsweep.eval_pair(*js[:4], jnp.int32(1),
                                  jnp.asarray(lo.astype(np_dt)),
                                  jnp.asarray(hi.astype(np_dt)))
    cov, dsum = sweep.eval_pair(*state, 1, _dev(lo, np_dt), _dev(hi, np_dt))
    _assert_same((jcov, jsum), (cov, dsum))
    back = convert.state_to_numpy(*state, np_dt)
    assert back[0].dtype == np.dtype(np_dt)
    for a, b in zip(host, back):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("encoded", [False, True])
def test_eval_pair_fills_one_two_row_buffer(encoded):
    """(cover, dsum) come back as the rows of one (2, B) buffer, ``out``
    when it is given, through eval_pair and both finalizes: the engine
    brings that buffer to the host in one copy, with no stack."""
    np_dt = np.uint32
    pos, delta = _events("uint32", 900, seed=8)
    lo, hi = _queries("uint32", pos, seed=9)
    q = (_dev(lo, np_dt), _dev(hi, np_dt))
    st = sweep.sort_events(_dev(pos, np_dt), torch.from_numpy(delta),
                           min_dep=1, pos_max=_sentinel(np_dt))
    want = torch.stack(sweep.eval_pair_reference(*st[:4], 1, *q))
    assert torch.equal(sweep.eval_pair(*st[:4], 1, *q), want)
    buf = torch.full((2, lo.shape[0]), -7, dtype=torch.int64)
    assert sweep.eval_pair(*st[:4], 1, *q, out=buf) is buf
    assert torch.equal(buf, want)
    buf.fill_(-7)
    if encoded:
        out = sweep.finalize_encoded(None, None, None, None,
                                     [_dev(pos, np_dt)],
                                     [torch.from_numpy(delta)], *q,
                                     pos_max=_sentinel(np_dt), out=buf)
    else:
        out = sweep.finalize_chunked([_dev(pos, np_dt)],
                                     [torch.from_numpy(delta)], *q,
                                     pos_max=_sentinel(np_dt), out=buf)
    assert torch.equal(buf, want) and len(out) == 7
    assert out[0].data_ptr() == buf[0].data_ptr()
    assert out[1].data_ptr() == buf[1].data_ptr()


def test_device_pos_dtype_tiers():
    assert convert.device_pos_dtype(np.int32) == torch.int32
    assert convert.device_pos_dtype(np.uint32) == torch.int64
    assert convert.device_pos_dtype(np.int64) == torch.int64
    assert convert.tier_for_max(0xFFFFFFFF) == kernels.TIER_U32
    with pytest.raises(ValueError):
        convert.tier_of(np.int16)


@pytest.mark.parametrize("fn", ["pack_events", "sort_events", "eval_pair",
                                "extract_events", "eval_boundaries",
                                "add_batch"])
def test_cuda_branch_raises_instead_of_falling_back(monkeypatch, fn):
    """With the dispatch predicate saying "CUDA", a CPU tensor reaches the
    kernel wrapper, which refuses it: no plain fallback."""
    monkeypatch.setattr(sweep, "_use_kernel", lambda t: True)
    p = torch.tensor([5, 9, 2147483647], dtype=torch.int32)
    d = torch.tensor([1, -1, 0], dtype=torch.int32)
    c = torch.zeros(3, dtype=torch.int64)
    lay = GenomeLayout(np.array([5000, 700]))
    batch = ReadBatch(*(np.zeros(k, np.int32) for k in (3, 3, 3, 3, 3)),
                      op_code=np.zeros(4, np.int32),
                      op_len=np.full(4, 9, np.int32),
                      op_read=np.array([0, 0, 1, 2], np.int32))
    eng = CoverageEngine(lay, device="cpu")
    calls = {"pack_events": lambda: sweep.pack_events(p, p, 2147483647),
             "sort_events": lambda: sweep.sort_events(p, d),
             "eval_pair": lambda: sweep.eval_pair(p, d, c, c, 1, p, p),
             "extract_events": lambda: events.extract_events(
                 p, p, p, p, p, p, p, c, c, 1796, -1),
             "eval_boundaries": lambda: sweep.eval_boundaries(p, d, c, c,
                                                              1, p),
             "add_batch": lambda: eng.add_batch(batch)}
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        calls[fn]()
    assert not any(kernels.launches.values())


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep.pack_events(torch.zeros(2, dtype=torch.int32, device="meta"),
                          torch.zeros(2, dtype=torch.int32, device="meta"),
                          2147483647)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
