"""The port's encoded-window engine (device="cpu", the decode_enc kernel's
plain twin) against pandepth_tpu's CoverageEngine with PANDEPTH_ENC=1 and
against the raw-pair feed, with windows from a real NativeBamStream
through the shared ``pandepth_tpu.run._feed_stream``; and the engine's
election of the feed.

Tolerance: exact equality of SegmentStats (all arithmetic is integer).
The engines pad and spill differently, so they are compared by their
answers, not their state. The port decodes a window less than half full
on the host into its raw staging, so the window sizes here keep most
windows full.
"""

import numpy as np
import pytest
import torch

from tests.test_enc_stream import (_mixed_bam, _native_stream,
                                   _uniform_bam)

from pandepth_tpu.device.engine import CoverageEngine as JaxEngine
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import read_bam_header
from pandepth_tpu.io.bam_writer import write_bam, write_uniform_bam
from pandepth_tpu.run import _feed_stream
from pandepth_tpu_torch.device.engine import ENC_GROUPS, CoverageEngine


def _recording(eng):
    """Record the pair count of every window ``eng`` is fed in
    ``eng.fed``."""
    eng.fed = []
    real = eng.add_encoded_window

    def add(n, *rest):
        eng.fed.append(int(n))
        real(n, *rest)

    eng.add_encoded_window = add
    return eng


def _engines(bam, monkeypatch, cap=None, exc=None):
    """(layout, header, port encoded, JAX encoded, port raw), each fed the
    whole BAM through _feed_stream; the port's windows keep their pair
    counts in ``port.fed``."""
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    port, ref = _recording(CoverageEngine(lay, device="cpu")), JaxEngine(lay)
    raw = CoverageEngine(lay, device="cpu")
    for eng, enc in ((port, "1"), (ref, "1"), (raw, "0")):
        monkeypatch.setenv("PANDEPTH_ENC", enc)
        assert eng.wants_encoded_windows == (enc == "1")
        if cap is not None:
            eng.enc_cap, eng.enc_exc = cap, exc
        _feed_stream(eng, _native_stream(bam))
    assert port._has_enc and not raw._has_enc
    assert port.n_reads_seen == ref.n_reads_seen == raw.n_reads_seen
    cap = port.enc_cap
    assert port.n_windows["raw"] == sum(2 * n < cap for n in port.fed)
    return lay, hdr, port, ref, raw


def _n_events(eng):
    """The events the port's finalize sorts for the windows it was fed:
    2 * enc_cap for each window on the device, 2 per pair of the others."""
    cap = eng.enc_cap
    return 2 * sum(n if 2 * n < cap else cap for n in eng.fed)


def _segments(lay, seed, n=60):
    rng = np.random.RandomState(seed)
    tid = rng.randint(0, lay.n_targets, n)
    s1 = (rng.rand(n) * lay.lengths[tid]).astype(np.int64) + 1
    e1 = s1 + rng.randint(0, 20_000, n)
    return (np.concatenate([tid, np.arange(lay.n_targets)]),
            np.concatenate([s1, np.ones(lay.n_targets, np.int64)]),
            np.concatenate([e1, lay.lengths]))


def _assert_same_stats(engines, seg, **kw):
    got = [eng.segment_stats(*seg, **kw) for eng in engines]
    for st in got[1:]:
        np.testing.assert_array_equal(st.cover, got[0].cover)
        np.testing.assert_array_equal(st.depth_sum, got[0].depth_sum)
    assert got[0].cover.sum() > 0


def test_const_length_route(tmp_path, monkeypatch):
    """Uniform-length windows take the const u8 group only."""
    bam = str(tmp_path / "u.bam")
    _uniform_bam(bam)
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 512, 64)
    assert port.n_windows["c8"] > 0 and port.n_windows["8"] == 0
    assert not port._enc["8"] and not port._pend["8"]
    _assert_same_stats((port, ref, raw), _segments(lay, 1))


def test_mixed_route(tmp_path, monkeypatch):
    """Mixed lengths, length escapes, delta escapes (both signs), two
    contigs: the mixed groups."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 256, 128)
    assert port.n_windows["8"] + port.n_windows["16"] > 0
    _assert_same_stats((port, ref, raw), _segments(lay, 2))


def test_u8_to_u16_upgrade_on_sparse_bam(tmp_path, monkeypatch):
    """Start gaps past 8-bit zigzag move the feed to u16 codes after the
    first escape-saturated window; the u16 blocks cross as int16 bits."""
    bam = str(tmp_path / "s.bam")
    starts = np.cumsum(np.full(4000, 400, np.int64)) + 100
    write_bam(bam, ["c0"], [int(starts[-1]) + 1000],
              [(0, int(p), 0, 60, "150M") for p in starts])
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 512, 64)
    # the escape-saturated u8 window is short: it takes the raw staging
    assert port.n_windows["8"] + port.n_windows["c8"] == 0
    assert port.n_windows["raw"] >= 1
    assert port.n_windows["16"] + port.n_windows["c16"] >= 1
    port._flush_block("c16")
    assert port._enc["c16"] and all(b[0].dtype == torch.int16
                                    for b in port._enc["c16"])
    _assert_same_stats((port, ref, raw), _segments(lay, 3))


def test_mixed_const_seam(tmp_path, monkeypatch):
    """Sparse uniform reads ride const u16; one odd-length read makes only
    its window mixed."""
    bam = str(tmp_path / "seam.bam")
    n = 2000
    starts = np.cumsum(np.full(n, 400, np.int64)) + 100
    recs = [(0, int(p), 0, 60, "150M") for p in starts]
    recs[n // 2] = (0, int(starts[n // 2]), 0, 60, "151M")
    write_bam(bam, ["c0"], [int(starts[-1]) + 2000], recs)
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 512, 64)
    assert port.n_windows["c16"] > 0 and port.n_windows["16"] >= 1
    _assert_same_stats((port, ref, raw), _segments(lay, 4))


def test_more_windows_than_jax_keeps(tmp_path, monkeypatch):
    """Past the JAX engine's 512 windows it spills them to raw pairs; the
    port keeps every full window on the device. Same answers."""
    bam = str(tmp_path / "many.bam")
    n = 140_000
    rng = np.random.RandomState(5)
    pos = np.sort(rng.randint(0, 9_000_000, n)).astype(np.int32)
    write_uniform_bam(bam, ["c0"], [9_001_000], np.zeros(n, np.int32), pos,
                      np.zeros(n, np.uint16), np.full(n, 60, np.uint8))
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 256, 64)
    n_win = sum(port.n_windows[g] for g in ENC_GROUPS)
    assert n_win > ref._max_enc
    assert sum(b[0].shape[0] for g in port._enc.values() for b in g) \
        + sum(len(p) for p in port._pend.values()) == n_win
    _assert_same_stats((port, ref, raw), _segments(lay, 5))


@pytest.mark.parametrize("n_contigs,want_dtype", [
    (13, np.uint32),    # 3.25 Gb: uint32 tier
    (18, np.int64),     # 4.5 Gb: int64 tier
])
def test_wide_tiers(tmp_path, monkeypatch, n_contigs, want_dtype):
    bam = str(tmp_path / "g.bam")
    rng = np.random.RandomState(3)
    recs = []
    for tid in range(n_contigs):
        ps = np.sort(rng.randint(0, 249_000_000, 80))
        recs += [(tid, int(p), 0, 60, "150M") for p in ps]
    write_bam(bam, [f"c{i}" for i in range(n_contigs)],
              [250_000_000] * n_contigs, recs)
    # every start delta escapes: escape lists as long as the window keep
    # the windows full (and on u8 codes)
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 512, 512)
    assert port.pos_dtype is want_dtype
    _assert_same_stats((port, ref, raw), _segments(lay, 6))


def test_sweep_state_and_chunked_stats(tmp_path, monkeypatch):
    """With encoded windows pending, sweep_state() and the chunked
    segment_stats (more segments than the chunk) build the state through
    the encoded finalize; single-query finalizes without keep_state leave
    the windows in place for the next call."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    lay, _, port, ref, raw = _engines(bam, monkeypatch, 256, 128)
    seg = _segments(lay, 7, n=300)
    _assert_same_stats((port, ref, raw), seg, keep_state=False)
    assert port._has_enc and port._state is None
    _assert_same_stats((port, ref, raw), seg, chunk=64)
    assert not port._has_enc and port._state is not None

    lay, _, port2, _, _ = _engines(bam, monkeypatch, 256, 128)
    pos_s, depth, _, _ = port2.sweep_state()
    assert not port2._has_enc
    assert pos_s.shape[0] == _n_events(port2)
    _assert_same_stats((port2, ref, raw), seg, chunk=100)


def test_unsorted_bam_short_windows_stay_raw(tmp_path, monkeypatch):
    """At the default window sizes an unsorted BAM escapes nearly every
    start delta, so the encoder cuts each window when its escape list
    fills, far below enc_cap. Those windows are decoded on the host: the
    finalize sorts 2 events per pair, as the raw feed does, not 2 *
    enc_cap per window. Same answers as the raw feed."""
    monkeypatch.delenv("PANDEPTH_ENC_CAP", raising=False)
    monkeypatch.delenv("PANDEPTH_ENC_EXC", raising=False)
    bam = str(tmp_path / "unsorted.bam")
    n = 30_000
    rng = np.random.RandomState(21)
    tid = rng.randint(0, 3, n).astype(np.int32)
    pos = rng.randint(0, 4_900_000, n).astype(np.int32)
    write_uniform_bam(bam, ["c0", "c1", "c2"], [5_000_000] * 3, tid, pos,
                      np.zeros(n, np.uint16), np.full(n, 60, np.uint8),
                      make_index=False)
    lay = GenomeLayout(read_bam_header(bam).lengths)
    port = _recording(CoverageEngine(lay, device="cpu"))
    raw = CoverageEngine(lay, device="cpu")
    for eng, enc in ((port, "1"), (raw, "0")):
        monkeypatch.setenv("PANDEPTH_ENC", enc)
        _feed_stream(eng, _native_stream(bam))
    assert port.enc_cap == 1 << 19
    assert len(port.fed) >= 3 and sum(port.fed) == n
    assert port.n_windows["raw"] == len(port.fed) and not port._has_enc
    assert port.sweep_state()[0].shape[0] == 2 * n == _n_events(port)
    _assert_same_stats((port, raw), _segments(lay, 8))


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", False), (None, "cuda", True),
    ("0", "cpu", False), ("0", "cuda", False),
    ("1", "cpu", True), ("1", "cuda", True),
])
def test_feed_election(monkeypatch, env, device, want):
    """PANDEPTH_ENC decides when it is set; unset, a CUDA engine takes
    encoded windows and a CPU engine raw pairs. Building the engine does
    not touch the device."""
    if env is None:
        monkeypatch.delenv("PANDEPTH_ENC", raising=False)
    else:
        monkeypatch.setenv("PANDEPTH_ENC", env)
    initialized = torch.cuda.is_initialized()
    eng = CoverageEngine(GenomeLayout(np.array([1000])), device=device)
    assert eng.wants_encoded_windows is want
    assert torch.cuda.is_initialized() == initialized
    assert not hasattr(eng, "maybe_warm_finalize")
    assert not hasattr(eng, "plan_finalize_warmup")
