"""The readers' half of a run, copied from ``pandepth_tpu/run.py`` (its
jax-free helpers, under public names): input sniffing, the native
BAM stream and its feed (with the puller of encoded windows that lets a
run stash them on a thread before its engine exists, while torch starts:
``pandepth_tpu_torch.run.prepare``), the header read, the region filters of the
Python decoders' batches and CRAM's intervals, and the PAF contig table
from a FASTA.

JAX's finalize warm-up (``maybe_warm_finalize``) is not copied: the
port's engines have none.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from pandepth_tpu_torch.config import RunConfig
from pandepth_tpu_torch.io.bam import BamHeader, BamReader
from pandepth_tpu_torch.io.sam_text import SamReader
from pandepth_tpu_torch.utils.log import note, span


def _strip_gz(path: str) -> str:
    return path[:-3] if path.endswith(".gz") else path


def _ext(path: str) -> str:
    base = os.path.basename(path)
    return base.rsplit(".", 1)[1] if "." in base else ""


def is_paf(path: str) -> bool:
    return _ext(_strip_gz(path)).lower() == "paf"


def open_alignment(path: str):
    """Sniff BAM (BGZF) vs SAM text vs CRAM and return a Python reader
    with a ``.header`` and ``.batches()``. Where the native library is
    wanted a BAM takes the stream instead (:func:`try_native_load`), so
    this reads a BAM only under ``PANDEPTH_NO_NATIVE=1``."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:4] == b"CRAM":
        from pandepth_tpu_torch.io.cram import CramReader
        return CramReader(path)
    if magic[:2] == b"\x1f\x8b":
        # could be BAM-in-BGZF or gzipped SAM; readers sniff content
        try:
            return BamReader(path)
        except ValueError as e:
            # only fall back to gzipped SAM text when the stream is NOT
            # a BAM; a malformed BAM (bad header/record) is a hard error
            if "bad magic" not in str(e):
                raise
            return SamReader(path)
    return SamReader(path)


def index_present(path: str) -> bool:
    return any(os.path.exists(path + suf)
               for suf in (".bai", ".csi", ".crai"))


def try_native_load(path: str, config: RunConfig,
                    ext_offsets=None, ext_limits=None, regions=None):
    """The bounded-memory native stream of the BAM ``path``, or None when
    the file is not BGZF, the library does not build or the stream cannot
    open it: windows of the file are inflated and walked behind a
    producer thread while the engine uploads the previous window's
    events. With an index, the producer walks on every thread: a
    targeted run (region mode 1) reads only the index's merged chunk
    ranges, cut at the chunks' starts, and a run with no region filter
    the splits between the index's record starts. Every other stream
    (region mode 2, no index) is walked serially."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:2] != b"\x1f\x8b":
        return None
    try:
        from pandepth_tpu_torch.io.native import (NativeBamStream,
                                                  load_library)
        if load_library() is None:
            return None
        from pandepth_tpu_torch.io.bamindex import (load_index_for,
                                                    merge_ranges,
                                                    record_starts,
                                                    window_chunks)
        vranges = cuts = None
        if regions is None:
            idx = load_index_for(path)
            if idx is not None:
                cuts = record_starts(idx)
        elif regions[3] == 1:
            with span("feed.index"):
                idx = load_index_for(path)
                if idx is not None:
                    # index-driven block skipping: decompress only the
                    # BGZF blocks whose records can overlap the windows
                    chunks = window_chunks(idx, regions)
                    vranges = merge_ranges(chunks)
                    cuts = np.unique(chunks[:, 0])
        return NativeBamStream(path, config.flags, config.min_mapq,
                               threads=config.threads,
                               ext_offsets=ext_offsets,
                               ext_limits=ext_limits, regions=regions,
                               vranges=vranges, cuts=cuts)
    except (ValueError, RuntimeError, OSError):
        return None


def enc_caps() -> Tuple[int, int]:
    """The encoded windows' slots and escape slots, ``PANDEPTH_ENC_CAP``
    and ``PANDEPTH_ENC_EXC``: read here by the pre-engine stash and by
    ``CoverageEngine``, so that both size their windows alike."""
    return (int(os.environ.get("PANDEPTH_ENC_CAP", 1 << 19)),
            int(os.environ.get("PANDEPTH_ENC_EXC", 1 << 13)))


class EncPuller:
    """Encoded windows pulled one at a time from a NativeBamStream, with
    the u8 -> u16 code-tier upgrade: windows can be pulled before the
    engine exists (the pre-engine stash) and the rest streamed after."""

    def __init__(self, r, cap: int, exc: int):
        self.r, self.cap, self.exc = r, cap, exc
        self._take = r.take_enc_acc
        self._on_u8 = True
        self.eof = False

    def next(self):
        """One (n, dd, ll, excd, excl, base) window, or None at EOF; the
        pull is the run's ``feed.take`` span."""
        with span("feed.take"):
            win = self._take(self.cap, self.exc)
        if win is None:
            self.eof = True
            return None
        if self._on_u8 and win[0] < self.cap \
                and (self.r.last_nd >= self.exc
                     or self.r.last_nl >= self.exc):
            # short buffer through escape saturation: the input is
            # sparser than 8-bit zigzag covers — upgrade the rest of the
            # feed to 16-bit codes (4 B/pair)
            self._take = self.r.take_enc_acc16
            self._on_u8 = False
        return win

    def windows(self, stash=()):
        """The windows of ``stash`` (pulled earlier), then every window
        left in the stream."""
        yield from stash
        while not self.eof:
            win = self.next()
            if win is not None:
                yield win


def feed_stream(engine, r, puller: Optional[EncPuller] = None,
                stash=()) -> None:
    """Pull event windows from a NativeBamStream into the engine.

    An engine that elects encoded windows (``wants_encoded_windows``)
    gets the encoder's windows of ``engine.enc_cap`` slots; every other
    engine (the sharded one has no encoded path) the raw ``take32`` /
    ``take64`` pairs. ``puller`` and ``stash`` carry the windows pulled
    before the engine existed: they go in first, and the same puller
    goes on; an engine without encoded windows then decodes them and the
    rest of the stream on the host, since mixing ``take_enc_acc`` with
    ``take32`` on one stream would lose the encoder's accumulated
    pairs. Each pull of a window is the run's ``feed.take`` span, the
    seconds the pulls blocked on the stream's producer (its counter, read
    as the stream closes) are its ``feed.wait``, the seconds its threads
    spent inflating BGZF blocks its ``feed.inflate``, the share of the
    stream's records walked in index-cut splits is its ``feed.split``,
    the share of the file's compressed bytes that its walk consumed its
    ``feed.read``, and the share of its decoded records that its filters
    kept its ``feed.kept`` (a run of several streams notes the sum of
    their shares)."""
    if getattr(engine, "wants_encoded_windows", False) and \
            hasattr(r, "take_enc_acc"):
        p = puller if puller is not None else \
            EncPuller(r, engine.enc_cap, engine.enc_exc)
        for win in p.windows(stash):
            engine.add_encoded_window(*win)
    elif puller is not None:
        from pandepth_tpu_torch.device.hosteval import decode_enc_host

        for win in puller.windows(stash):
            engine.add_start_end(*decode_enc_host(*win[1:], win[0]))
    else:
        while True:
            with span("feed.take"):
                n = r.wait()
                if n < 0:
                    break
                if engine.pos_bits32:
                    s, e = r.take32(max(n, 1), engine.pos_sentinel32)
                else:
                    s, e = r.take64(n)
            if engine.pos_bits32:
                engine.add_padded_events(s.view(engine.pos_dtype),
                                         e.view(engine.pos_dtype))
            else:
                engine.add_start_end(s, e)
    engine.n_reads_seen += r.n_records
    if hasattr(r, "wait_seconds"):  # the JAX package's stream has none
        note("feed.wait", r.wait_seconds())
        note("feed.inflate", r.inflate_seconds())
        note("feed.split", r.split_share())
        note("feed.read", r.read_share())
        note("feed.kept", r.kept_share())
    r.close()


def cheap_header(path: str) -> Optional[BamHeader]:
    """Header without decoding the file body (BAM only)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"\x1f\x8b":
        return None
    from pandepth_tpu_torch.io.bam import read_bam_header

    try:
        return read_bam_header(path)
    except (ValueError, struct.error, zlib.error, IndexError):
        return None


def filter_batch_to_windows(batch, windows) -> None:
    """Python-path equivalent of the C++ mode-1 region restriction:
    drop reads not overlapping any fetch window (marks tid = -1)."""
    off, starts, ends = windows[:3]
    if starts.shape[0] == 0:
        batch.tid[:] = -1
        return
    pos = batch.pos.astype(np.int64)
    end = batch.end_pos()
    keep = np.zeros(batch.tid.shape[0], bool)
    for tid in np.unique(batch.tid):
        if tid < 0 or tid + 1 >= off.shape[0]:
            continue
        a, b = int(off[tid]), int(off[tid + 1])
        if a == b:
            continue
        sel = batch.tid == tid
        idx = np.searchsorted(starts[a:b], end[sel] - 1, side="right")
        ok = idx > 0
        cand = np.maximum(idx - 1, 0)
        ok &= ends[a:b][cand] > pos[sel]
        keep[sel] = ok
    batch.tid[~keep] = -1


def intervals_in_windows(tid: np.ndarray, read_lo: np.ndarray,
                         read_hi: np.ndarray, windows) -> np.ndarray:
    """Mode-1 fetch filter on whole-read spans (the per-run twin of
    filter_batch_to_windows): keep runs whose READ overlaps any fetch
    window of its contig."""
    off, starts, ends = windows[:3]
    keep = np.zeros(tid.shape[0], bool)
    if starts.shape[0] == 0:
        return keep
    for t in np.unique(tid):
        if t < 0 or t + 1 >= off.shape[0]:
            continue
        a, b = int(off[t]), int(off[t + 1])
        if a == b:
            continue
        sel = tid == t
        idx = np.searchsorted(starts[a:b], read_hi[sel] - 1,
                              side="right")
        ok = idx > 0
        cand = np.maximum(idx - 1, 0)
        ok &= ends[a:b][cand] > read_lo[sel]
        keep[sel] = ok
    return keep


class RegionCursor:
    """Python-path equivalent of the C++ mode-2 sorted-stream cursor
    (reference no-index loop, src/PanDepth.cpp:4604-4671), including
    its quirks: the chromosome-finishing read is counted, and a read
    landing in a gap after a cursor advance is counted too. Filters are
    assumed already applied (FLAG/MAPQ).

    Vectorized: within a coordinate-sorted stream the cursor is
    monotone in position, so each read's effective region is one
    ``searchsorted`` over the tid's region ends; only the
    chromosome-finishing events (at most one per tid per batch) need
    sequencing, to replicate the reference's break-out-of-the-loop
    behavior when the LAST pending chromosome finishes."""

    def __init__(self, regions):
        self.off, self.s1, self.e1 = (np.asarray(a, np.int64)
                                      for a in regions[:3])
        self.cursor = self.off[:-1].copy()
        self.done = self.off[:-1] == self.off[1:]
        self.chrs_left = int((~self.done).sum())
        self.stream_done = False

    def filter_batch(self, batch, flags_mask: int,
                     min_mapq: int) -> None:
        n = batch.tid.shape[0]
        if n == 0:
            return
        if self.stream_done:
            batch.tid[:] = -1
            return
        end = batch.end_pos().astype(np.int64)
        pos0 = batch.pos.astype(np.int64)
        tid = batch.tid
        n_chr = self.done.shape[0]

        active = (batch.flag & flags_mask) == 0
        if min_mapq >= 1:
            active &= batch.mapq >= min_mapq
        valid = (tid >= 0) & (tid < n_chr)
        drop = np.zeros(n, bool)
        drop |= ~valid
        cutoff = n  # batch index where stream_done fired, if any

        finishes = []  # (batch_index, tid)
        for t in np.unique(tid[valid]):
            if self.done[t]:
                drop |= tid == t
                continue
            a, b = int(self.off[t]), int(self.off[t + 1])
            sel = np.nonzero((tid == t) & active)[0]
            if sel.shape[0] == 0:
                continue
            # cursor after each read = first region whose end >= pos
            # (monotone in a sorted stream; filtered reads don't move
            # it, and they're excluded from `sel`)
            c = np.searchsorted(self.e1[a:b], pos0[sel], side="left")
            fin = c >= (b - a)       # advanced past the last region
            cc = np.minimum(c, b - a - 1) + a
            # a read that ADVANCED the cursor is kept even when it
            # lands in the gap before its new region (the reference
            # falls through without re-checking, quirk); only
            # non-advancing reads are dropped for ending before the
            # current region's start
            prev_c = np.empty(cc.shape[0], np.int64)
            prev_c[0] = self.cursor[t]
            prev_c[1:] = cc[:-1]
            drop_t = (end[sel] < self.s1[cc]) & ~fin & (cc == prev_c)
            drop[sel[drop_t]] = True
            self.cursor[t] = cc[-1]
            if fin.any():
                k = int(sel[np.argmax(fin)])
                finishes.append((k, int(t)))
                # reads after the finisher on a done chromosome drop
                later = sel[sel > k]
                drop[later] = True

        # sequence chromosome-finishing events in stream order; the
        # read finishing the LAST pending chromosome is itself dropped
        # (the reference breaks out of its loop) and ends the stream
        for k, t in sorted(finishes):
            if k >= cutoff:
                break
            self.done[t] = True
            self.chrs_left -= 1
            if self.chrs_left == 0:
                self.stream_done = True
                drop[k] = True
                cutoff = k
                break
        if cutoff < n:
            drop[cutoff + 1:] = True
        batch.tid[drop] = -1


def paf_contigs_from_fasta(path: str):
    """ONE streaming pass over the -r fasta: contig table + per-tid
    PackedGC (a second pass would re-gunzip and re-pack a 3 Gb
    reference for nothing). Duplicate names get distinct tids exactly
    like the reference's per-record ID++ / RefBase[ID] fasta load
    (src/PanDepth.cpp:885-896); chr2tid keeps the LAST tid per name
    (C++ map operator[] assignment)."""
    from pandepth_tpu_torch.io.fasta import iter_fasta_gc

    names: List[str] = []
    lengths: List[int] = []
    ref_by_tid = {}
    for name, gc in iter_fasta_gc(path):
        ref_by_tid[len(names)] = gc
        names.append(name)
        lengths.append(len(gc))
    chr2tid = {n: i for i, n in enumerate(names)}
    return names, np.asarray(lengths, np.int64), chr2tid, ref_by_tid
