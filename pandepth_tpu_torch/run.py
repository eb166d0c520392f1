"""The run on PyTorch: ``pandepth -i x.{bam,sam,sam.gz,cram,paf[.gz]}
-o out``, or ``-i files.list`` (several samples pooled into one table),
in chr mode, or with ``-g``/``-b`` targets or ``-w`` windows of 150 bp
and more.

It composes the jax-free helpers of ``pandepth_tpu.run`` around the
port's :class:`~pandepth_tpu_torch.device.engine.CoverageEngine`: the
header read, the target synthesis, the fetch-window and region-cursor
read filters, the native loaders and their feed (encoded windows or raw
pairs, as the engine elects), the Python decoders, the PAF loaders, and
the table writer. Alignment inputs are fed in
``pandepth_tpu.run.run_alignment``'s order, every member of a ``.list``
in the first file's contig space; PAF inputs as
``pandepth_tpu.run.run_paf`` feeds them. Inputs and flags outside this
slice exit non-zero with a message naming the ROADMAP.md item that
ports it; the run is never handed to the JAX package.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

from pandepth_tpu.config import MODE_WIN_SMALL, RunConfig
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import BamHeader, ReadBatch
from pandepth_tpu.io.fasta import load_ref_bases
from pandepth_tpu.io.paf import iter_paf_events, paf_contig_table
from pandepth_tpu.io.sam_text import SamReader
from pandepth_tpu.run import (_cheap_header, _feed_stream,
                              _filter_batch_to_windows,
                              _finalize_and_write, _intervals_in_windows,
                              _prepare_targets, _RegionCursor,
                              _try_native_load, index_present, is_paf,
                              open_alignment, paf_contigs_from_fasta)
from pandepth_tpu.targets.model import TargetSet
from pandepth_tpu.utils.log import RunStats, phase, set_verbose
from pandepth_tpu_torch.device.engine import CoverageEngine


class Unported(Exception):
    """An input or flag outside this slice; the message names the
    ROADMAP.md item that will port it."""


class NativeFeedError(RuntimeError):
    """libpancov_io, or its loader for a BAM, failed without
    ``PANDEPTH_NO_NATIVE=1``: the run does not fall back onto the Python
    decoders."""


class Staged(NamedTuple):
    """A run up to its feed (:func:`prepare`) or its finalize
    (:func:`stage`): the targets, the engine, and what the feed reads."""
    engine: CoverageEngine
    mode: int
    targets: TargetSet
    names: List[str]
    lengths: np.ndarray
    ref_bases: Optional[Dict[int, bytes]]
    regions: Optional[tuple]     # the read filter, see read_regions
    reader: Optional[object]     # the open SAM or CRAM reader


def unported(config: RunConfig) -> Optional[str]:
    """What of ``config`` this slice cannot run, or None."""
    if config.site_output:
        return "-a (ROADMAP.md queue 1, item 3)"
    if 0 < config.win_size < 150:
        return "-w below 150 (ROADMAP.md queue 1, item 3)"
    if os.environ.get("PANDEPTH_MULTIHOST") == "1":
        return "multi-host runs (ROADMAP.md queue 1, item 7)"
    return None


def _native_wanted() -> bool:
    """The native library feeds every run unless ``PANDEPTH_NO_NATIVE=1``
    asks for the Python decoders."""
    return os.environ.get("PANDEPTH_NO_NATIVE") != "1"


def _load_native() -> None:
    """Build (on first use) and load libpancov_io, the native feed; a
    library that does not build or load raises."""
    from pandepth_tpu.io import native

    try:
        lib = native.load_library()
    except OSError as e:
        raise NativeFeedError(f"libpancov_io does not load: {e}") from e
    if lib is None:
        raise NativeFeedError(f"libpancov_io unavailable: "
                              f"{native.build_error()}")


def read_regions(config: RunConfig, mode: int, targets: TargetSet,
                 lengths: np.ndarray, path: str,
                 header: Optional[BamHeader]):
    """The read filter of a targeted run, as
    ``pandepth_tpu.run.run_alignment``'s ``regions_for`` decides it:
    indexed input -> the fetch windows (tag 1); no index but
    coordinate-sorted -> the region cursor (tag 2); otherwise (and in
    chr and window modes) None, every read counts."""
    if mode not in (1, 2, 3, 4):
        return None
    if index_present(path) and config.use_index:
        return (*targets.fetch_windows(lengths), 1)
    if header is not None and header.sort_order == "coordinate":
        return (*targets.merged_spans(len(lengths)), 2)
    return None


def read_batches(path: str, config: RunConfig, regions=None,
                 reader=None, n_targets: Optional[int] = None
                 ) -> Iterator[ReadBatch]:
    """The columnar batches that the CIGAR feed hands to
    ``CoverageEngine.add_batch``: ``reader``'s (by default the Python
    decoder that ``open_alignment`` picks for ``path``), at most
    ``config.max_reads_per_batch`` reads each, with reads outside
    ``regions`` marked tid = -1. A later member of a ``.list`` passes
    ``n_targets``, the first file's contig count: its reads on a tid past
    that are marked -1 too."""
    r = reader if reader is not None else open_alignment(
        path, threads=config.threads)
    cursor = _RegionCursor(regions) if regions is not None and \
        regions[3] == 2 else None
    for batch in r.batches(max_reads=config.max_reads_per_batch):
        if n_targets is not None:
            batch.tid[batch.tid >= n_targets] = -1
        if cursor is not None:
            cursor.filter_batch(batch, config.flags, config.min_mapq)
        elif regions is not None:
            _filter_batch_to_windows(batch, regions)
        yield batch


def _feed_sam_native(engine: CoverageEngine, path: str, config: RunConfig,
                     names: List[str]) -> None:
    """SAM text parsed straight to events by libpancov_io."""
    from pandepth_tpu.io.native import NativePafLoad

    sl = NativePafLoad(path, config.flags, config.min_mapq, names,
                       engine.layout.offsets, engine.layout.limits,
                       kind="sam")
    if engine.pos_bits32:
        s32, e32 = sl.events32_padded(max(sl.n_events, 1),
                                      engine.pos_sentinel32)
        engine.add_padded_events(s32.view(engine.pos_dtype),
                                 e32.view(engine.pos_dtype))
    else:
        engine.add_start_end(*sl.events64())
    engine.n_reads_seen += sl.n_lines
    sl.close()


def _feed_cram_intervals(engine: CoverageEngine, r, path: str,
                         config: RunConfig, regions) -> bool:
    """Vectorised CRAM slices -> aligned-run intervals (indexed runs read
    only the containers the .crai selects). False when the decoder
    rejects a slice (``CramVectorFallback``) before anything was added."""
    from pandepth_tpu.io.cram import (CramVectorFallback,
                                      crai_select_offsets, load_crai)

    crai_offsets = None
    if regions is not None and regions[3] == 1:
        crai = load_crai(path + ".crai")
        if crai is not None:
            crai_offsets = crai_select_offsets(crai, regions)
    if regions is not None and crai_offsets is None:
        return False
    try:
        collected = list(r.interval_batches(offsets=crai_offsets))
    except CramVectorFallback:
        return False
    n_targets = engine.layout.n_targets
    for (tid_a, flag_a, mapq_a, s0, e0, n_rec, read_lo,
         read_hi) in collected:
        keep = (flag_a & config.flags) == 0
        if config.min_mapq >= 1:
            keep &= mapq_a >= config.min_mapq
        keep &= (tid_a >= 0) & (tid_a < n_targets)
        if crai_offsets is not None:
            keep &= _intervals_in_windows(tid_a, read_lo, read_hi, regions)
        engine.add_intervals(tid_a[keep], s0[keep], e0[keep])
        engine.n_reads_seen += n_rec
    return True


def feed(engine: CoverageEngine, path: str, config: RunConfig,
         names: List[str], regions, reader=None, member: int = 0) -> None:
    """Every event of ``path`` into ``engine``, by the first feed that
    takes it: the native stream (encoded windows or raw pairs, as the
    engine elects), the native one-shot loader, native SAM text,
    vectorised CRAM, then the Python decoders' batches into the
    ``extract_events`` kernel. ``reader`` is the already open reader of
    a SAM or CRAM input; without one, ``path`` is a BAM, and unless
    ``PANDEPTH_NO_NATIVE=1`` a native loader that fails raises.
    ``member`` > 0 is a later file of a ``.list``, read in the first
    file's contig space (the reference's quirk Q5)."""
    later = {} if member == 0 else {"ext_offsets": engine.layout.offsets,
                                    "ext_limits": engine.layout.limits}
    r = reader
    if r is None:
        if _native_wanted():
            r = _try_native_load(path, config, regions=regions, **later)
            if r is None:
                raise NativeFeedError(
                    f"libpancov_io's loader cannot read the BAM {path} "
                    f"(set PANDEPTH_NO_NATIVE=1 for the Python decoder)")
        else:
            r = open_alignment(path, threads=config.threads)
    if hasattr(r, "wait") and hasattr(r, "take32"):
        _feed_stream(engine, r)
        return
    if hasattr(r, "events"):
        if engine.pos_bits32 and hasattr(r, "events32_padded"):
            s32, e32, _m = r.events32_padded(max(r.n_events, 1),
                                             engine.pos_sentinel32)
            engine.add_padded_events(s32.view(engine.pos_dtype),
                                     e32.view(engine.pos_dtype))
        else:
            engine.add_start_end(*r.events())
        engine.n_reads_seen += r.n_records
        r.close()
        return
    if regions is None and isinstance(r, SamReader) and _native_wanted():
        _feed_sam_native(engine, path, config, names)
        return
    if hasattr(r, "interval_batches") and \
            _feed_cram_intervals(engine, r, path, config, regions):
        return
    for batch in read_batches(path, config, regions, reader=r,
                              n_targets=engine.layout.n_targets
                              if member else None):
        engine.add_batch(batch)


def prepare(config: RunConfig, device,
            stats: Optional[RunStats] = None) -> Staged:
    """Read the header (of the first file of a ``.list``), prepare the
    targets and the read filter, and make an empty engine on ``device``.
    A PAF run's contig table comes from ``-r``'s FASTA or the first PAF
    file. Raises :class:`Unported` for inputs and flags outside this
    slice."""
    what = unported(config)
    if what is not None:
        raise Unported(what)
    if _native_wanted():
        _load_native()
    if is_paf(config.inputs[0]):
        return _prepare_paf(config, device, stats)
    path = config.inputs[0]
    header = _cheap_header(path)
    reader = None
    if header is None:  # SAM text or CRAM
        with phase(stats, "open"):
            reader = open_alignment(path, threads=config.threads)
        header = reader.header
    names, lengths = header.names, header.lengths
    ref_bases = None
    if config.gc:
        ref_bases = load_ref_bases(config.reference, header.name_to_tid())

    with phase(stats, "targets"):
        mode, targets = _prepare_targets(config, names, lengths,
                                         header.name_to_tid(), ref_bases)
    if mode == MODE_WIN_SMALL:
        raise Unported("-w below 150 (ROADMAP.md queue 1, item 3)")
    # the reference's 18-bit depth cells (quirk Q1), decided exactly as
    # pandepth_tpu.run.run_alignment decides it: without a usable index,
    # and in multi-file runs
    wrap18 = not (index_present(path) and config.use_index) \
        or len(config.inputs) > 1
    engine = CoverageEngine(GenomeLayout(lengths), flags_mask=config.flags,
                            min_mapq=config.min_mapq,
                            min_dep=config.min_depth, wrap18=wrap18,
                            device=device)
    return Staged(engine, mode, targets, names, lengths, ref_bases,
                  read_regions(config, mode, targets, lengths, path,
                               header), reader)


def _prepare_paf(config: RunConfig, device,
                 stats: Optional[RunStats]) -> Staged:
    """:func:`prepare` for PAF input, as ``pandepth_tpu.run.run_paf``:
    ``-r`` alone gives the contig table and the GC columns; without it
    the table is the first file's (the reference scans only that one)."""
    ref_bases = None
    if config.reference:
        names, lengths, chr2tid, ref_bases = \
            paf_contigs_from_fasta(config.reference)
    else:
        names, lengths = paf_contig_table(config.inputs[:1])
        chr2tid = {n: i for i, n in enumerate(names)}
    with phase(stats, "targets"):
        mode, targets = _prepare_targets(config, names, lengths, chr2tid,
                                         ref_bases)
    if mode == MODE_WIN_SMALL:
        raise Unported("-w below 150 (ROADMAP.md queue 1, item 3)")
    engine = CoverageEngine(GenomeLayout(lengths), flags_mask=config.flags,
                            min_mapq=config.min_mapq,
                            min_dep=config.min_depth, wrap18=True,
                            device=device)
    return Staged(engine, mode, targets, names, lengths, ref_bases, None,
                  None)


def feed_paf(engine: CoverageEngine, path: str, config: RunConfig,
             names: List[str]) -> None:
    """A PAF file's aligned runs into ``engine``: libpancov_io's PAF
    loader, or with ``PANDEPTH_NO_NATIVE=1`` the Python one."""
    if not _native_wanted():
        chr2tid = {n: i for i, n in enumerate(names)}
        for tid, s, e in iter_paf_events(path, chr2tid, config.flags,
                                         config.min_mapq):
            engine.add_intervals(tid, s, e)
        return
    from pandepth_tpu.io.native import NativePafLoad

    pl = NativePafLoad(path, config.flags, config.min_mapq, names,
                       engine.layout.offsets, engine.layout.limits)
    if engine.pos_bits32:
        s32, e32 = pl.events32_padded(max(pl.n_events, 1),
                                      engine.pos_sentinel32)
        engine.add_padded_events(s32.view(engine.pos_dtype),
                                 e32.view(engine.pos_dtype))
    else:
        engine.add_start_end(*pl.events64())
    pl.close()


def stage(config: RunConfig, device,
          stats: Optional[RunStats] = None) -> Staged:
    """:func:`prepare`, then feed every event of every input file into
    the engine."""
    st = prepare(config, device, stats)
    paf = is_paf(config.inputs[0])
    with phase(stats, "feed"):
        for i, path in enumerate(config.inputs):
            if paf:
                feed_paf(st.engine, path, config, st.names)
            elif i == 0:
                feed(st.engine, path, config, st.names, st.regions,
                     st.reader)
            else:
                header = _cheap_header(path)
                reader = None
                if header is None:  # SAM text or CRAM
                    reader = open_alignment(path, threads=config.threads)
                    header = getattr(reader, "header", None)
                feed(st.engine, path, config, st.names,
                     read_regions(config, st.mode, st.targets, st.lengths,
                                  path, header), reader, member=i)
    return st


def run(config: RunConfig, device) -> int:
    if not config.inputs or not config.out_prefix:
        print("Error: lack argument -i or -o ", file=sys.stderr)
        return 1
    if config.verbose:
        set_verbose(True)
    if config.gc and not config.reference:
        print("Error: lack reference sequence (-r) for GC parse",
              file=sys.stderr)
        return 1
    if len(config.inputs) > 1:
        print("INFO: Run multi-file data ")
    elif is_paf(config.inputs[0]):
        print("INFO: Run paf Format data ")
    stats = RunStats()
    try:
        st = stage(config, device, stats)
    except Unported as e:
        print(f"Error: pandepth_tpu_torch does not run {e} yet",
              file=sys.stderr)
        return 2
    except NativeFeedError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print("INFO: Input data read done")
    stats.reads_seen = st.engine.n_reads_seen
    with phase(stats, "stats+write"):
        _finalize_and_write(config, st.engine, st.mode, st.targets, st.names,
                            st.lengths, st.ref_bases is not None,
                            st.ref_bases, stats)
    stats.emit()
    return 0
