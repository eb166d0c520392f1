"""The chr-mode run on PyTorch: ``pandepth -i x.bam -o out`` with one
indexed (or unindexed) BAM and no target flags.

It composes the jax-free helpers of ``pandepth_tpu.run`` around the
port's :class:`~pandepth_tpu_torch.device.engine.CoverageEngine`: the
cheap header read, the target synthesis, the native streaming loader and
its feed, and the table writer. Inputs and flags outside this slice exit
non-zero with a message naming the ROADMAP.md item that ports it; the
run is never handed to the JAX package.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from pandepth_tpu.config import MODE_WIN_SMALL, RunConfig
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.fasta import load_ref_bases
from pandepth_tpu.run import (_cheap_header, _feed_stream,
                              _finalize_and_write, _prepare_targets,
                              _try_native_load, index_present, is_paf)
from pandepth_tpu.targets.model import TargetSet
from pandepth_tpu.utils.log import RunStats, phase, set_verbose
from pandepth_tpu_torch.device.engine import CoverageEngine


class Unported(Exception):
    """An input or flag outside this slice; the message names the
    ROADMAP.md item that will port it."""


class Staged(NamedTuple):
    """A chr-mode run up to its finalize: the targets, and the engine fed
    with every event of the input."""
    engine: CoverageEngine
    mode: int
    targets: TargetSet
    names: List[str]
    lengths: np.ndarray
    ref_bases: Optional[Dict[int, bytes]]


def unported(config: RunConfig) -> Optional[str]:
    """What of ``config`` this slice cannot run, or None."""
    if len(config.inputs) > 1:
        return "multi-file (.list) input (ROADMAP.md queue 1, item 4)"
    if is_paf(config.inputs[0]):
        return "PAF input (ROADMAP.md queue 1, item 4)"
    if config.site_output:
        return "-a (ROADMAP.md queue 1, item 3)"
    if config.target_file:
        return "-g/-b targets (ROADMAP.md queue 1, item 2)"
    if config.win_size:
        return ("-w windows (ROADMAP.md queue 1, item 2; "
                "-w below 150 in item 3)")
    if os.environ.get("PANDEPTH_NO_NATIVE") == "1":
        return ("PANDEPTH_NO_NATIVE=1, the Python decoders' CIGAR feed "
                "(ROADMAP.md queue 1, item 5)")
    if os.environ.get("PANDEPTH_MULTIHOST") == "1":
        return "multi-host runs (ROADMAP.md queue 1, item 7)"
    return None


def _load_native() -> None:
    """Build (on first use) and load libpancov_io, the native feed; a
    library that does not build or load raises."""
    from pandepth_tpu.io import native

    try:
        lib = native.load_library()
    except OSError as e:
        raise RuntimeError(f"libpancov_io does not load: {e}") from e
    if lib is None:
        raise RuntimeError(f"libpancov_io unavailable: "
                           f"{native.build_error()}")


def stage(config: RunConfig, device,
          stats: Optional[RunStats] = None) -> Staged:
    """Read the header, prepare the chr targets and feed every event of
    ``config.inputs[0]`` into a new engine on ``device``. Raises
    :class:`Unported` for inputs and flags outside this slice."""
    what = unported(config)
    if what is not None:
        raise Unported(what)
    path = config.inputs[0]
    header = _cheap_header(path)
    if header is None:
        raise Unported("SAM text or CRAM input, the CIGAR feed "
                       "(ROADMAP.md queue 1, item 5)")
    names, lengths = header.names, header.lengths
    ref_bases = None
    if config.gc:
        ref_bases = load_ref_bases(config.reference, header.name_to_tid())

    with phase(stats, "targets"):
        mode, targets = _prepare_targets(config, names, lengths,
                                         header.name_to_tid(), ref_bases)
    # the reference's 18-bit depth cells (quirk Q1), decided exactly as
    # pandepth_tpu.run.run_alignment decides it
    has_index = index_present(path) and config.use_index
    wrap18 = (config.site_output or mode == MODE_WIN_SMALL
              or not has_index or len(config.inputs) > 1)

    _load_native()
    reader = _try_native_load(path, config)
    if reader is None or not hasattr(reader, "take32"):
        raise Unported("this BAM without the native streaming loader "
                       "(ROADMAP.md queue 1, item 5)")
    engine = CoverageEngine(GenomeLayout(lengths), flags_mask=config.flags,
                            min_mapq=config.min_mapq,
                            min_dep=config.min_depth, wrap18=wrap18,
                            device=device)
    with phase(stats, "feed"):
        _feed_stream(engine, reader)
    return Staged(engine, mode, targets, names, lengths, ref_bases)


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
    stats = RunStats()
    try:
        st = stage(config, device, stats)
    except Unported as e:
        print(f"Error: pandepth_tpu_torch does not run {e} yet",
              file=sys.stderr)
        return 2
    print("INFO: Input data read done")
    stats.reads_seen = st.engine.n_reads_seen
    with phase(stats, "stats+write"):
        _finalize_and_write(config, st.engine, st.mode, st.targets, st.names,
                            st.lengths, config.gc, st.ref_bases, stats)
    stats.emit()
    return 0
