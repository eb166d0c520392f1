"""Time the native feed's producer on its own: drain a BAM's
``NativeBamStream`` with ``take_enc_acc``, as ``feed.feed_stream`` does,
through the serial walk and the split walk in turns, and print one JSON
line a drain: its wall, the calling thread's wait on the producer, the
records and pairs, and the ``split``, ``read`` and ``kept`` shares.

Without a target file the stream is the whole file: the serial walk (no
cuts) against the index-cut split walk (the ``.bai``'s record starts).
With ``--gff genes.gff3`` (``-g``, features ``--feature``, default exon)
or ``--bed regions.bed`` (``-b``) it is the ranged stream of those
targets (the index's ranges, as ``feed.try_native_load`` makes them):
the serial ranged walk against the ranged split walk. ``--debug`` sets
``PANDEPTH_STREAM_DEBUG``, so the producer prints its per-window lines
and its summary to standard error.

    python3 tools/stream_probe.py BAM [--gff G | --bed B] [--threads 3]
        [--rounds 3] [--debug]

Host-only (no torch, no card): the numbers are the host CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pandepth_tpu_torch.io.bamindex import (  # noqa: E402
    load_index_for, merge_ranges, record_starts, window_chunks)
from pandepth_tpu_torch.io.native import NativeBamStream  # noqa: E402


def drain(bam: str, threads: int, serial: bool, **kw) -> dict:
    t0 = time.perf_counter()
    r = NativeBamStream(bam, kw.pop("flags", 1796), kw.pop("mapq", 0),
                        threads=threads, serial=serial, **kw)
    pairs = 0
    while (w := r.take_enc_acc(1 << 19, 1 << 13)) is not None:
        pairs += w[0]
    out = {"walk": "serial" if serial else "split", "threads": threads,
           "wall_s": time.perf_counter() - t0, "wait_s": r.wait_seconds(),
           "records": r.n_records, "pairs": pairs,
           "split": r.split_share(), "read": r.read_share(),
           "kept": r.kept_share()}
    r.close()
    return out


def ranged_stream(bam: str, target: str, flag: str, feature: str) -> dict:
    """The ranged stream's arguments for ``-g``/``-b`` ``target``: the
    read filter and its FLAG mask and MAPQ floor as a run takes them, the
    index's ranges and the chunk starts that cut them, as
    ``feed.try_native_load`` makes them."""
    from pandepth_tpu_torch import run
    from pandepth_tpu_torch.cli import parse_args

    cfg = parse_args(["pandepth", "-i", bam, flag, target, "-f", feature,
                      "-o", os.devnull])
    head = run.read_head(cfg)
    regions = run.read_regions(cfg, head.mode, head.targets, head.lengths,
                               bam, head.header)
    if regions is None or regions[3] != 1:
        raise SystemExit(f"{bam}: no indexed read filter for {target}")
    chunks = window_chunks(load_index_for(bam), regions)
    return {"flags": cfg.flags, "mapq": cfg.min_mapq, "regions": regions,
            "vranges": merge_ranges(chunks), "cuts": np.unique(chunks[:, 0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/stream_probe.py")
    p.add_argument("bam")
    p.add_argument("--gff")
    p.add_argument("--bed")
    p.add_argument("--feature", default="exon")
    p.add_argument("--threads", type=int, default=3)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--debug", action="store_true")
    a = p.parse_args(argv)
    if a.debug:
        os.environ["PANDEPTH_STREAM_DEBUG"] = "1"
    idx = load_index_for(a.bam)
    if idx is None:
        print(f"{a.bam}: no index", file=sys.stderr)
        return 1
    head = {"bam": a.bam, "bytes": os.path.getsize(a.bam),
            "cpus": os.cpu_count()}
    if a.gff or a.bed:
        t0 = time.perf_counter()
        serial = split = ranged_stream(
            a.bam, a.gff or a.bed, "-g" if a.gff else "-b", a.feature)
        head.update(ranges=int(split["vranges"].shape[0]),
                    windows=int(split["regions"][1].shape[0]),
                    query_s=time.perf_counter() - t0)
    else:
        serial, split = {}, {"cuts": record_starts(idx)}
        head.update(cuts=int(split["cuts"].shape[0]))
    print(json.dumps(head), flush=True)
    for k in range(a.rounds):
        # in turns: serial, split, split, serial, ...
        for s in ((True, False) if k % 2 == 0 else (False, True)):
            print(json.dumps(drain(a.bam, a.threads, s,
                                   **(serial if s else split))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
