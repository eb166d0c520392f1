"""Time the native feed's producer on its own: drain a BAM's
``NativeBamStream`` with ``take_enc_acc``, as ``feed.feed_stream`` does,
through the serial walk and the split walk in turns, and print one JSON
line a drain: its wall, the calling thread's wait on the producer, the
records and pairs, the ``split``, ``read`` and ``kept`` shares, and the
seconds its threads spent inflating BGZF blocks (``inflate_s``, summed
over them) with the inflated GB/s that gives a thread (a whole-file
stream's: every block's ISIZE over ``inflate_s``).

Without a target file the stream is the whole file: the serial walk (no
cuts) against the index-cut split walk (the ``.bai``'s record starts).
With ``--gff genes.gff3`` (``-g``, features ``--feature``, default exon)
or ``--bed regions.bed`` (``-b``) it is the ranged stream of those
targets (the index's ranges, as ``feed.try_native_load`` makes them):
the serial ranged walk against the ranged split walk. ``--debug`` sets
``PANDEPTH_STREAM_DEBUG``, so the producer prints its per-window lines
and its summary to standard error.

``--inflate-only`` times the port's BGZF inflate (``pancov_inflate_raw``)
against Python's ``zlib`` (``zlib.decompress`` a block, which sets up and
tears down a zlib stream each time, as the feed did before it had its own
decoder) on one thread over every block of BAM, in turns block by block,
checks that their bytes agree, and prints one JSON line a round (any
BGZF file will do; it needs no index).

    python3 tools/stream_probe.py BAM [--gff G | --bed B] [--threads 3]
        [--rounds 3] [--debug]
    python3 tools/stream_probe.py BAM --inflate-only [--rounds 3]

Host-only (no torch, no card): the numbers are the host CPU's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import struct
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pandepth_tpu_torch.io.bamindex import (  # noqa: E402
    load_index_for, merge_ranges, record_starts, window_chunks)
from pandepth_tpu_torch.io.bgzf import iter_block_ranges  # noqa: E402
from pandepth_tpu_torch.io.native import (  # noqa: E402
    NativeBamStream, load_library)


def bgzf_blocks(data: bytes):
    """(payload offset, payload length, ISIZE) of every BGZF block."""
    return [(payload, off + bsize - 8 - payload,
             struct.unpack_from("<I", data, off + bsize - 4)[0])
            for off, bsize, payload in iter_block_ranges(data)]


def inflate_only(bam: str, rounds: int) -> None:
    lib = load_library()
    data = open(bam, "rb").read()
    blocks = [b for b in bgzf_blocks(data) if b[2]]
    src = ctypes.create_string_buffer(data, len(data))
    base = ctypes.addressof(src)
    dst = ctypes.create_string_buffer(1 << 16)
    out = ctypes.addressof(dst)
    view = memoryview(data)
    total = sum(b[2] for b in blocks)
    clock = time.perf_counter
    for k in range(rounds):
        port = theirs = 0.0
        for off, n, isize in blocks:
            t0 = clock()
            ok = lib.pancov_inflate_raw(base + off, n, out, isize)
            t1 = clock()
            ref = zlib.decompress(view[off: off + n], -15, isize)
            t2 = clock()
            port += t1 - t0
            theirs += t2 - t1
            if k == 0 and (not ok or dst.raw[:isize] != ref):
                raise SystemExit(f"{bam}: block at {off} differs from zlib")
        print(json.dumps({
            "mode": "inflate_only", "round": k, "blocks": len(blocks),
            "inflated_gb": total / 1e9, "port_s": port, "zlib_s": theirs,
            "port_gbps": total / port / 1e9,
            "zlib_gbps": total / theirs / 1e9, "speedup": theirs / port,
            "zlib": zlib.ZLIB_RUNTIME_VERSION}), flush=True)


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
           "kept": r.kept_share(), "inflate_s": r.inflate_seconds()}
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
    p.add_argument("--inflate-only", action="store_true")
    a = p.parse_args(argv)
    if a.inflate_only:
        inflate_only(a.bam, a.rounds)
        return 0
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
        with open(a.bam, "rb") as fh:
            inflated = sum(b[2] for b in bgzf_blocks(fh.read()))
        head.update(cuts=int(split["cuts"].shape[0]),
                    inflated_gb=inflated / 1e9)
    print(json.dumps(head), flush=True)
    for k in range(a.rounds):
        # in turns: serial, split, split, serial, ...
        for s in ((True, False) if k % 2 == 0 else (False, True)):
            line = drain(a.bam, a.threads, s, **(serial if s else split))
            if "inflated_gb" in head and line["inflate_s"] > 0:
                line["inflate_gbps"] = head["inflated_gb"] / line["inflate_s"]
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
