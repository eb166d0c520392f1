"""Time the native feed's producer on its own: drain a BAM's
``NativeBamStream`` with ``take_enc_acc``, as ``feed.feed_stream`` does,
through the serial walk (no cuts) and the index-cut split walk (the
``.bai``'s record starts) in turns, and print one JSON line a drain: its
wall, the calling thread's wait on the producer, the pairs and the split
share. ``--debug`` sets ``PANDEPTH_STREAM_DEBUG``, so the producer prints
its per-window lines and its summary to standard error.

    python3 tools/stream_probe.py BAM [--threads 3] [--rounds 3] [--debug]

Host-only (no torch, no card): the numbers are the host CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pandepth_tpu_torch.io.bamindex import (  # noqa: E402
    load_index_for, record_starts)
from pandepth_tpu_torch.io.native import NativeBamStream  # noqa: E402


def drain(bam: str, threads: int, cuts) -> dict:
    t0 = time.perf_counter()
    r = NativeBamStream(bam, 1796, 0, threads=threads, cuts=cuts)
    pairs = 0
    while (w := r.take_enc_acc(1 << 19, 1 << 13)) is not None:
        pairs += w[0]
    out = {"walk": "serial" if cuts is None else "split",
           "threads": threads, "wall_s": time.perf_counter() - t0,
           "wait_s": r.wait_seconds(), "pairs": pairs,
           "records": r.n_records, "split_share": r.split_share()}
    r.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/stream_probe.py")
    p.add_argument("bam")
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
    cuts = record_starts(idx)
    print(json.dumps({"bam": a.bam, "bytes": os.path.getsize(a.bam),
                      "cuts": int(cuts.shape[0]),
                      "cpus": os.cpu_count()}), flush=True)
    for k in range(a.rounds):
        # in turns: serial, split, split, serial, ...
        for c in ((None, cuts) if k % 2 == 0 else (cuts, None)):
            print(json.dumps(drain(a.bam, a.threads, c)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
