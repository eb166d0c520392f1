"""ThreadSanitizer run of the port's libpancov_io split walk: the port's
pancov_io.cpp + tests/tsan_harness_torch.cpp built with -fsanitize=thread
and run on an indexed BAM with 3 threads. The harness streams the whole
file serially and in index-cut splits, and the ranges of a mode-1 region
filter serially and in ranged splits; each with cuts or ranges that stop
matching halfway (the fall back to the serial walk) and with a consumer
that closes the stream early. Any data race makes TSAN report and the
harness exit nonzero; a split walk whose codes, records or kept records
differ from the serial walk's fails the harness too."""

import os
import subprocess

import numpy as np
import pytest

from pandepth_tpu.io.bam_writer import write_bam
from tests.fixtures import random_reads

from pandepth_tpu_torch.io.bamindex import (load_index_for, merge_ranges,
                                            record_starts, window_chunks)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "pandepth_tpu_torch", "io", "native",
                    "pancov_io.cpp")
_HARNESS = os.path.join(_HERE, "tsan_harness_torch.cpp")


def _build(out: str):
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=thread", "-o",
           out, _SRC, _HARNESS, "-lz", "-lpthread"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    return None if r.returncode == 0 else r.stderr[-1500:]


def test_split_walk_under_tsan(tmp_path):
    harness = str(tmp_path / "harness")
    err = _build(harness)
    if err is not None:
        pytest.fail(f"TSAN build failed: {err}")

    contigs = [("chr1", 3_000_000), ("chr2", 2_000_000)]
    bam = str(tmp_path / "t.bam")
    # tens of 512 KB splits at the harness's 1 MB window
    write_bam(bam, [c[0] for c in contigs], [c[1] for c in contigs],
              random_reads(contigs, 40_000, 23))
    idx = load_index_for(bam)
    cuts = str(tmp_path / "cuts.i64")
    record_starts(idx).astype("<i8").tofile(cuts)
    assert np.fromfile(cuts, "<i8").shape[0] > 100
    # a 2 kb fetch window every 100 kb of each contig, more than a
    # block's reads apart: about one range a window, several a split
    starts = [np.arange(0, ln - 2_000, 100_000) for _, ln in contigs]
    off = np.concatenate(([0], np.cumsum([a.shape[0] for a in starts])))
    starts = np.concatenate(starts)
    windows = (off, starts, starts + 2_000, 1)
    vr = merge_ranges(window_chunks(idx, windows))
    assert vr.shape[0] > 30
    ranged = str(tmp_path / "ranged.i64")
    np.concatenate(([off.shape[0], starts.shape[0], vr.shape[0]], off,
                    starts, starts + 2_000, vr.reshape(-1))).astype(
        "<i8").tofile(ranged)
    env = dict(os.environ)
    env["TSAN_OPTIONS"] = "halt_on_error=1 exitcode=66"
    r = subprocess.run([harness, bam, cuts, ranged], capture_output=True,
                       text=True, timeout=600, env=env)
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-4000:]
    assert r.returncode == 0, (r.returncode, r.stderr[-4000:])
    assert "TSAN_HARNESS_OK" in r.stdout, r.stdout
