"""The port's ranged stream walked in splits against its serial walk.

A ranged stream (a mode-1 region filter and the index's (v0, v1) ranges)
reads only its ranges, each from its first block to the end of its end
block, and walks each range's records from v0 while they start below v1.
The split walk hands runs of ranges to every thread
(``StreamBam::walk_splits``); ``NativeBamStream(serial=True)`` walks the
same ranges on one thread (``walk_serial``). On the same ranges both must
give the same events in the same order, the same records decoded and the
same records kept, and a split that fails (a corrupt block, a range that
does not end where the index says) must leave the stream with the serial
walk's events or error.

The BAMs are laid out block by block (``test_torch_ranged_walk``'s
writer), small blocks of ~4 records each, so that a case can name the
records and blocks its ranges start and end in. A capsicum_exon-shaped
input is also run through the CLI, its gene table held byte-equal to
``portbench/reference/pandepth.py``.
"""

import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from tests import test_torch_ranged_walk as layout
from tests.fixtures import gunzip_bytes

from portbench.inputs import cache
from portbench.tests.small import small_cell
from pandepth_tpu_torch.io.bam_writer import _write_bai_from_voffsets
from pandepth_tpu_torch.io.bamindex import (load_index_for, merge_ranges,
                                            record_starts, window_chunks)
from pandepth_tpu_torch.io.bgzf import BGZF_EOF
from pandepth_tpu_torch.io.native import NativeBamStream, load_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTIGS = [("chr1", 30_000), ("chr2", 20_000), ("chrM", 6_000)]
STEP = 4           # bases between two reads' starts
BLOCK = 1_000      # a block's inflated bytes (the last one's fewer)
WINDOW = 1 << 20   # the stream's window: the splits' sizes follow it
REC = layout.REC


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """An indexed BAM of reads every STEP bases over every contig, the
    last ones past its end, in blocks of BLOCK inflated bytes: each
    record's (v0, v1), block and tid; the path; each block's compressed
    offset."""
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    tid = np.concatenate([np.full(ln // STEP, t, np.int64)
                          for t, (_, ln) in enumerate(CONTIGS)])
    pos = np.concatenate([np.arange(0, ln, STEP, dtype=np.int64)
                          for _, ln in CONTIGS])
    n = tid.shape[0]
    flag = np.where(np.arange(n) % 17 == 5, 1024, 0).astype(np.int64)
    body, bins = layout._body(tid, pos, flag)
    rec = np.frombuffer(body, np.uint8).reshape(n, REC).copy()
    rec[:, 13] = np.array([0, 10, 30, 60], np.uint8)[np.arange(n) % 4]
    body = rec.tobytes()
    sizes = [BLOCK] * (len(body) // BLOCK)
    if len(body) % BLOCK:
        sizes.append(len(body) % BLOCK)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in CONTIGS)
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode() + \
        struct.pack("<i", len(CONTIGS))
    for nm, ln in CONTIGS:
        nb = nm.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    hdr = layout._block(hdr, 6)
    cut = np.concatenate(([0], np.cumsum(sizes)))
    blocks = [layout._block(body[a:b], 6) for a, b in zip(cut[:-1], cut[1:])]
    path = str(tmp_path_factory.mktemp("ranged") / "s.bam")
    with open(path, "wb") as fh:
        fh.write(hdr + b"".join(blocks) + BGZF_EOF)
    f_start = len(hdr) + np.concatenate(
        ([0], np.cumsum([len(b) for b in blocks])))
    u0 = np.arange(n, dtype=np.int64) * REC
    k0 = np.searchsorted(cut[:-1], u0, side="right") - 1
    k1 = np.searchsorted(cut[:-1], u0 + REC - 1, side="right") - 1
    v0 = (f_start[k0] << 16) | (u0 - cut[k0])
    v1 = (f_start[k1] << 16) | (u0 + REC - cut[k1])
    _write_bai_from_voffsets(path + ".bai", len(CONTIGS), tid, pos,
                             pos + layout.SPAN, bins, v0, v1)
    return {"path": path, "v0": v0, "v1": v1, "b0": k0, "b1": k1,
            "tid": tid, "f_start": f_start, "isize": np.array(sizes)}


def _windows(every=600, width=250):
    """A mode-1 read filter: a window of ``width`` bases every ``every``
    bases of each contig, its last ending at the contig's end."""
    starts = [np.concatenate((np.arange(0, ln - width, every),
                              [ln - width])) for _, ln in CONTIGS]
    off = np.concatenate(([0], np.cumsum([s.shape[0] for s in starts])))
    starts = np.concatenate(starts).astype(np.int64)
    return off, starts, starts + width, 1


def _pairs(bam, a, b):
    """Ranges from record a[i] to record b[i] (inclusive)."""
    return np.stack([bam["v0"][a], bam["v1"][b]], axis=1)


def _one_range(bam):
    return _pairs(bam, [0], [bam["v0"].shape[0] - 1])


def _one_block_ranges(bam):
    """A range a block: the first record that starts and ends in it."""
    whole = np.flatnonzero(bam["b0"] == bam["b1"])
    _, first = np.unique(bam["b0"][whole], return_index=True)
    r = whole[first]
    assert r.shape[0] > 2_000
    return _pairs(bam, r, r)


def _shared_block(bam):
    """Every third record alone: ranges that share blocks (the stream
    joins them), most of them starting mid-block."""
    r = np.arange(0, bam["v0"].shape[0], 3)
    return _pairs(bam, r, r)


def _straddle(bam):
    """Ranges whose last record starts in one block and ends in the
    next, their end block, and ranges whose first record does."""
    s = np.flatnonzero(bam["b0"] != bam["b1"])[5::40]
    ends = _pairs(bam, s - 3, s)
    starts = _pairs(bam, s + 20, s + 24)
    return np.concatenate((ends, starts))


def _mid_block(bam):
    """Ranges of six records whose v0 is inside a block, every 50th."""
    r = np.flatnonzero(bam["v0"] & 0xFFFF)[::50]
    r = r[r + 5 < bam["v0"].shape[0]]
    return _pairs(bam, r, r + 5)


def _last_block(bam):
    """A few ranges, the last ending on the file's last record (in its
    last block)."""
    n = bam["v0"].shape[0]
    return _pairs(bam, [100, 2_000, n - 30], [150, 2_100, n - 1])


def _next_block_form(bam):
    """Ranges ending on a block's end, written as the next block's start
    (offset 0), as htslib writes a chunk whose last record filled its
    block."""
    at_end = np.flatnonzero(
        (bam["v1"] & 0xFFFF) == bam["isize"][bam["b1"]])
    at_end = at_end[bam["b1"][at_end] + 1 < bam["isize"].shape[0]][::3]
    assert at_end.shape[0] > 1
    r = _pairs(bam, at_end - 2, at_end)
    r[:, 1] = bam["f_start"][bam["b1"][at_end] + 1] << 16
    return r


def _contig_ends(bam):
    """The index's ranges for windows at each contig's start and end."""
    starts, ends, off = [], [], [0]
    for _, ln in CONTIGS:
        starts += [0, ln - 300]
        ends += [200, ln]
        off.append(len(starts))
    windows = (np.array(off), np.array(starts), np.array(ends), 1)
    idx = load_index_for(bam["path"])
    return merge_ranges(window_chunks(idx, windows)), windows


RANGES = {"one_range": _one_range, "one_block_ranges": _one_block_ranges,
          "shared_block": _shared_block, "straddle": _straddle,
          "mid_block": _mid_block, "last_block": _last_block,
          "next_block_form": _next_block_form, "contig_ends": _contig_ends}


def _drain(r):
    """Every window's events, concatenated; records; the split, read and
    kept shares; the final progress."""
    es, ee = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    while True:
        n = r.wait()
        if n < 0:
            break
        s, e = r.take64(n)
        es.append(s)
        ee.append(e)
    out = (np.concatenate(es), np.concatenate(ee), r.n_records,
           r.split_share(), r.read_share(), r.kept_share(), r.progress())
    r.close()
    return out


def _two(bam, vr, windows, threads, flags=1796, mapq=0, cuts=None):
    """(split walk, serial walk) of ``vr`` under ``windows``; the split
    walk cuts a long range at ``cuts``."""
    kw = dict(threads=threads, window_bytes=WINDOW, regions=windows,
              vranges=vr)
    return [_drain(NativeBamStream(bam["path"], flags, mapq, serial=s,
                                   cuts=None if s else cuts, **kw))
            for s in (False, True)]


def _assert_same(split, serial, cut=False):
    """The same events, records and kept records; a split walk whose
    ranges were cut reads the blocks that hold its cuts twice."""
    assert np.array_equal(split[0], serial[0])
    assert np.array_equal(split[1], serial[1])
    assert split[2] == serial[2] > 0
    assert split[5:] == serial[5:]
    assert split[4] >= serial[4] if cut else split[4] == serial[4]


@pytest.mark.parametrize("flags,mapq", [(1796, 0), (0, 30)])
@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("case", sorted(RANGES))
def test_ranged_splits_equal_serial_walk(bam, case, cut, threads, flags,
                                         mapq):
    """Each case's ranges, as they are and (``cut``) with the index's
    record starts to cut a range longer than a split."""
    vr = RANGES[case](bam)
    windows = _windows()
    if isinstance(vr, tuple):
        vr, windows = vr
    cuts = record_starts(load_index_for(bam["path"])) if cut else None
    split, serial = _two(bam, vr, windows, threads, flags, mapq, cuts)
    _assert_same(split, serial, cut)
    assert split[3] == 1.0 and serial[3] == 0.0
    assert split[0].shape[0] > 0 and 0.0 < split[5] < 1.0
    assert split[6][0] == 1.0


def test_long_range_is_cut(bam, capfd, monkeypatch):
    """One range over the whole file, longer than a split: without cuts
    it is one split; with the index's record starts it is walked in many
    splits, each ending on its cut."""
    monkeypatch.setenv("PANDEPTH_STREAM_DEBUG", "1")
    cuts = record_starts(load_index_for(bam["path"]))
    for c in (None, cuts):
        capfd.readouterr()
        split, serial = _two(bam, _one_range(bam), _windows(), 3,
                             cuts=c)
        m = re.search(r"\[stream\] splits=(\d+) walked=(\d+) threads=3 ",
                      capfd.readouterr().err)
        _assert_same(split, serial, c is not None)
        if c is None:
            assert m.group(1) == "1"
        else:
            assert int(m.group(1)) == int(m.group(2)) >= 5
            assert split[3] == 1.0


def _corrupt(bam, tmp_path, at):
    """A copy of the BAM (and its index) whose block at compressed offset
    ``at`` no longer inflates: its deflate data starts with a reserved
    block type."""
    path = str(tmp_path / "c.bam")
    with open(bam["path"], "rb") as fh:
        data = bytearray(fh.read())
    data[at + 18] = 0x07
    with open(path, "wb") as fh:
        fh.write(data)
    with open(bam["path"] + ".bai", "rb") as src, \
            open(path + ".bai", "wb") as dst:
        dst.write(src.read())
    return dict(bam, path=path)


def _failure(bam, vr, windows, threads, serial):
    r = NativeBamStream(bam["path"], 1796, 0, threads=threads,
                        window_bytes=WINDOW, regions=windows, vranges=vr,
                        serial=serial)
    with pytest.raises(ValueError) as e:
        _drain(r)
    r.close()
    return str(e.value)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("fault", ["corrupt_block", "bad_v0", "shifted_v1",
                                   "shifted_cut"])
def test_failed_split_ends_as_the_serial_walk(bam, tmp_path, fault,
                                              threads):
    """A split whose walk fails hands the stream to the serial walk from
    the split's start: a corrupt block inside a range and a range that
    starts off a block end end in the serial walk's error; ranges whose
    ends are one byte off, or cuts inside a long range one byte off after
    its middle (neither of which a split can end on), in its events."""
    vr = _one_block_ranges(bam)
    windows = _windows()
    half = vr.shape[0] // 2
    cuts = None
    if fault == "corrupt_block":
        bam = _corrupt(bam, tmp_path, int(vr[half, 0] >> 16))
    elif fault == "bad_v0":
        vr[half, 1] = vr[half + 1, 1]
        vr[half, 0] += 1 << 16
    if fault in ("corrupt_block", "bad_v0"):
        msgs = [_failure(bam, vr, windows, threads, s) for s in (False, True)]
        assert msgs[0] == msgs[1]
        assert ("inflate" if fault == "corrupt_block" else "framing") in \
            msgs[0]
        return
    if fault == "shifted_v1":
        vr[half:, 1] += 1
    else:
        vr = _one_range(bam)
        cuts = record_starts(load_index_for(bam["path"]))
        cuts[cuts.shape[0] // 2:] += 1
    split, serial = _two(bam, vr, windows, threads, cuts=cuts)
    _assert_same(split, serial, cuts is not None)
    assert 0.0 < split[3] < 1.0 and serial[3] == 0.0


@pytest.mark.parametrize("case", sorted(layout.CASES))
def test_cap_layouts(tmp_path, case):
    """``test_torch_ranged_walk``'s layouts, whose serial walk meets its
    decompressed cap at a 1 MiB window in a chosen way: the ranged split
    walk of chr1's reads (one range, cut at its chunks' starts as the
    feed cuts it) equals the serial ranged walk, which stays held at the
    cap by this test (the CLI runs there take the split walk)."""
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    tid, pos, flag, bins, sizes, hdr, blocks, _ = layout.CASES[case]()
    path = str(tmp_path / "s.bam")
    layout._write(path, tid, pos, flag, bins, sizes, hdr, blocks, True)
    windows = (np.array([0, 1, 1]), np.array([0]),
               np.array([layout.CONTIGS[0][1]]), 1)
    chunks = window_chunks(load_index_for(path), windows)
    split, serial = _two({"path": path}, merge_ranges(chunks), windows, 3,
                         cuts=np.unique(chunks[:, 0]))
    _assert_same(split, serial, True)
    assert split[2] == np.count_nonzero(tid == 0)
    assert split[3] == 1.0 and serial[3] == 0.0


def _phase(err, name):
    m = re.findall(rf"^INFO: phase {re.escape(name)}: ([0-9.]+)s$", err,
                   re.M)
    assert len(m) == 1, err[-3000:]
    return float(m[0])


def test_capsicum_exon_gene_table(tmp_path):
    """A capsicum_exon-shaped sample (the benchmark's configuration cut
    to 3 contigs, 30,000 reads and 60 genes) through the CLI with 1 MiB
    windows: its reads go through ranged splits, and its gene table is
    the plain reference's, byte for byte."""
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    cfg = small_cell(ROOT, "capsicum_exon", reads=30_000).config
    inputs = cache.ensure(str(tmp_path / "c"), "capsicum_exon",
                          json.dumps(cfg), cfg, 2147483711)
    out = str(tmp_path / "o")
    env = dict(os.environ, PANDEPTH_STREAM_WINDOW=str(WINDOW),
               PANDEPTH_DAEMON="0", PANDEPTH_FORCE_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    args = [a.format(annotation=inputs.gff)
            for a in cfg["pandepth"]["args"]]
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch.cli",
                        "-i", inputs.bam, *args, "-t", "3", "-v", "-o",
                        out], env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _phase(r.stderr, "feed.split") == 1.0
    assert 0.0 < _phase(r.stderr, "feed.read") < 1.0
    assert gunzip_bytes(out + ".gene.stat.gz") == \
        cache.reference(cfg, 2147483711, inputs)
