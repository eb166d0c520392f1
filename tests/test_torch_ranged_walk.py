"""The port's serial BAM walk where a window meets its decompressed cap.

The serial walk (``StreamBam::walk_serial`` in ``io/native/pancov_io.cpp``)
reads a compressed window and keeps the BGZF blocks that start below four
windows' worth of inflated bytes. Here the window is 1 MiB
(``PANDEPTH_STREAM_WINDOW``), so the cap is 4 MiB, and each BAM is laid
out block by block so that a window's blocks meet the cap in a chosen
way:

- ``straddle``: a ranged walk (``-g`` with a ``.bai``) whose second window
  ends on a block that starts below the cap and ends above it;
- ``boundary``: a block starts exactly at the cap;
- ``range_end``: the range's last block straddles the cap, and the next
  block, which no gene asks for, is stored, so that a walk that read
  66,000 bytes past the range's end block would take only part of it;
- and a whole-file serial walk (no index) whose first window's last whole
  block straddles the cap.

Each case runs the port's CLI in a process of its own under a time limit
(a walk that loses its place may hang rather than fail) and holds its
gene table byte-equal to the plain NumPy reference of the benchmark
(``portbench/reference/pandepth.py``). The CLI walks a ranged stream in
splits on every thread; ``test_torch_ranged_splits.test_cap_layouts``
holds the serial ranged walk to the split walk on the three ranged
layouts.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from tests.fixtures import gunzip_bytes

from portbench.reference import pandepth as reference
from pandepth_tpu_torch.io.bam_writer import (_write_bai_from_voffsets,
                                              encode_record)
from pandepth_tpu_torch.io.bgzf import BGZF_EOF
from pandepth_tpu_torch.io.native import load_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 1 << 20
CAP = 4 * WINDOW                 # the walk's decompressed cap
FULL = 0xFF00                    # a full block's inflated bytes
OVER_REACH = 66000               # a range's read past its last block
HEADER_READ = 1 << 16            # the stream's header read
CONTIGS = [("chr1", 300_000), ("chr2", 300_000)]
CIGAR = "150M"
SPAN = 150
EXCLUDE = 1796

_TEMPLATE = np.frombuffer(encode_record(0, 0, 0, 60, CIGAR, qname="r"),
                          np.uint8)
REC = _TEMPLATE.shape[0]


def _reg2bin(beg, end):
    """SAMv1 5.3's reg2bin of [beg, end), vectorised."""
    e = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _reads(n1, n2=0):
    """``n1`` reads on chr1 then ``n2`` on chr2, two bases apart from
    position 1,000, every 17th a duplicate (which ``-x 1796`` drops)."""
    tid = np.repeat(np.array([0, 1], np.int64), [n1, n2])
    pos = 1000 + 2 * np.concatenate((np.arange(n1), np.arange(n2)))
    flag = np.where(np.arange(n1 + n2) % 17 == 5, 1024, 0)
    return tid, pos.astype(np.int64), flag.astype(np.int64)


def _body(tid, pos, flag):
    """The records' bytes: one template record, stamped."""
    n = tid.shape[0]
    rec = np.tile(_TEMPLATE, (n, 1))
    bins = _reg2bin(pos, pos + SPAN)
    for col, arr, dt in ((4, tid, "<i4"), (8, pos, "<i4"), (14, bins, "<u2"),
                         (18, flag, "<u2")):
        a = np.ascontiguousarray(arr.astype(dt))
        rec[:, col: col + a.itemsize] = a.view(np.uint8).reshape(
            n, a.itemsize)
    return rec.tobytes(), bins


def _block(payload, level):
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    return (struct.pack("<4BI2BH2BH H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                        0x42, 0x43, 2, len(cdata) + 25) + cdata +
            struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)))


def _header():
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in CONTIGS)
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode() + \
        struct.pack("<i", len(CONTIGS))
    for nm, ln in CONTIGS:
        nb = nm.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return _block(hdr, 6)


def _layout(body, sizes, levels):
    """(header block, record blocks) of ``body`` cut into blocks of
    ``sizes`` inflated bytes, each deflated at its level."""
    assert sum(sizes) == len(body) and max(sizes) <= 1 << 16
    cut = np.concatenate(([0], np.cumsum(sizes)))
    return _header(), [_block(body[a:b], lv)
                       for a, b, lv in zip(cut[:-1], cut[1:], levels)]


def _write(path, tid, pos, flag, bins, sizes, hdr, blocks, index):
    """``path`` (and with ``index`` its ``.bai``) from the blocks. A
    record's end is the virtual offset of its last byte's block (the
    offset within it may be the block's size), as htslib gives it for a
    block not yet flushed."""
    with open(path, "wb") as fh:
        fh.write(hdr + b"".join(blocks) + BGZF_EOF)
    if not index:
        return
    u_start = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    f_start = len(hdr) + np.concatenate(
        ([0], np.cumsum([len(b) for b in blocks])))[:-1]
    u0 = np.arange(tid.shape[0], dtype=np.int64) * REC
    u1 = u0 + REC
    k0 = np.searchsorted(u_start, u0, side="right") - 1
    k1 = np.searchsorted(u_start, u1 - 1, side="right") - 1
    v0 = (f_start[k0] << 16) | (u0 - u_start[k0])
    v1 = (f_start[k1] << 16) | (u1 - u_start[k1])
    _write_bai_from_voffsets(path + ".bai", len(CONTIGS), tid, pos,
                             pos + SPAN, bins, v0, v1)


def _gff(path, lo, hi):
    """Genes on chr1 from ``lo`` to past ``hi`` (1-based), one every
    4,000 bases, each of three 300-base exons 1,000 bases apart."""
    lines = ["##gff-version 3"]
    for g, s in enumerate(range(lo, hi + 4000, 4000)):
        gid, tx = f"g{g:04d}", f"g{g:04d}.1"
        lines.append(f"chr1\tt\tgene\t{s}\t{s + 2899}\t.\t+\t.\tID={gid}")
        lines.append(f"chr1\tt\tmRNA\t{s}\t{s + 2899}\t.\t+\t.\t"
                     f"ID={tx};Parent={gid}")
        for k in range(3):
            a = s + 1300 * k
            lines.append(f"chr1\tt\texon\t{a}\t{a + 299}\t.\t+\t.\t"
                         f"ID={tx}.exon{k + 1};Parent={tx}")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as fh:
        fh.write(text)
    return text


def _straddle():
    """130 blocks in one range: the first window keeps the 65 that start
    below the cap; the second holds the other 65, the last of which
    starts below the cap and ends above it."""
    n1 = (129 * FULL + 40_000) // REC
    tid, pos, flag = _reads(n1)
    body, bins = _body(tid, pos, flag)
    sizes = [FULL] * 129 + [len(body) - 129 * FULL]
    assert CAP - 64 * FULL < sizes[-1] <= FULL
    hdr, blocks = _layout(body, sizes, [6] * len(sizes))
    # the whole range and its over-reach come in the first read
    assert sum(len(b) for b in blocks) + OVER_REACH < WINDOW
    return tid, pos, flag, bins, sizes, hdr, blocks, True


def _boundary():
    """64 full blocks and one of 16,384 bytes: the next block starts
    exactly at the cap."""
    n1 = (94 * FULL + (CAP - 64 * FULL) + 30_000) // REC
    tid, pos, flag = _reads(n1)
    body, bins = _body(tid, pos, flag)
    sizes = [FULL] * 64 + [CAP - 64 * FULL] + [FULL] * 30
    sizes.append(len(body) - sum(sizes))
    assert sum(sizes[:65]) == CAP and 0 < sizes[-1] <= FULL
    hdr, blocks = _layout(body, sizes, [6] * len(sizes))
    return tid, pos, flag, bins, sizes, hdr, blocks, True


def _range_end():
    """chr1's reads end in block 64, which is stored and straddles the
    cap; chr2's reads, which no gene asks for, follow in a stored block
    that the range's over-reach reads only in part."""
    n1 = (64 * FULL + 30_000) // REC
    n2 = (69 * FULL + 20_000) // REC - n1
    tid, pos, flag = _reads(n1, n2)
    body, bins = _body(tid, pos, flag)
    sizes = [FULL] * 69
    sizes.append(len(body) - sum(sizes))
    levels = [6] * len(sizes)
    levels[64] = levels[65] = 0
    assert 64 * FULL < n1 * REC < 65 * FULL and 0 < sizes[-1] <= FULL
    hdr, blocks = _layout(body, sizes, levels)
    assert len(blocks[64]) > FULL and len(blocks[65]) > FULL  # stored
    # the over-reach from block 64's start ends inside block 65
    assert len(blocks[64]) < OVER_REACH < len(blocks[64]) + len(blocks[65])
    assert sum(len(b) for b in blocks[:65]) + OVER_REACH < WINDOW
    return tid, pos, flag, bins, sizes, hdr, blocks, True


def _whole_file():
    """No index: the stream's header read takes the first ``k`` record
    blocks whole; its first window reads 1 MiB from there, in which
    exactly 65 blocks are whole (some are stored to make it so): the
    last starts below the cap and ends above it."""
    def build(n_blocks, stored):
        n1 = ((n_blocks - 1) * FULL + 30_000) // REC
        tid, pos, flag = _reads(n1)
        body, bins = _body(tid, pos, flag)
        sizes = [FULL] * (n_blocks - 1)
        sizes.append(len(body) - sum(sizes))
        levels = [0 if i in stored else 6 for i in range(len(sizes))]
        return (tid, pos, flag, bins, sizes) + _layout(body, sizes, levels)

    def first_read_blocks(hdr, blocks):
        at, k = len(hdr), 0
        while at + len(blocks[k]) <= HEADER_READ:
            at += len(blocks[k])
            k += 1
        return k

    *_, hdr, blocks = build(100, set())
    k = first_read_blocks(hdr, blocks)
    n_blocks = k + 76
    for s in range(66):
        stored = set(range(k, k + s)) | {k + 65}
        tid, pos, flag, bins, sizes, hdr, blocks = build(n_blocks, stored)
        c = [len(b) for b in blocks]
        if sum(c[k:k + 65]) <= WINDOW < sum(c[k:k + 66]):
            break
    else:
        raise AssertionError("no layout puts 65 whole blocks in a window")
    assert first_read_blocks(hdr, blocks) == k
    assert sum(sizes[k:k + 64]) < CAP < sum(sizes[k:k + 65])
    return tid, pos, flag, bins, sizes, hdr, blocks, False


CASES = {"straddle": _straddle, "boundary": _boundary,
         "range_end": _range_end}


def _run(tmp_path, build):
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    tid, pos, flag, bins, sizes, hdr, blocks, index = build()
    bam, gff = str(tmp_path / "s.bam"), str(tmp_path / "genes.gff3")
    _write(bam, tid, pos, flag, bins, sizes, hdr, blocks, index)
    text = _gff(gff, int(pos[0]) - 200, int(pos[tid == 0][-1]) + 400)
    out = str(tmp_path / "out")
    env = dict(os.environ, PANDEPTH_STREAM_WINDOW=str(WINDOW),
               PANDEPTH_DAEMON="0", PANDEPTH_FORCE_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch.cli",
                        "-i", bam, "-g", gff, "-f", "exon", "-t", "3",
                        "-o", out], env=env, capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    depth = reference.Depth([ln for _, ln in CONTIGS], tid, pos, flag,
                            np.full(tid.shape[0], 60), CIGAR, EXCLUDE, 0, 1)
    want = reference.gene_table([nm for nm, _ in CONTIGS], depth, text,
                                "exon")
    assert gunzip_bytes(out + ".gene.stat.gz").decode() == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranged_walk_at_the_cap(tmp_path, case):
    _run(tmp_path, CASES[case])


def test_whole_file_serial_walk_across_the_cap(tmp_path):
    _run(tmp_path, _whole_file)
