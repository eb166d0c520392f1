"""A coordinate-sorted, indexed BAM of reads whose CIGARs come from a
small table.

A frozen copy of the vectorised fixture writer that the system under
test ships (its ``io/bam_writer.write_uniform_bam`` with the BAI
assembly), kept here so that later changes to the program cannot change
the benchmark's inputs. It imports nothing of the program. Query names
are built with integer arithmetic instead of ``numpy.char`` (the same
bytes, ``r`` and seven or more digits), and the BGZF blocks are
compressed on every core. Unlike the original it takes a table of
CIGARs and each read's index into it: every record keeps one size, the
shorter kinds padded by an ``XP:Z`` tag of filler, so the records are
still laid out as one array. With one CIGAR the bytes are the
original's.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from typing import Sequence

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_OPS = "MIDNSHP=X"
_REF_CONSUME = {0, 2, 3, 7, 8}
_QUERY_CONSUME = {0, 1, 4, 7, 8}
_CHUNK = 0xFF00


def cigar_ops(cigar: str):
    """``"60M5D40M"`` -> [(0, 60), (2, 5), (0, 40)] (op code, length)."""
    ops, num = [], ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append((_OPS.index(ch), int(num)))
            num = ""
    return ops


def _bgzf_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    return (struct.pack("<4BI2BH2BH H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                        0x42, 0x43, 2, len(cdata) + 25) + cdata +
            struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)))


def _qnames(lo: int, hi: int, width: int) -> np.ndarray:
    """(hi - lo, width) uint8: ``r`` then the zero-padded record number."""
    n = np.arange(lo, hi, dtype=np.int64)
    out = np.empty((hi - lo, width), np.uint8)
    out[:, 0] = ord("r")
    for k in range(width - 1, 0, -1):
        out[:, k] = 48 + n % 10
        n //= 10
    return out


def write_uniform_bam(path: str, names: Sequence[str],
                      lengths: Sequence[int], tid, pos, flag, mapq,
                      cigar="150M", level: int = 1, kind=None) -> None:
    """Write ``path`` and ``path.bai``: one record per (tid, pos, flag,
    mapq), with a sequence of ``=`` bases and no qualities, in the order
    given (pass coordinate-sorted reads). ``cigar`` is every record's
    CIGAR, or a list of CIGARs that ``kind`` (one index a read) picks
    from."""
    tid = np.asarray(tid, np.int32)
    pos = np.asarray(pos, np.int32)
    flag = np.asarray(flag, np.uint16)
    mapq = np.asarray(mapq, np.uint8)
    n = int(tid.shape[0])
    if max(lengths, default=0) >= 1 << 29:
        raise ValueError("a BAI cannot index contigs of 2^29 bases or more")

    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in zip(names, lengths))
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode() + \
        struct.pack("<i", len(names))
    for nm, ln in zip(names, lengths):
        nb = nm.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)

    table = [cigar] if isinstance(cigar, str) else list(cigar)
    kind = np.zeros(n, np.intp) if kind is None else \
        np.asarray(kind, np.intp)
    width = max(8, len(str(max(n - 1, 0))) + 1)  # "r" + digits
    qname_len = width + 1
    # each kind: (n_ops, read length, reference span, the record's bytes
    # after its name: CIGAR, sequence, qualities)
    kinds = []
    for c in table:
        ops = cigar_ops(c)
        read_len = sum(ln for op, ln in ops if op in _QUERY_CONSUME)
        cig = np.asarray([(ln << 4) | op for op, ln in ops], "<u4")
        tail = cig.tobytes() + b"\x11" * ((read_len + 1) // 2) + \
            b"\xff" * read_len
        kinds.append((len(ops), read_len,
                      sum(ln for op, ln in ops if op in _REF_CONSUME),
                      tail))
    longest = max(len(k[3]) for k in kinds)
    if any(len(k[3]) != longest for k in kinds):
        longest += 4  # the shortest filler tag: "XPZ" and its NUL
        kinds = [k[:3] + (k[3] + b"XPZ" + b"A" * (longest - 4 - len(k[3]))
                          + b"\x00",) for k in kinds]
    tails = np.frombuffer(b"".join(k[3] for k in kinds), np.uint8
                          ).reshape(len(kinds), longest)
    n_ops = np.asarray([k[0] for k in kinds], np.uint16)[kind]
    l_seq = np.asarray([k[1] for k in kinds], np.int32)[kind]
    body = 32 + qname_len + longest
    rec_size = 4 + body
    end = pos.astype(np.int64) + \
        np.asarray([k[2] for k in kinds], np.int64)[kind]

    # reg2bin (SAMv1 5.3) of [pos, end)
    b = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    p64, e1 = pos.astype(np.int64), end - 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((p64 >> shift) == (e1 >> shift))
        b[hit] = base + (p64[hit] >> shift)
        done |= hit

    def records(lo: int, hi: int) -> bytes:
        m = hi - lo
        rec = np.zeros((m, rec_size), np.uint8)

        def put(col, arr, dtype):
            a = np.ascontiguousarray(np.broadcast_to(
                np.asarray(arr, dtype), (m,)))
            rec[:, col: col + a.itemsize] = a.view(np.uint8).reshape(
                m, a.itemsize)

        put(0, body, "<i4")
        put(4, tid[lo:hi], "<i4")
        put(8, pos[lo:hi], "<i4")
        rec[:, 12] = qname_len
        rec[:, 13] = mapq[lo:hi]
        put(14, b[lo:hi], "<u2")
        put(16, n_ops[lo:hi], "<u2")
        put(18, flag[lo:hi], "<u2")
        put(20, l_seq[lo:hi], "<i4")
        put(24, -1, "<i4")
        put(28, -1, "<i4")
        rec[:, 36: 36 + width] = _qnames(lo, hi, width)
        rec[:, 36 + qname_len:] = tails[kind[lo:hi]]
        return rec.tobytes()

    slice_recs = max(1, (256 << 20) // rec_size)
    block_offs = []
    off = 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh, concurrent.futures.ThreadPoolExecutor(
            os.cpu_count() or 4) as ex:
        carry = hdr
        lo = 0
        while True:
            hi = min(lo + slice_recs, n)
            final = hi == n
            buf = carry + (records(lo, hi) if hi > lo else b"")
            cut = len(buf) if final else (len(buf) // _CHUNK) * _CHUNK
            pieces = [buf[i: i + _CHUNK] for i in range(0, cut, _CHUNK)]
            carry = buf[cut:]
            for blk in ex.map(_bgzf_block, pieces,
                              [level] * len(pieces)):
                block_offs.append(off)
                off += len(blk)
                fh.write(blk)
            if final:
                break
            lo = hi
        fh.write(BGZF_EOF)

    # virtual offsets of each record's first and one-past-last byte
    u0 = len(hdr) + np.arange(n, dtype=np.int64) * rec_size
    u1 = u0 + rec_size
    boffs = np.append(np.asarray(block_offs, np.int64), off)
    v0 = (boffs[u0 // _CHUNK] << 16) | (u0 % _CHUNK)
    v1 = (boffs[u1 // _CHUNK] << 16) | (u1 % _CHUNK)
    _write_bai(tmp + ".bai", len(names), tid, p64, end, b, v0, v1)
    os.replace(tmp + ".bai", path + ".bai")
    os.replace(tmp, path)


def _write_bai(path: str, n_ref: int, tid, pos, end, bins, v0, v1) -> None:
    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for t in range(n_ref):
        sel = np.nonzero(tid == t)[0]
        if sel.size == 0:
            out += struct.pack("<ii", 0, 0)
            continue
        order = np.argsort(bins[sel], kind="stable")
        sel_s = sel[order]
        uniq, starts = np.unique(bins[sel_s], return_index=True)
        out += struct.pack("<i", len(uniq))
        for k, bval in enumerate(uniq):
            hi = starts[k + 1] if k + 1 < len(uniq) else len(sel_s)
            idxs = sel_s[starts[k]:hi]
            a, bb = v0[idxs], v1[idxs]
            # merge runs of records whose chunks touch
            brk = np.nonzero(bb[:-1] != a[1:])[0]
            si = np.concatenate(([0], brk + 1))
            ei = np.concatenate((brk, [len(idxs) - 1]))
            pairs = np.empty((len(si), 2), "<u8")
            pairs[:, 0] = a[si]
            pairs[:, 1] = bb[ei]
            out += struct.pack("<Ii", int(bval), len(si))
            out += pairs.tobytes()
        # linear index over 16 kb windows, empty windows forward-filled
        k0 = pos[sel] >> 14
        k1 = np.maximum(end[sel] - 1, pos[sel]) >> 14
        n_intv = int(k1.max()) + 1
        big = np.iinfo(np.int64).max
        lin = np.full(n_intv, big, np.int64)
        np.minimum.at(lin, k0, v0[sel])
        np.minimum.at(lin, k1, v0[sel])
        mask = lin != big
        idx = np.where(mask, np.arange(n_intv), 0)
        np.maximum.accumulate(idx, out=idx)
        ioffs = np.where(mask[idx], np.where(mask, lin, 0)[idx], 0)
        out += struct.pack("<i", n_intv)
        out += ioffs.astype("<u8").tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(out))
