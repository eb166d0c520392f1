"""BAM container decoding into flat columnar batches.

The decoder reads the BAM header (name/length table) and converts
alignment records into numpy struct-of-arrays (``ReadBatch``) holding
exactly the fields the coverage engine consumes — FLAG, RNAME(tid), POS,
MAPQ and the CIGAR stream (the same required-field set the reference
requests from htslib via CRAM_OPT_REQUIRED_FIELDS,
src/PanDepth.cpp:3491).

Record boundary discovery is sequential by nature (each record carries
its own block_size); fixed fields and the CIGAR stream are then gathered
with vectorized numpy. This decoder runs under ``PANDEPTH_NO_NATIVE=1``;
otherwise the native stream (``pandepth_tpu_torch/io/native``) decodes
a BAM straight to coverage events, and only :func:`read_bam_header`
runs here.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pandepth_tpu_torch.io.bgzf import BgzfReader

# CIGAR op codes (SAMv1): M I D N S H P = X
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N = 0, 1, 2, 3
CIGAR_S, CIGAR_H, CIGAR_P, CIGAR_EQ, CIGAR_X = 4, 5, 6, 7, 8

# ops that consume reference bases
REF_CONSUME_MASK = (1 << CIGAR_M) | (1 << CIGAR_D) | (1 << CIGAR_N) | \
    (1 << CIGAR_EQ) | (1 << CIGAR_X)
# ops that add depth
DEPTH_MASK = (1 << CIGAR_M) | (1 << CIGAR_EQ) | (1 << CIGAR_X)


@dataclasses.dataclass
class BamHeader:
    text: str
    names: List[str]
    lengths: np.ndarray  # int64 (n_targets,)

    @property
    def n_targets(self) -> int:
        return len(self.names)

    def name_to_tid(self) -> dict:
        return {n: i for i, n in enumerate(self.names)}

    @property
    def sort_order(self) -> Optional[str]:
        """SO: value parsed the way the reference does (first "\tSO:" hit,
        src/PanDepth.cpp:4537-4549)."""
        pos = self.text.find("\tSO:")
        if pos < 0:
            return None
        pos += 4
        end = len(self.text)
        for ch in ("\n", "\t"):
            e = self.text.find(ch, pos)
            if e >= 0:
                end = min(end, e)
        return self.text[pos:end]


@dataclasses.dataclass
class ReadBatch:
    """Struct-of-arrays batch of alignment records.

    All arrays are int32. ``op_read`` maps each flattened CIGAR op to its
    row in the per-read arrays.
    """

    tid: np.ndarray      # (n,)
    pos: np.ndarray      # (n,) 0-based leftmost ref position
    flag: np.ndarray     # (n,)
    mapq: np.ndarray     # (n,)
    n_ops: np.ndarray    # (n,)
    op_code: np.ndarray  # (m,)
    op_len: np.ndarray   # (m,)
    op_read: np.ndarray  # (m,) index into per-read arrays

    @property
    def n_reads(self) -> int:
        return int(self.tid.shape[0])

    @property
    def n_total_ops(self) -> int:
        return int(self.op_code.shape[0])

    def end_pos(self) -> np.ndarray:
        """0-based exclusive reference end per read (bam_endpos semantics:
        pos+1 when no ref-consuming op)."""
        consumes = (REF_CONSUME_MASK >> self.op_code) & 1
        span = np.zeros(self.n_reads, np.int64)
        np.add.at(span, self.op_read, (self.op_len * consumes).astype(np.int64))
        return np.where(span > 0, self.pos + span, self.pos + 1)


def _parse_header(data: bytes) -> Tuple[BamHeader, int]:
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream (bad magic)")
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8: 8 + l_text].split(b"\x00", 1)[0].decode("utf-8", "replace")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names: List[str] = []
    lengths = np.zeros(n_ref, np.int64)
    for i in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        if l_name < 1:
            raise ValueError("malformed BAM header (l_name < 1)")
        names.append(data[off: off + l_name - 1].decode())
        off += l_name
        (lengths[i],) = struct.unpack_from("<i", data, off)
        off += 4
    return BamHeader(text=text, names=names, lengths=lengths), off


def _record_offsets(data: bytes, start: int, max_records: int
                    ) -> Tuple[np.ndarray, int]:
    """Scan record boundaries from ``start``; returns (offsets, next_off).

    ``offsets`` point at each record's first field (past block_size).
    """
    offs: List[int] = []
    off = start
    n = len(data)
    u = struct.unpack_from
    while off + 4 <= n and len(offs) < max_records:
        (block_size,) = u("<i", data, off)
        if off + 4 + block_size > n:
            raise ValueError("truncated BAM record")
        offs.append(off + 4)
        off += 4 + block_size
    return np.asarray(offs, dtype=np.int64), off


def _gather_le(u8: np.ndarray, offsets: np.ndarray, nbytes: int) -> np.ndarray:
    """Vectorized little-endian integer gather at arbitrary byte offsets."""
    idx = offsets[:, None] + np.arange(nbytes, dtype=np.int64)[None, :]
    b = u8[idx].astype(np.int64)
    shifts = (8 * np.arange(nbytes, dtype=np.int64))[None, :]
    return (b << shifts).sum(axis=1)


_AUX_FIXED = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
_B_ELSIZE = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
             ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _find_cg(data: bytes, aux: int, end: int) -> Optional[Tuple[int, int]]:
    """Scan aux tags in data[aux:end] for CG:B,I; returns (byte offset
    of the op array, op count) or None. Mirrors htslib's tolerance:
    malformed aux keeps the in-place placeholder CIGAR."""
    off = aux
    while off + 3 <= end:
        t1, t2, typ = data[off], data[off + 1], data[off + 2]
        off += 3
        if typ in _AUX_FIXED:
            off += _AUX_FIXED[typ]
        elif typ in (ord("Z"), ord("H")):
            z = data.find(b"\x00", off, end)
            if z < 0:
                return None
            off = z + 1
        elif typ == ord("B"):
            if off + 5 > end:
                return None
            sub = data[off]
            if sub not in _B_ELSIZE:
                return None
            (cnt,) = struct.unpack_from("<I", data, off + 1)
            if off + 5 + cnt * _B_ELSIZE[sub] > end:
                return None
            if t1 == ord("C") and t2 == ord("G") and \
                    sub in (ord("I"), ord("i")):
                if cnt < 1 or cnt >= 1 << 29:
                    return None
                return off + 5, cnt
            off += 5 + cnt * _B_ELSIZE[sub]
        else:
            return None
    return None


def decode_records(data: bytes, offsets: np.ndarray) -> ReadBatch:
    """Decode the records whose data starts at ``offsets`` (columnar)."""
    n = len(offsets)
    if n == 0:
        z = np.zeros(0, np.int32)
        return ReadBatch(z, z, z, z, z, z, z, z)
    u8 = np.frombuffer(data, dtype=np.uint8)
    tid = _gather_le(u8, offsets + 0, 4).astype(np.int32)
    pos = _gather_le(u8, offsets + 4, 4).astype(np.int32)
    l_read_name = u8[offsets + 8].astype(np.int64)
    mapq = u8[offsets + 9].astype(np.int32)
    n_cigar = _gather_le(u8, offsets + 12, 2).astype(np.int32)
    flag = _gather_le(u8, offsets + 14, 2).astype(np.int32)

    cig_off = offsets + 32 + l_read_name

    # long-CIGAR records (>2^16-1 ops): htslib rewrites the `lqseq S,
    # span N` placeholder from the CG:B,I aux tag on read (sam.c
    # bam_tag2cigar, the layer under the reference's sam_read1 at
    # src/PanDepth.cpp:4604); candidates = first op S of exactly l_qseq
    lqseq = _gather_le(u8, offsets + 16, 4)
    cand = np.flatnonzero(
        (n_cigar > 0) & (lqseq > 0) &
        (_gather_le(u8, np.where(n_cigar > 0, cig_off, 0), 4)
         == ((lqseq << 4) | CIGAR_S)))
    if cand.size:
        n_cigar = n_cigar.copy()
        cig_off = cig_off.copy()
        bsize = _gather_le(u8, offsets - 4, 4)
        for i in cand:
            aux = int(cig_off[i] + 4 * n_cigar[i] +
                      (lqseq[i] + 1) // 2 + lqseq[i])
            hit = _find_cg(data, aux, int(offsets[i] + bsize[i]))
            if hit is not None:
                cig_off[i], n_cigar[i] = hit

    total_ops = int(n_cigar.sum())
    if total_ops:
        n_ops64 = n_cigar.astype(np.int64)
        op_read = np.repeat(np.arange(n, dtype=np.int32), n_ops64)
        excl = np.concatenate(([0], np.cumsum(n_ops64)[:-1]))
        intra = np.arange(total_ops, dtype=np.int64) - excl[op_read]
        byte_idx = cig_off[op_read] + intra * 4
        raw = _gather_le(u8, byte_idx, 4)
        op_code = (raw & 0xF).astype(np.int32)
        op_len = (raw >> 4).astype(np.int32)
    else:
        op_read = np.zeros(0, np.int32)
        op_code = np.zeros(0, np.int32)
        op_len = np.zeros(0, np.int32)

    return ReadBatch(tid=tid, pos=pos, flag=flag, mapq=mapq,
                     n_ops=n_cigar, op_code=op_code, op_len=op_len,
                     op_read=op_read)


def read_bam_header(path: str) -> BamHeader:
    """Parse just the BAM header, inflating the leading BGZF blocks one
    at a time until it is whole: a few blocks for most files, as many as
    a header of hundreds of thousands of contigs takes. A file whose
    first inflated bytes are not ``BAM\\1`` (gzipped SAM text) stops
    there, so it is never inflated whole."""
    from pandepth_tpu_torch.io.bgzf import read_block

    data = bytearray()
    # where the parse goes on: the end of n_ref, then of each contig's
    # entry in turn; refs counts the entries left (-1: n_ref not read)
    end, refs = 8, -1
    with open(path, "rb") as fh:
        while refs != 0 or end > len(data):
            data += read_block(fh)
            if len(data) >= 4 and data[:4] != b"BAM\x01":
                raise ValueError("not a BAM stream (bad magic)")
            if refs < 0 and len(data) >= 8:
                end = 12 + struct.unpack_from("<i", data, 4)[0]
                if end <= len(data):
                    refs = struct.unpack_from("<i", data, end - 4)[0]
            while refs > 0 and end + 4 <= len(data):
                l_name = struct.unpack_from("<i", data, end)[0]
                if l_name < 1:
                    raise ValueError("malformed BAM header (l_name < 1)")
                end += 8 + l_name
                refs -= 1
    return _parse_header(bytes(data))[0]


class BamReader:
    """Whole-file BAM reader yielding columnar batches."""

    def __init__(self, path: str):
        self._data = BgzfReader(path).data
        self.header, self._off = _parse_header(self._data)

    def batches(self, max_reads: int = 1 << 18) -> Iterator[ReadBatch]:
        off = self._off
        while off < len(self._data):
            offsets, off = _record_offsets(self._data, off, max_reads)
            if len(offsets) == 0:
                break
            yield decode_records(self._data, offsets)
