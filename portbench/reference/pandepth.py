"""A plain NumPy reference of PanDepth's chromosome and GFF tables.

It works from the reads as they were drawn (not from the BAM that the
program decodes) and from the annotation's text, and writes the table
text that the program's ``<prefix>.chr.stat.gz`` or
``<prefix>.gene.stat.gz`` must decompress to, byte for byte.

PanDepth's rules, as the reference binary applies them:

- a read counts when ``flag & exclude == 0`` and, where ``min_mapq > 0``,
  ``mapq >= min_mapq``;
- its CIGAR's M, = and X operations add one to the depth of each base
  they cover; D and N move along the reference without adding; I, S, H
  and P do neither;
- each contig keeps 512 bases past its end, so a read hanging over the
  end adds depth there;
- a base is covered when its depth is at least ``min_depth``; a
  region's CoveredSite counts its covered bases and its TotalDepth sums
  their depths;
- chromosome mode: one row per contig over ``[1, length]``;
- GFF mode: lines whose third column is the feature; a line's region id
  is the last ``=``-part of the first attribute, or its ``Parent``; the
  lines of one (contig, id) form one row: the least start, the greatest
  end, the summed lengths, the summed counts of each line's bases
  (overlapping lines count twice); lines on contigs not in the header
  are skipped; rows by contig, then start, then id (bytes);
- percentages and means with two decimals; a ``##RegionLength`` footer.

Depths of 2^18 or more are refused: the binary keeps 18-bit depth cells
on some paths, and none of the benchmark's inputs comes near.

This module imports neither jax, the JAX package nor the program.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD = 512
_OPS = "MIDNSHP=X"
_DEPTH_OPS = {0, 7, 8}            # M = X
_REF_OPS = {0, 2, 3, 7, 8}        # M D N = X


def _ops(cigar: str):
    out, num = [], ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((_OPS.index(ch), int(num)))
            num = ""
    return out


def _cigar_pieces(cigar: str) -> List[Tuple[int, int]]:
    """[(offset, length)] of the depth-adding operations, from the read's
    leftmost base."""
    pieces, at = [], 0
    if cigar == "*":
        return pieces
    for op, ln in _ops(cigar):
        if op in _DEPTH_OPS:
            pieces.append((at, ln))
        if op in _REF_OPS:
            at += ln
    return pieces


class Depth:
    """The depth of every base of a genome (each contig plus its slack),
    kept as sorted change points: depth ``depth[k]`` holds over
    ``[at[k], at[k + 1])`` on one global axis."""

    def __init__(self, lengths: Sequence[int], tid, pos, flag, mapq,
                 cigars, exclude: int, min_mapq: int, min_depth: int,
                 kind=None):
        """``cigars`` is one CIGAR for every read, a list of one a read,
        or, with ``kind`` (an index a read), the table that ``kind``
        picks from."""
        self.lengths = np.asarray(lengths, np.int64)
        self.base = np.concatenate(
            ([0], np.cumsum(self.lengths + PAD)))[:-1]
        tid = np.asarray(tid, np.int64)
        pos = np.asarray(pos, np.int64)
        keep = ((np.asarray(flag, np.int64) & exclude) == 0) & (tid >= 0)
        if min_mapq > 0:
            keep &= np.asarray(mapq, np.int64) >= min_mapq
        if isinstance(cigars, str):  # one CIGAR for every read
            groups = [(np.flatnonzero(keep), cigars)]
        elif kind is not None:
            kind = np.asarray(kind, np.int64)
            groups = [(np.flatnonzero(keep & (kind == k)), c)
                      for k, c in enumerate(cigars)]
        else:
            by: Dict[str, list] = {}
            for i in np.flatnonzero(keep):
                by.setdefault(cigars[i], []).append(i)
            groups = [(np.asarray(v, np.int64), c) for c, v in by.items()]
        starts, ends = [], []
        for rows, cigar in groups:
            lo = self.base[tid[rows]]
            hi = lo + self.lengths[tid[rows]] + PAD
            for off, ln in _cigar_pieces(cigar):
                a = np.clip(lo + pos[rows] + off, lo, hi)
                b = np.clip(lo + pos[rows] + off + ln, lo, hi)
                starts.append(a[b > a])
                ends.append(b[b > a])
        s = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        e = np.concatenate(ends) if ends else np.zeros(0, np.int64)
        at = np.concatenate((s, e))
        step = np.concatenate((np.ones(s.shape[0], np.int64),
                               -np.ones(e.shape[0], np.int64)))
        order = np.argsort(at, kind="stable")
        self.at = at[order]
        self.depth = np.cumsum(step[order])
        if self.depth.shape[0] and self.depth.max() >= 1 << 18:
            raise ValueError("a depth of 2^18 or more: outside this "
                             "reference")
        covered = self.depth >= min_depth
        length = np.diff(self.at, append=self.at[-1:] if self.at.shape[0]
                         else self.at)
        self._covered = covered
        # counts over every piece before piece k
        self._cov_before = np.concatenate(
            ([0], np.cumsum(length * covered)))[:-1]
        self._sum_before = np.concatenate(
            ([0], np.cumsum(length * covered * self.depth)))[:-1]

    def _upto(self, x: np.ndarray):
        """(covered bases, summed depth) over global bases ``< x``."""
        x = np.asarray(x, np.int64)
        if self.at.shape[0] == 0:
            z = np.zeros(x.shape, np.int64)
            return z, z
        k = np.searchsorted(self.at, x, side="right") - 1
        inside = k >= 0
        kk = np.maximum(k, 0)
        part = np.where(inside, (x - self.at[kk]) * self._covered[kk], 0)
        cov = np.where(inside, self._cov_before[kk], 0) + part
        tot = np.where(inside, self._sum_before[kk], 0) + \
            part * self.depth[kk]
        return cov, tot

    def stats(self, tid, start1, end1):
        """(covered, total depth) of each 1-based inclusive region, clipped
        to its contig and slack."""
        tid = np.asarray(tid, np.int64)
        lo = self.base[tid]
        hi = lo + self.lengths[tid] + PAD
        a = np.clip(lo + np.asarray(start1, np.int64) - 1, lo, hi)
        b = np.clip(lo + np.asarray(end1, np.int64), a, hi)
        ca, sa = self._upto(a)
        cb, sb = self._upto(b)
        return cb - ca, sb - sa


def _footer(length: int, cov: int, tot: int) -> str:
    return (f"##RegionLength: {length}\tCoveredSite: {cov}\t"
            f"Coverage(%): {cov * 100.0 / length:.2f}\t"
            f"MeanDepth: {tot / length:.2f}\n")


def chr_table(names: Sequence[str], depth: Depth) -> str:
    n = len(names)
    cov, tot = depth.stats(np.arange(n), np.ones(n, np.int64),
                           depth.lengths)
    rows = ["#Chr\tLength\tCoveredSite\tTotalDepth\tCoverage(%)\t"
            "MeanDepth\n"]
    for t in range(n):
        ln = int(depth.lengths[t])
        rows.append(f"{names[t]}\t{ln}\t{cov[t]}\t{tot[t]}\t"
                    f"{cov[t] * 100.0 / ln:.2f}\t{tot[t] / ln:.2f}\n")
    rows.append(_footer(int(depth.lengths.sum()), int(cov.sum()),
                        int(tot.sum())))
    return "".join(rows)


def parse_gff(text: str, feature: str, names: Sequence[str]):
    """(tid, id, start, end) columns of the feature's lines."""
    tid_of = {nm: i for i, nm in enumerate(names)}
    tids, ids, starts, ends = [], [], [], []
    for line in text.split("\n"):
        if not line or line.startswith("#"):
            continue
        cols = line.split()
        if len(cols) < 9 or cols[2] != feature:
            continue
        attrs = [a for a in re.split(r"[,;]", cols[8]) if a]
        if not attrs:
            continue
        rid = attrs[0].split("=")[-1]
        for a in attrs[1:]:
            kv = a.split("=")
            if kv[0] == "Parent":
                rid = kv[-1]
        t = tid_of.get(cols[0])
        if t is None:
            continue
        tids.append(t)
        ids.append(rid)
        starts.append(int(cols[3]))
        ends.append(int(cols[4]))
    return (np.asarray(tids, np.int64), ids, np.asarray(starts, np.int64),
            np.asarray(ends, np.int64))


def gene_table(names: Sequence[str], depth: Depth, gff_text: str,
               feature: str) -> str:
    tid, ids, s, e = parse_gff(gff_text, feature, names)
    cov, tot = depth.stats(tid, s, e)
    rows: Dict[Tuple[int, str], list] = {}
    for i in range(tid.shape[0]):
        key = (int(tid[i]), ids[i])
        r = rows.get(key)
        if r is None:
            rows[key] = [int(s[i]), int(e[i]), int(e[i] - s[i] + 1),
                         int(cov[i]), int(tot[i])]
        else:
            r[0] = min(r[0], int(s[i]))
            r[1] = max(r[1], int(e[i]))
            r[2] += int(e[i] - s[i] + 1)
            r[3] += int(cov[i])
            r[4] += int(tot[i])
    out = ["#Chr\tStart\tEnd\tGeneID\tLength\tCoveredSite\tTotalDepth\t"
           "Coverage(%)\tMeanDepth\n"]
    s_len = s_cov = s_tot = 0
    for (t, rid), (a, b, ln, c, d) in sorted(
            rows.items(), key=lambda kv: (kv[0][0], kv[1][0],
                                          kv[0][1].encode())):
        out.append(f"{names[t]}\t{a}\t{b}\t{rid}\t{ln}\t{c}\t{d}\t"
                   f"{c * 100.0 / ln:.2f}\t{d / ln:.2f}\n")
        s_len += ln
        s_cov += c
        s_tot += d
    out.append(_footer(s_len, s_cov, s_tot))
    return "".join(out)
