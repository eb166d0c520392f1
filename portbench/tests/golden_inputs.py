"""The golden configurations' inputs, as records and text.

A frozen copy of the system's ``synth.golden_inputs`` draws (800 reads of
seed 11 over three small contigs, and the ``t.gff`` annotation), from
which the reference binary's tables in ``tests/golden/`` were made. The
plain reference needs the records themselves, not a BAM.
"""

from __future__ import annotations

import random

CONTIGS = [("chr1", 5000), ("chr2", 3200), ("ctgM", 700)]
_OPS = "MIDNSHP=X"


def _ref_span(cigar: str) -> int:
    span, num = 0, ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if _OPS.index(ch) in (0, 2, 3, 7, 8):
                span += int(num)
            num = ""
    return span


def random_reads(contigs=CONTIGS, n: int = 800, seed: int = 11,
                 max_read: int = 150, end_slack=None):
    """Coordinate-sorted (tid, pos0, flag, mapq, cigar) records with a
    spread of CIGAR shapes, FLAG bits and MAPQs."""
    rng = random.Random(seed)
    recs = []
    while len(recs) < n:
        tid = rng.randrange(len(contigs))
        clen = contigs[tid][1]
        pos = rng.randrange(0, max(clen - 20, 1))
        roll = rng.random()
        if roll < 0.55:
            cigar = f"{rng.randrange(20, max_read)}M"
        elif roll < 0.7:
            a, b, c = (rng.randrange(5, 40) for _ in range(3))
            cigar = f"{a}M{rng.randrange(1, 9)}D{b}M{rng.randrange(1, 5)}I{c}M"
        elif roll < 0.8:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{rng.randrange(1, 20)}S{a}M{rng.randrange(20, 400)}N{b}M"
        elif roll < 0.9:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{a}={rng.randrange(1, 6)}X{b}="
        else:
            cigar = f"{rng.randrange(10, 60)}M{rng.randrange(5, 30)}S"
        flag = 0
        r = rng.random()
        if r < 0.06:
            flag |= 0x100   # secondary
        elif r < 0.1:
            flag |= 0x400   # duplicate
        elif r < 0.13:
            flag |= 0x200   # QC fail
        elif r < 0.15:
            flag = 4        # unmapped
            cigar = "*"
        if rng.random() < 0.5:
            flag |= 0x10
        mapq = rng.choice([0, 1, 10, 30, 60])
        if end_slack is not None and cigar != "*":
            if pos + _ref_span(cigar) > clen + end_slack:
                continue
        recs.append((tid, pos, flag, mapq, cigar))
    recs.sort(key=lambda r: (r[0], r[1]))
    return recs


def gff_text(contigs=CONTIGS, feature: str = "CDS",
             overhang: bool = True) -> str:
    """The golden ``t.gff``: CDS lines of five transcripts, one past a
    contig end, one on a contig the BAM lacks."""
    end_c6 = 3300 if overhang else 3150
    lines = [
        "##gff-version 3",
        f"{contigs[0][0]}\tsrc\tgene\t100\t900\t.\t+\t.\tID=gene1",
        f"{contigs[0][0]}\tsrc\t{feature}\t120\t340\t.\t+\t0\tID=cds1;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t300\t520\t.\t+\t0\tID=cds2;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t700\t890\t.\t+\t0\tID=cds3;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t1200\t1500\t.\t-\t0\tID=c4;Parent=mRNA2",
        f"{contigs[1][0]}\tsrc\t{feature}\t50\t400\t.\t+\t0\tID=c5;Parent=mRNA3",
        f"{contigs[1][0]}\tsrc\t{feature}\t2900\t{end_c6}\t.\t+\t0\tID=c6;Parent=mRNA4",
        f"{contigs[2][0]}\tsrc\t{feature}\t1\t700\t.\t+\t0\tID=c7;Parent=mRNA5",
        f"chrNOPE\tsrc\t{feature}\t1\t100\t.\t+\t0\tID=c8;Parent=mRNA6",
    ]
    return "\n".join(lines) + "\n"
