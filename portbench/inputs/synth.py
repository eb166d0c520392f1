"""The benchmark's inputs, made from a configuration and a seed.

Reads follow the system's own benchmark fixture (its ``synth._uniform_reads``:
uniform positions, MAPQ from a fixed set), at the configuration's depth
over its covered span at the start of each contig, with the CIGARs and
FLAG bits of the configuration's mixes. They are drawn so that every
seed gives the same amount of work in another order: each contig gets
the same number of reads, and each MAPQ value, CIGAR and FLAG value
exactly its share, at positions and in an order of the seed's own. The
annotation is GFF3 gene, mRNA and exon lines with ``ID`` and ``Parent``:
the configured numbers of genes and exons, the exon counts of the genes
summing to the configured total, and the same exon counts, exon lengths
and intron lengths for every seed, each seed placing them in an order
and at positions of its own.

Nothing here imports the program; :mod:`portbench.reference` works from
the arrays made here and from the annotation's text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from portbench.inputs.bamwrite import cigar_ops, write_uniform_bam

DUP_FLAG = 1024


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of one seed: any whole number is a
    seed, negative ones and ones past 64 bits included."""
    return np.random.default_rng([seed % (1 << 64), stream])


def genome(cfg: dict) -> List[Tuple[str, int]]:
    g = cfg["genome"]
    return [(f"{g['contig_prefix']}{i + 1}", int(g["contig_length"]))
            for i in range(int(g["contigs"]))]


@dataclasses.dataclass
class Reads:
    """Columnar alignments, coordinate-sorted; read ``i`` has the CIGAR
    ``cigars[kind[i]]``."""
    tid: np.ndarray   # int32
    pos: np.ndarray   # int32, 0-based leftmost base
    flag: np.ndarray  # uint16
    mapq: np.ndarray  # uint8
    cigars: List[str]
    kind: np.ndarray  # uint8


def _exact_shares(rng, n: int, values, shares=None) -> np.ndarray:
    """``n`` draws that hold each of ``values`` its share of ``n`` (equal
    shares where none are given), rounded down and the rest one more to
    each value from the first, in a random order."""
    values = np.asarray(values)
    k = len(values)
    w = np.full(k, 1.0 / k) if shares is None else np.asarray(shares, float)
    counts = np.floor(n * w / w.sum()).astype(np.int64)
    counts[: n - int(counts.sum())] += 1
    return rng.permutation(np.repeat(values, counts))


def make_reads(cfg: dict, seed: int) -> Reads:
    """The configuration's sample for ``seed``."""
    r = cfg["reads"]
    n = int(cfg["reads_per_sample"])
    contigs = genome(cfg)
    rng = rng_for(seed, 1)
    n_c = len(contigs)
    per = np.full(n_c, n // n_c)
    per[: n % n_c] += 1
    tid = np.repeat(np.arange(n_c, dtype=np.int32), per)
    cigars = [c for c, _ in r["cigar_mix"]]
    span = max(sum(ln for op, ln in cigar_ops(c) if op in (0, 2, 3, 7, 8))
               for c in cigars)
    lens = np.minimum(np.array([ln for _, ln in contigs], np.int64),
                      int(cfg["covered_bases_per_contig"]))
    room = lens[tid] - span - int(r["end_margin"])
    pos = (rng.random(n) * room).astype(np.int32)
    edges = np.concatenate(([0], np.cumsum(per)))
    for a, b in zip(edges[:-1], edges[1:]):  # coordinate order
        pos[a:b].sort()
    mapq = _exact_shares(rng, n, r["mapq_values"]).astype(np.uint8)
    kind = _exact_shares(rng, n, np.arange(len(cigars)),
                         [w for _, w in r["cigar_mix"]]).astype(np.uint8)
    flag = _exact_shares(rng, n, [f for f, _ in r["flag_mix"]],
                         [w for _, w in r["flag_mix"]]).astype(np.uint16)
    return Reads(tid, pos, flag, mapq, cigars, kind)


@dataclasses.dataclass
class Annotation:
    """Genes of one transcript each; exon ``k`` of gene ``g`` is
    ``exon_start[exon_off[g] + k]`` .. ``exon_end[...]`` (1-based,
    inclusive)."""
    gene_tid: np.ndarray
    exon_off: np.ndarray   # (genes + 1,)
    exon_start: np.ndarray
    exon_end: np.ndarray


def make_annotation(cfg: dict, seed: int) -> Annotation:
    a = cfg["annotation"]
    n_g, n_e = int(a["genes"]), int(a["exons"])
    contigs = genome(cfg)
    # every seed gets the same exon counts and exon and intron lengths,
    # drawn once (one each and the rest spread uniformly; lengths uniform
    # in their ranges), in an order of its own
    fixed = rng_for(0, 2)
    n_ex = 1 + fixed.multinomial(n_e - n_g, np.full(n_g, 1.0 / n_g))
    ex_len = fixed.integers(a["exon_length"][0], a["exon_length"][1] + 1,
                            n_e)
    intr = fixed.integers(a["intron_length"][0],
                          a["intron_length"][1] + 1, n_e)
    rng = rng_for(seed, 2)
    n_ex = n_ex[rng.permutation(n_g)]
    ex_len = ex_len[rng.permutation(n_e)]
    intr = intr[rng.permutation(n_e)]
    off = np.concatenate(([0], np.cumsum(n_ex))).astype(np.int64)
    intr[off[1:] - 1] = 0  # no intron after a gene's last exon
    # each exon's start within its gene: lengths of the exons and introns
    # before it
    step = ex_len + intr
    within = np.cumsum(step) - step
    within -= np.repeat(within[off[:-1]], n_ex)
    g_span = within[off[1:] - 1] + ex_len[off[1:] - 1]
    # genes: the same number on every contig, uniform starts, sorted
    n_c = len(contigs)
    per = np.full(n_c, n_g // n_c)
    per[: n_g % n_c] += 1
    g_tid = np.repeat(np.arange(n_c, dtype=np.int32), per)
    g_tid = g_tid[rng.permutation(n_g)]  # genes of every size on each
    lens = np.array([ln for _, ln in contigs], np.int64)
    g_start = 1 + (rng.random(n_g) * (lens[g_tid] - g_span)).astype(np.int64)
    order = np.lexsort((g_start, g_tid))
    g_tid, g_start = g_tid[order], g_start[order]
    idx = np.concatenate([np.arange(off[g], off[g + 1]) for g in order]) \
        if n_g else np.zeros(0, np.int64)
    n_ex = n_ex[order]
    off = np.concatenate(([0], np.cumsum(n_ex))).astype(np.int64)
    e_start = np.repeat(g_start, n_ex) + within[idx]
    e_end = e_start + ex_len[idx] - 1
    return Annotation(g_tid, off, e_start, e_end)


def write_gff3(path: str, cfg: dict, ann: Annotation) -> None:
    """``path``: GFF3 gene, mRNA and exon lines, genes in coordinate
    order, IDs ``<prefix><contig>g<number>``."""
    names = [nm for nm, _ in genome(cfg)]
    prefix = cfg["annotation"]["id_prefix"]
    src = cfg["annotation"]["source_column"]
    lines = ["##gff-version 3"]
    off = ann.exon_off
    for g in range(ann.gene_tid.shape[0]):
        t = int(ann.gene_tid[g])
        chrom = names[t]
        gid = f"{prefix}{t + 1:02d}g{g:06d}"
        tx = f"{gid}.1"
        s = int(ann.exon_start[off[g]])
        e = int(ann.exon_end[off[g + 1] - 1])
        strand = "+" if g % 2 == 0 else "-"
        lines.append(f"{chrom}\t{src}\tgene\t{s}\t{e}\t.\t{strand}\t.\t"
                     f"ID={gid}")
        lines.append(f"{chrom}\t{src}\tmRNA\t{s}\t{e}\t.\t{strand}\t.\t"
                     f"ID={tx};Parent={gid}")
        for k in range(off[g], off[g + 1]):
            lines.append(f"{chrom}\t{src}\texon\t{ann.exon_start[k]}\t"
                         f"{ann.exon_end[k]}\t.\t{strand}\t.\t"
                         f"ID={tx}.exon{k - off[g] + 1};Parent={tx}")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def write_bam(path: str, cfg: dict, reads: Reads) -> None:
    contigs = genome(cfg)
    write_uniform_bam(path, [nm for nm, _ in contigs],
                      [ln for _, ln in contigs], reads.tid, reads.pos,
                      reads.flag, reads.mapq, cigar=reads.cigars,
                      kind=reads.kind)
