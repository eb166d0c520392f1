"""The inputs: the same seed gives the same inputs, another seed others
with the same amount of work; the annotation holds the configured genes
and exons; the BAM writer's bytes are those of the fixture writer it was
copied from."""

import json
import os

import numpy as np
import pytest

from portbench.inputs import bamwrite, cache, synth

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name, reads=50_000):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) \
            as fh:
        cfg = json.load(fh)
    cfg["reads_per_sample"] = reads
    return cfg


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**40 + 1, -5])
def test_reads_deterministic_by_seed(seed):
    cfg = _cfg("capsicum_chr")
    a, b = synth.make_reads(cfg, seed), synth.make_reads(cfg, seed)
    c = synth.make_reads(cfg, seed + 1)
    for k in ("tid", "pos", "flag", "mapq", "kind"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.pos, c.pos)
    assert not np.array_equal(a.kind, c.kind)
    # the same work in another order
    n = cfg["reads_per_sample"]
    for r in (a, c):
        assert r.tid.shape[0] == n
        assert np.array_equal(np.bincount(r.tid), np.bincount(a.tid))
        for f, share in cfg["reads"]["flag_mix"]:
            assert abs(int((r.flag == f).sum()) - share * n) <= 6, f
        for k, (_, share) in enumerate(cfg["reads"]["cigar_mix"]):
            assert abs(int((r.kind == k).sum()) - share * n) <= 6, k
        assert np.array_equal(np.bincount(r.kind), np.bincount(a.kind))
        assert np.array_equal(np.unique(r.flag, return_counts=True)[1],
                              np.unique(a.flag, return_counts=True)[1])
        assert np.array_equal(np.unique(r.mapq, return_counts=True)[1],
                              np.full(4, n // 4))
        key = r.tid.astype(np.int64) << 32 | r.pos
        assert np.all(np.diff(key) >= 0)
        # the covered span at the source's depth
        assert r.pos.max() < cfg["covered_bases_per_contig"] - 200
        assert r.pos.min() < 1000
    depth = n * cfg["reads"]["read_length"] / (
        cfg["covered_bases_per_contig"] * cfg["genome"]["contigs"])
    assert depth == pytest.approx(cfg["depth_x"]) or n != 8_000_000


def test_annotation_counts_and_determinism(tmp_path):
    cfg = _cfg("capsicum_exon")
    a = synth.make_annotation(cfg, 2**31 + 3)
    b = synth.make_annotation(cfg, 2**31 + 3)
    assert np.array_equal(a.exon_start, b.exon_start)
    assert a.gene_tid.shape[0] == 33_688
    assert a.exon_start.shape[0] == 175_274 == a.exon_off[-1]
    assert np.all(a.exon_end >= a.exon_start)
    assert np.all(a.exon_end <= 250_000_000) and np.all(a.exon_start >= 1)
    path = str(tmp_path / "g.gff3")
    synth.write_gff3(path, cfg, a)
    kinds = {}
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.split("\t")[2]
                kinds[f] = kinds.get(f, 0) + 1
    assert kinds == {"gene": 33_688, "mRNA": 33_688, "exon": 175_274}


def test_bam_bytes_equal_the_fixture_writer(tmp_path):
    from pandepth_tpu_torch.io.bam_writer import write_uniform_bam

    cfg = _cfg("capsicum_chr", reads=40_000)
    r = synth.make_reads(cfg, 9)
    names = [n for n, _ in synth.genome(cfg)]
    lens = [ln for _, ln in synth.genome(cfg)]
    mine, theirs = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    bamwrite.write_uniform_bam(mine, names, lens, r.tid, r.pos, r.flag,
                               r.mapq, cigar="150M")
    write_uniform_bam(theirs, names, lens, r.tid, r.pos, r.flag, r.mapq)
    for ext in ("", ".bai"):
        with open(mine + ext, "rb") as f1, open(theirs + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext


def _records(path):
    """(tid, pos, flag, mapq, cigar, l_seq, block_size) of every record of
    a BAM, parsed here by hand."""
    import gzip
    import struct

    with gzip.open(path, "rb") as fh:
        data = fh.read()
    l_text = struct.unpack_from("<i", data, 4)[0]
    at = 8 + l_text
    n_ref = struct.unpack_from("<i", data, at)[0]
    at += 4
    for _ in range(n_ref):
        at += 8 + struct.unpack_from("<i", data, at)[0]
    out = []
    while at < len(data):
        size, tid, pos, lrn, mapq, _, n_op, flag, l_seq = \
            struct.unpack_from("<iiiBBHHHi", data, at)
        c = at + 36 + lrn
        ops = struct.unpack_from(f"<{n_op}I", data, c)
        cigar = "".join(f"{v >> 4}{'MIDNSHP=X'[v & 15]}" for v in ops)
        out.append((tid, pos, flag, mapq, cigar, l_seq, size))
        at += 4 + size
    return out


def test_mixed_cigars_decode(tmp_path):
    """The records of a mixed sample hold each read's CIGAR, sequence
    length and FLAG, all of one size (the shorter kinds padded by a tag)."""
    cfg = _cfg("capsicum_chr", reads=3_000)
    r = synth.make_reads(cfg, 2**31 + 1)
    path = str(tmp_path / "m.bam")
    synth.write_bam(path, cfg, r)
    got = _records(path)
    assert len(got) == 3_000
    for i, (tid, pos, flag, mapq, cigar, l_seq, size) in enumerate(got):
        want = r.cigars[r.kind[i]]
        assert (tid, pos, flag, mapq, cigar) == (
            r.tid[i], r.pos[i], r.flag[i], r.mapq[i], want)
        assert l_seq == sum(ln for op, ln in bamwrite.cigar_ops(want)
                            if op in (0, 1, 4, 7, 8))
    assert len({g[6] for g in got}) == 1
    assert {g[2] for g in got} == {f for f, _ in cfg["reads"]["flag_mix"]}


def test_cache_makes_once(tmp_path):
    cfg = _cfg("capsicum_exon", reads=20_000)
    text = json.dumps(cfg)
    a = cache.ensure(str(tmp_path), "capsicum_exon", text, cfg, 17)
    assert a.seconds > 0 and os.path.exists(a.bam + ".bai")
    assert os.path.exists(a.gff)
    b = cache.ensure(str(tmp_path), "capsicum_exon", text, cfg, 17)
    assert b.seconds == 0 and b.bam == a.bam
    ref = cache.reference(cfg, 17, b)
    assert ref.startswith(b"#Chr\tStart\tEnd\tGeneID")
    assert ref.count(b"\n") == 33_688 + 2
    assert cache.reference(cfg, 17, b) == ref
