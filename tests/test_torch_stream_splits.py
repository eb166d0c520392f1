"""The port's whole-file stream walked in index-cut splits against the
serial walk: the same BAM streamed by the port with its index's record
starts (``cuts``), by the port without them (the serial walk, as with the
``.bai`` removed) and by the JAX package's ``NativeBamStream`` (the serial
walk it was ported from). Every window's events concatenated,
``take_enc_acc``'s encoded windows, ``n_records`` and the final
``progress()`` must be equal; the split share says which path ran.

Exact equality throughout: the walks decode the same records into the
same integer events, whatever the splits and windows.
"""

import os
import re
import shutil

import numpy as np
import pytest

from pandepth_tpu.io.native import NativeBamStream as JaxStream
from tests.fixtures import gunzip_bytes, make_bed, random_reads

from pandepth_tpu.io.bam_writer import write_bam
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.io.bamindex import (BamIndex, load_index_for,
                                            record_starts)
from pandepth_tpu_torch.io.native import NativeBamStream, load_library

#: contigs long enough for hundreds of index bins, so a 1 MB window cuts
#: the file into tens of splits
CONTIGS = [("chr1", 3_000_000), ("chr2", 2_000_000), ("chrM", 16_000)]
N_READS = 50_000
N_UNPLACED = 400
MB = 1 << 20


def _write(path, seed, contigs=CONTIGS, n=N_READS, unplaced=N_UNPLACED):
    """A sorted, indexed BAM of ``n`` reads with mixed CIGARs, FLAGs and
    MAPQs, then ``unplaced`` unmapped reads with no reference at the
    file's end (which no index bin holds)."""
    recs = random_reads(contigs, n, seed)
    recs += [(-1, -1, 4, 0, "*")] * unplaced
    write_bam(path, [c[0] for c in contigs], [c[1] for c in contigs], recs)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    d = tmp_path_factory.mktemp("splits")
    bam, other = str(d / "s.bam"), str(d / "o.bam")
    _write(bam, 31)
    _write(other, 32, contigs=[("chr1", 2_500_000), ("chr2", 900_000)],
           n=20_000, unplaced=0)
    return {"dir": d, "bam": bam, "other": other,
            "cuts": record_starts(load_index_for(bam))}


def _drain(r):
    """Every window's events, concatenated; n_records; the split share;
    the final progress."""
    es, ee = [], []
    while True:
        n = r.wait()
        if n < 0:
            break
        s, e = r.take64(n)
        es.append(s)
        ee.append(e)
    share = r.split_share() if hasattr(r, "split_share") else None
    out = (np.concatenate(es), np.concatenate(ee), r.n_records, share,
           r.progress())
    r.close()
    return out


def _encoded(r, cap=4096, exc=256):
    """take_enc_acc's windows, each as a tuple of bytes."""
    wins = []
    while (w := r.take_enc_acc(cap, exc)) is not None:
        n, dd, ll, excd, excl, base = w
        wins.append((n, dd.tobytes(), ll.tobytes(), excd.tobytes(),
                     excl.tobytes(), base))
    n_rec = r.n_records
    r.close()
    return wins, n_rec


def _three(bam, cuts, threads, window, flags, mapq):
    """(split walk, serial walk, JAX's walk) of ``bam``."""
    kw = dict(threads=threads, window_bytes=window)
    return (NativeBamStream(bam, flags, mapq, cuts=cuts, **kw),
            NativeBamStream(bam, flags, mapq, **kw),
            JaxStream(bam, flags, mapq, **kw))


@pytest.mark.parametrize("flags,mapq", [(1796, 0), (1796, 30)])
@pytest.mark.parametrize("window", [MB, 0])
@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_split_walk_equals_serial_walk(bams, threads, window, flags, mapq):
    split, serial, jax = (_drain(r) for r in _three(
        bams["bam"], bams["cuts"], threads, window, flags, mapq))
    assert split[3] == 1.0 and serial[3] == 0.0
    assert split[2] == serial[2] == jax[2] == N_READS + N_UNPLACED
    for got in (serial, jax):
        assert np.array_equal(split[0], got[0])
        assert np.array_equal(split[1], got[1])
        assert split[4] == got[4]
    assert split[4][0] == 1.0


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_split_walk_encoded_windows(bams, threads):
    """The encoded windows accumulate across stream windows, so they are
    the same buffers whatever the splits."""
    split, serial, jax = (_encoded(r) for r in _three(
        bams["bam"], bams["cuts"], threads, MB, 1796, 0))
    assert split == serial == jax
    assert len(split[0]) > 4


def test_splits_are_many(bams, capfd, monkeypatch):
    """The fixture really is cut: the index has hundreds of record
    starts, and a 1 MB window's walk (``PANDEPTH_STREAM_DEBUG``'s
    summary line) tens of splits, every one walked to its cut."""
    assert len(bams["cuts"]) > 300
    monkeypatch.setenv("PANDEPTH_STREAM_DEBUG", "1")
    capfd.readouterr()
    _drain(NativeBamStream(bams["bam"], 1796, 0, threads=3,
                           window_bytes=MB, cuts=bams["cuts"]))
    m = re.search(r"\[stream\] splits=(\d+) walked=(\d+) threads=3 ",
                  capfd.readouterr().err)
    assert m and int(m.group(1)) == int(m.group(2)) >= 8, m


@pytest.mark.parametrize("threads", [1, 3])
def test_foreign_index_falls_back(bams, tmp_path, threads):
    """Another BAM's index beside this one: a split does not end on its
    cut, the serial walk takes over from the last verified offset, and
    the events are the serial walk's."""
    bam = str(tmp_path / "s.bam")
    shutil.copy(bams["bam"], bam)
    shutil.copy(bams["other"] + ".bai", bam + ".bai")
    cuts = record_starts(load_index_for(bam))
    split, serial, jax = (_drain(r) for r in _three(
        bam, cuts, threads, MB, 1796, 0))
    assert 0.0 <= split[3] < 1.0
    for got in (serial, jax):
        assert np.array_equal(split[0], got[0])
        assert np.array_equal(split[1], got[1])
        assert split[2] == got[2] and split[4] == got[4]


@pytest.mark.parametrize("threads", [1, 3])
def test_shifted_cuts_fall_back_mid_stream(bams, threads):
    """Cuts that are right up to the middle of the file and one byte off
    after it: the splits before the bad cut count, the rest is walked
    serially, and the events are still the serial walk's."""
    cuts = bams["cuts"].copy()
    half = cuts.shape[0] // 2
    cuts[half:] += 1
    split, serial, jax = (_drain(r) for r in _three(
        bams["bam"], cuts, threads, MB, 1796, 0))
    assert 0.0 < split[3] < 1.0
    for got in (serial, jax):
        assert np.array_equal(split[0], got[0])
        assert np.array_equal(split[1], got[1])
        assert split[2] == got[2] and split[4] == got[4]


def _failure(r):
    with pytest.raises(ValueError) as e:
        _drain(r)
    r.close()
    return str(e.value)


@pytest.mark.parametrize("share", [0.3, 0.77])
@pytest.mark.parametrize("threads", [1, 3])
def test_truncated_bam_fails_as_before(bams, tmp_path, share, threads):
    """A BAM cut short beside its full file's index fails as the serial
    walk fails: the same error."""
    bam = str(tmp_path / "t.bam")
    with open(bams["bam"], "rb") as fh:
        data = fh.read()
    with open(bam, "wb") as fh:
        fh.write(data[: int(len(data) * share)])
    msgs = [_failure(r) for r in _three(bam, bams["cuts"], threads, MB,
                                        1796, 0)]
    assert msgs[0] == msgs[1] == msgs[2]
    assert "truncated" in msgs[0]


@pytest.mark.parametrize("depth,pseudo", [(5, 37450), (6, 299594)])
def test_record_starts_leave_out_the_pseudo_bin(depth, pseudo):
    """htslib's pseudo-bin holds the reference's offset range and its
    mapped and unmapped counts, not chunks: its "starts" are no cuts."""
    chunks = {4681: np.array([[7 << 16, 9 << 16]]),
              1: np.array([[3 << 16 | 20, 7 << 16]]),
              pseudo: np.array([[3 << 16 | 20, 9 << 16], [1234, 56]])}
    idx = BamIndex(1, [chunks], [np.zeros(0, np.int64)], depth=depth)
    assert record_starts(idx).tolist() == [3 << 16 | 20, 7 << 16]


def _feed_split(err: str) -> float:
    m = re.findall(r"^INFO: phase feed\.split: ([0-9.]+)s$", err, re.M)
    assert len(m) == 1, err
    return float(m[0])


def _cli(bam, out, extra, capsys):
    capsys.readouterr()
    assert port_main(["pandepth", "-i", bam, "-o", out, "-t", "3", "-v",
                      *extra], device="cpu") == 0
    return capsys.readouterr().err


@pytest.mark.parametrize("index,extra,share", [
    (True, [], 1.0),           # chr mode: the split walk
    (False, [], 0.0),          # no index: the serial walk
    (True, ["-b", "{bed}"], 1.0),   # the ranged stream: ranged splits
    (False, ["-b", "{bed}"], 0.0),  # the region cursor
])
def test_feed_split_by_stream(bams, tmp_path, capsys, index, extra,
                              share):
    bam = str(tmp_path / "s.bam")
    shutil.copy(bams["bam"], bam)
    if index:
        shutil.copy(bams["bam"] + ".bai", bam + ".bai")
    bed = str(tmp_path / "r.bed")
    make_bed(bed, CONTIGS)
    err = _cli(bam, str(tmp_path / "p"), [a.format(bed=bed) for a in extra],
               capsys)
    assert _feed_split(err) == share


@pytest.mark.parametrize("enc", ["1", "0"])
def test_cli_tables_equal_with_and_without_index(bams, tmp_path, capsys,
                                                 monkeypatch, enc):
    """A chr run through the split walk writes the serial walk's table,
    byte for byte, on the encoded feed and the raw one."""
    monkeypatch.setenv("PANDEPTH_ENC", enc)
    monkeypatch.setenv("PANDEPTH_ENC_CAP", "4096")
    monkeypatch.setenv("PANDEPTH_ENC_EXC", "512")
    monkeypatch.setenv("PANDEPTH_STREAM_WINDOW", str(MB))
    bam = str(tmp_path / "s.bam")
    shutil.copy(bams["bam"], bam)
    shutil.copy(bams["bam"] + ".bai", bam + ".bai")
    err = _cli(bam, str(tmp_path / "a"), [], capsys)
    assert _feed_split(err) == 1.0
    os.remove(bam + ".bai")
    err = _cli(bam, str(tmp_path / "b"), [], capsys)
    assert _feed_split(err) == 0.0
    assert gunzip_bytes(str(tmp_path / "a.chr.stat.gz")) == \
        gunzip_bytes(str(tmp_path / "b.chr.stat.gz"))
