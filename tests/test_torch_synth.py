"""The port's fixture generators (pandepth_tpu_torch/synth.py, written
with its own BAM and CRAM writers) against the repo's generators at a
small size: byte-equal files from the same seeds and draws —
bench.py's ``ensure_fixture``, bench3gb.py's ``.list`` sample and PAF,
bench.py's reads unsorted, and the golden fixtures of tests/fixtures.py.
"""

import os
import time

import numpy as np
import pytest

import bench
import bench3gb
from tests import fixtures

from pandepth_tpu.io.bam_writer import write_uniform_bam
from pandepth_tpu.io.cram_writer import write_cram
from pandepth_tpu_torch import synth

N = 3000


def _same(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_bench_bam_is_bench_fixture(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setattr(bench, "N_READS", N)
    want = bench.ensure_fixture()
    got = synth.bench_bam(str(tmp_path / "port"), N)
    assert os.path.basename(got) == os.path.basename(want)
    _same(got, want)
    _same(got + ".bai", want + ".bai")


def test_list_sample_is_bench3gb_fixture(tmp_path, monkeypatch):
    monkeypatch.setattr(bench3gb, "N_READS", 2 * N)
    want, got = str(tmp_path / "want.bam"), str(tmp_path / "got.bam")
    bench3gb._gen_list_extra_fixture(want, 2)
    synth.list_sample_bam(got, 2, N)
    _same(got, want)
    _same(got + ".bai", want + ".bai")


def test_paf_is_bench3gb_fixture(tmp_path, monkeypatch):
    monkeypatch.setattr(bench3gb, "N_READS", N)
    want, got = str(tmp_path / "want.paf"), str(tmp_path / "got.paf")
    bench3gb._write_paf_fixture(want)
    synth.paf_file(got, N)
    _same(got, want)


def test_unsorted_bam_is_bench_reads_unsorted(tmp_path):
    """bench.py's draws (seed 42) without the coordinate sort, no index,
    through the JAX package's writer."""
    rng = np.random.RandomState(42)
    lens = np.array([g[1] for g in bench.GENOME])
    tid = rng.randint(0, len(bench.GENOME), N).astype(np.int32)
    pos = (rng.rand(N) * (lens[tid] - 200)).astype(np.int32)
    mapq = rng.choice([0, 10, 30, 60], N).astype(np.uint8)
    flag = np.where(rng.rand(N) < 0.05, 1024, 0).astype(np.uint16)
    want = str(tmp_path / "want.bam")
    write_uniform_bam(want, [g[0] for g in bench.GENOME], list(lens), tid,
                      pos, flag, mapq, make_index=False)
    got = synth.unsorted_bam(str(tmp_path), N)
    _same(got, want)
    assert not os.path.exists(got + ".bai")


@pytest.mark.parametrize("name", ["golden.bam", "golden.bam.bai", "t.bed",
                                  "t.gff", "safe.gff", "ref.fa",
                                  "golden.cram"])
def test_golden_inputs_are_test_fixtures(tmp_path, monkeypatch, name):
    # a CRAM block is gzip-compressed, and gzip stamps the current second:
    # one second for both writers
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    d, ref = tmp_path / "port", tmp_path / "ref"
    d.mkdir()
    ref.mkdir()
    synth.golden_inputs(str(d))
    recs = fixtures.make_bam(str(ref / "golden.bam"), n=800, seed=11)
    fixtures.make_bed(str(ref / "t.bed"))
    fixtures.make_gff(str(ref / "t.gff"))
    fixtures.make_gff(str(ref / "safe.gff"), overhang=False)
    fixtures.make_fasta(str(ref / "ref.fa"))
    write_cram(str(ref / "golden.cram"), [c[0] for c in fixtures.CONTIGS],
               [c[1] for c in fixtures.CONTIGS],
               [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
                for t, p, f, q, c in recs])
    _same(str(d / name), str(ref / name))
