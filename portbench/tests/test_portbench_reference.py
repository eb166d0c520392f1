"""The plain reference: byte-equal to the reference binary's golden tables
on the golden inputs, equal to the program on the CPU at a small size,
and its control (the duplicate filter left off) fails the comparison."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from portbench import judge
from portbench.inputs import cache, synth
from portbench.jobs import Job
from portbench.reference import pandepth
from portbench.tests import golden_inputs as g
from portbench.tests.small import small_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _depth():
    tid, pos, flag, mapq, cigar = zip(*g.random_reads())
    return pandepth.Depth([ln for _, ln in g.CONTIGS], tid, pos, flag, mapq,
                          list(cigar), 1796, -1, 1)


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


def test_golden_chr():
    names = [n for n, _ in g.CONTIGS]
    assert pandepth.chr_table(names, _depth()) == \
        _golden("chr.chr.stat.gz.txt")


def test_golden_gene():
    names = [n for n, _ in g.CONTIGS]
    assert pandepth.gene_table(names, _depth(), g.gff_text(), "CDS") == \
        _golden("gene.gene.stat.gz.txt")


def _small(name):
    return small_cell(ROOT, name, reads=20_000).config


@pytest.mark.parametrize("name", ["capsicum_chr", "capsicum_exon"])
def test_program_agrees_on_the_cpu(name, tmp_path):
    cfg = _small(name)
    inputs = cache.ensure(str(tmp_path / "c"), name, json.dumps(cfg), cfg, 5)
    args = [a.format(annotation=inputs.gff) for a in cfg["pandepth"]["args"]]
    out = str(tmp_path / "o")
    env = dict(os.environ, PYTHONPATH=ROOT, PANDEPTH_DAEMON="0",
               PANDEPTH_FORCE_PLATFORM="cpu")
    subprocess.run([sys.executable, "-m", "pandepth_tpu_torch", "-i",
                    inputs.bam, "-o", out, *args], env=env, check=True,
                   timeout=300, capture_output=True)
    with gzip.open(f"{out}.{cfg['pandepth']['table']}.stat.gz", "rb") as fh:
        assert fh.read() == cache.reference(cfg, 5, inputs)


@pytest.mark.parametrize("name", ["capsicum_chr", "capsicum_exon"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(name, seed, tmp_path):
    """The control: the reference in the program's place with one stated
    guarantee broken, the duplicates (-x 1024) counted."""
    cfg = _small(name)
    inputs = cache.ensure(str(tmp_path / "c"), name, json.dumps(cfg), cfg,
                          seed)
    want = cache.reference(cfg, seed, inputs)
    ctl = cache.reference_text(cfg, seed, inputs,
                               exclude=cfg["pandepth"]["exclude_flags"]
                               & ~synth.DUP_FLAG).encode()
    job = Job(0, "window", str(tmp_path / "j" / "out"), rc=0)
    os.makedirs(tmp_path / "j")
    with gzip.open(f"{job.prefix}.{cfg['pandepth']['table']}.stat.gz",
                   "wb") as fh:
        fh.write(ctl)
    n, _ = judge.judge([job], cfg["pandepth"]["table"], want)
    assert n["tables_wrong"] == 1 and n["rows_wrong"] > 0
    assert not judge.passed(n)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.pandepth, "
            "portbench.inputs.cache, portbench.tests.golden_inputs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pandepth_tpu', "
            "'pandepth_tpu_torch')]; print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
