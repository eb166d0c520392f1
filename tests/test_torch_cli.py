"""The port's chr-mode slice end to end on the CPU: pandepth_tpu_torch.cli
against the committed golden table and pandepth_tpu.cli on the same
inputs (byte-equal decompressed tables), its jax-free import, and its
clean refusals."""

import os
import subprocess
import sys

import pytest
import torch

from tests.fixtures import gunzip_bytes, make_bam, make_fasta

from pandepth_tpu.cli import main as jax_main
from pandepth_tpu_torch.cli import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "chr.chr.stat.gz.txt")


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    paths = {"bam": str(d / "t.bam"), "noidx": str(d / "noidx.bam"),
             "fa": str(d / "ref.fa"), "dir": str(d)}
    make_bam(paths["bam"], n=800, seed=11)
    make_bam(paths["noidx"], n=800, seed=11, make_index=False)
    make_fasta(paths["fa"])
    return paths


def _port_table(tmp_path, args, name="port"):
    out = str(tmp_path / name)
    assert port_main(["pandepth", *args, "-o", out], device="cpu") == 0
    return gunzip_bytes(out + ".chr.stat.gz")


def _jax_table(tmp_path, args):
    out = str(tmp_path / "jax")
    assert jax_main(["pandepth", *args, "-o", out]) == 0
    return gunzip_bytes(out + ".chr.stat.gz")


def test_golden_chr_table(tmp_path, bams):
    got = _port_table(tmp_path, ["-i", bams["bam"]])
    with open(GOLDEN, "rb") as fh:
        assert got == fh.read()
    assert got == _jax_table(tmp_path, ["-i", bams["bam"]])


@pytest.mark.parametrize("args", [
    ["-i", "{noidx}"],            # no index: wrap18 on
    ["-i", "{bam}", "-s"],        # index ignored: wrap18 on
    ["-i", "{bam}", "-q", "30", "-d", "2", "-x", "0"],
    ["-i", "{bam}", "-c", "-r", "{fa}"],
], ids=["no_index", "hidden_s", "filters", "gc"])
def test_chr_table_matches_jax_cli(tmp_path, bams, args):
    args = [a.format(**bams) for a in args]
    assert _port_table(tmp_path, args) == _jax_table(tmp_path, args)


def test_cli_imports_no_jax(tmp_path, bams):
    """A fresh process runs the port's CLI on the CPU without jax."""
    code = ("import sys\n"
            "from pandepth_tpu_torch.cli import main\n"
            f"rc = main(['pandepth', '-i', {bams['bam']!r}, '-o', "
            f"{str(tmp_path / 'sub')!r}], device='cpu')\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN, "rb") as fh:
        assert gunzip_bytes(str(tmp_path / "sub.chr.stat.gz")) == fh.read()


def test_cuda_without_gpu_fails_cleanly(tmp_path, bams, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = port_main(["pandepth", "-i", bams["bam"], "-o",
                    str(tmp_path / "x")])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "x.chr.stat.gz"))


def test_module_entry_point_without_gpu(tmp_path, bams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "pandepth_tpu_torch.cli",
                        "-i", bams["bam"], "-o", str(tmp_path / "m")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _unported_input(kind, d, bams):
    if kind == "list":
        p = os.path.join(d, "in.list")
        with open(p, "w") as fh:
            fh.write(f"{bams['bam']}\n{bams['noidx']}\n")
        return ["-i", p]
    if kind == "paf":
        p = os.path.join(d, "in.paf")
        with open(p, "w") as fh:
            fh.write("q\t100\t0\t50\t+\tchr1\t5000\t10\t60\t50\t50\t60\n")
        return ["-i", p]
    if kind == "sam":
        p = os.path.join(d, "in.sam")
        with open(p, "w") as fh:
            fh.write("@SQ\tSN:chr1\tLN:5000\n"
                     "r1\t0\tchr1\t10\t60\t50M\t*\t0\t0\t*\t*\n")
        return ["-i", p]
    if kind == "cram":
        p = os.path.join(d, "in.cram")
        with open(p, "wb") as fh:
            fh.write(b"CRAM\x03\x00" + bytes(64))
        return ["-i", p]
    return ["-i", bams["bam"]]


@pytest.mark.parametrize("kind,extra", [
    ("bam", ["-a"]),
    ("bam", ["-g", "{bam}"]),
    ("bam", ["-b", "{bed}"]),
    ("bam", ["-w", "500"]),
    ("bam", ["-w", "100"]),
    ("list", []),
    ("paf", []),
    ("sam", []),
    ("cram", []),
    ("no_native", []),
], ids=["site", "gff", "bed", "win", "win_small", "list", "paf", "sam",
        "cram", "no_native"])
def test_unported_inputs_exit_nonzero(tmp_path, bams, capsys, monkeypatch,
                                      kind, extra):
    d = str(tmp_path)
    bed = os.path.join(d, "t.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t10\t200\n")
    gff = os.path.join(d, "t.gff")
    with open(gff, "w") as fh:
        fh.write("chr1\tx\tCDS\t10\t200\t.\t+\t0\tParent=g1\n")
    extra = [a.format(bam=gff, bed=bed) for a in extra]
    if kind == "no_native":
        monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    args = _unported_input(kind, d, bams)
    out = os.path.join(d, "o")
    rc = port_main(["pandepth", *args, *extra, "-o", out], device="cpu")
    assert rc != 0
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not os.path.exists(out + ".chr.stat.gz")
