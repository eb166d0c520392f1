"""The port's run end to end on the CPU: pandepth_tpu_torch.cli against
the committed golden tables and pandepth_tpu.cli on the same inputs
(byte-equal decompressed tables) for BAM, SAM, gzipped SAM, CRAM, PAF
and .list inputs, through the native feeds (encoded windows with
PANDEPTH_ENC=1, which conftest sets, and raw pairs with PANDEPTH_ENC=0)
and the Python decoders' CIGAR feed, in chr, -b, -g and -w >= 150
modes; its jax-free import, and its clean refusals."""

import os
import subprocess
import sys

import pytest
import torch

from tests.fixtures import (CONTIGS, gunzip_bytes, make_bam, make_bed,
                            make_fasta, make_gff, random_reads)
from tests.test_paf import make_paf
from tests.test_sam import make_sam

from pandepth_tpu.io.cram_writer import write_cram
from pandepth_tpu.cli import main as jax_main
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.engine import CoverageEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "chr.chr.stat.gz.txt")

# tests/test_golden.py's configurations (-w 100 is not in this slice)
# and the table each writes
MODES = {"chr": ([], "chr"),
         "bed": (["-b", "{bed}"], "bed"),
         "gene": (["-g", "{gff}", "-f", "CDS"], "gene"),
         "gene_gc": (["-g", "{gff_safe}", "-c", "-r", "{fa}"], "gene"),
         "win500": (["-w", "500"], "win")}


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    paths = {"bam": str(d / "t.bam"), "noidx": str(d / "noidx.bam"),
             "fa": str(d / "ref.fa"), "dir": str(d),
             "bed": str(d / "t.bed"), "gff": str(d / "t.gff"),
             "gff_safe": str(d / "safe.gff"), "sam": str(d / "t.sam"),
             "sam_gz": str(d / "t.sam.gz"), "cram": str(d / "t.cram"),
             "bam2": str(d / "t2.bam"), "paf": str(d / "t.paf"),
             "paf_gz": str(d / "t.paf.gz"), "paf2": str(d / "t2.paf"),
             "other": str(d / "other.bam")}
    make_bam(paths["bam"], n=800, seed=11)
    make_bam(paths["bam2"], n=600, seed=12)
    # another contig table: reordered, and a fourth contig past the first
    # file's three (a .list reads it in the first file's contig space)
    make_bam(paths["other"], contigs=[("ctgM", 700), ("chr1", 5000),
                                      ("chrX", 4000), ("chr2", 3200)],
             n=600, seed=13)
    make_paf(paths["paf"])
    make_paf(paths["paf_gz"], gz=True, seed=14)
    make_paf(paths["paf2"], seed=15)
    make_bam(paths["noidx"], n=800, seed=11, make_index=False)
    make_fasta(paths["fa"])
    make_bed(paths["bed"])
    make_gff(paths["gff"])
    make_gff(paths["gff_safe"], overhang=False)
    make_sam(paths["sam"])
    make_sam(paths["sam_gz"], gz=True, seed=18)
    # CRAM canonicalizes =/X to M (the same depth)
    recs = [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
            for t, p, f, q, c in random_reads(n=400, seed=66)]
    write_cram(paths["cram"], [c[0] for c in CONTIGS],
               [c[1] for c in CONTIGS], recs)
    return paths


def _port_table(tmp_path, args, name="port", table="chr"):
    out = str(tmp_path / name)
    assert port_main(["pandepth", *args, "-o", out], device="cpu") == 0
    return gunzip_bytes(f"{out}.{table}.stat.gz")


def _jax_table(tmp_path, args, table="chr"):
    out = str(tmp_path / "jax")
    assert jax_main(["pandepth", *args, "-o", out]) == 0
    return gunzip_bytes(f"{out}.{table}.stat.gz")


@pytest.fixture
def batch_calls(monkeypatch):
    """Counts the read batches the CIGAR feed hands to the engine."""
    calls = []
    real = CoverageEngine.add_batch

    def counted(self, batch):
        calls.append(batch.n_reads)
        return real(self, batch)

    monkeypatch.setattr(CoverageEngine, "add_batch", counted)
    return calls


@pytest.fixture
def enc_finalizes(monkeypatch):
    """Counts the finalizes that decode encoded windows."""
    calls = []
    real = sweep.finalize_encoded

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(sweep, "finalize_encoded", counted)
    return calls


def _feed(monkeypatch, enc):
    """PANDEPTH_ENC=enc for both CLIs. The port decodes a window less than
    half full on the host, so the encoded feed gets windows of 256 pairs,
    which the fixtures' hundreds of reads fill."""
    monkeypatch.setenv("PANDEPTH_ENC", enc)
    if enc == "1":
        monkeypatch.setenv("PANDEPTH_ENC_CAP", "256")
        monkeypatch.setenv("PANDEPTH_ENC_EXC", "256")


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


def _golden(tmp_path, bams, monkeypatch, batch_calls, enc_finalizes, mode,
            native, enc):
    _feed(monkeypatch, enc)
    if not native:
        monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    args, table = MODES[mode]
    got = _port_table(tmp_path, ["-i", bams["bam"],
                                 *(a.format(**bams) for a in args)],
                      table=table)
    with open(os.path.join(GOLDEN_DIR, f"{mode}.{table}.stat.gz.txt"),
              "rb") as fh:
        assert got == fh.read()
    assert bool(batch_calls) != native
    assert bool(enc_finalizes) == (native and enc == "1")


@pytest.mark.parametrize("native", [True, False], ids=["native",
                                                         "no_native"])
@pytest.mark.parametrize("mode", ["chr", "bed", "gene", "gene_gc"])
def test_golden_tables(tmp_path, bams, monkeypatch, batch_calls,
                       enc_finalizes, mode, native):
    """tests/test_golden.py's BAM configurations, through the native
    stream's encoded windows or (PANDEPTH_NO_NATIVE=1) the Python decoder
    and the CIGAR feed, byte-equal to the reference binary's golden
    tables."""
    _golden(tmp_path, bams, monkeypatch, batch_calls, enc_finalizes, mode,
            native, "1")


@pytest.mark.parametrize("native", [True, False], ids=["native",
                                                         "no_native"])
@pytest.mark.parametrize("mode", ["chr", "bed", "gene", "gene_gc"])
def test_golden_tables_raw_feed(tmp_path, bams, monkeypatch, batch_calls,
                                enc_finalizes, mode, native):
    """The same with PANDEPTH_ENC=0: the native stream's raw pairs."""
    _golden(tmp_path, bams, monkeypatch, batch_calls, enc_finalizes, mode,
            native, "0")


@pytest.mark.parametrize("inp,mode,batches", [
    ("sam", "chr", False),         # libpancov_io's SAM text parse
    ("sam", "bed", True),          # coordinate-sorted: the region cursor
    ("sam_gz", "chr", False),
    ("sam_gz", "gene", True),
    ("sam_no_native", "chr", True),
    ("sam_no_native", "gene_gc", True),
    ("cram", "chr", False),        # vectorised slices -> intervals
    ("cram", "bed", True),
    ("bam_no_native", "win500", True),
    ("bam", "win500", False),
])
def test_input_tables_match_jax_cli(tmp_path, bams, monkeypatch,
                                    batch_calls, inp, mode, batches):
    """Each input kind and feed against pandepth_tpu.cli on the same
    input; ``batches`` says whether the run rode the CIGAR feed."""
    if inp.endswith("_no_native"):
        monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
        inp = inp[: -len("_no_native")]
    args, table = MODES[mode]
    args = ["-i", bams[inp], *(a.format(**bams) for a in args)]
    got = _port_table(tmp_path, args, table=table)
    assert bool(batch_calls) == batches
    assert got == _jax_table(tmp_path, args, table=table)


def test_cigar_feed_imports_no_jax(tmp_path, bams):
    """A fresh process runs the Python decoder's CIGAR feed on the CPU
    without jax, into the golden bed table."""
    code = ("import sys\n"
            "from pandepth_tpu_torch.cli import main\n"
            f"rc = main(['pandepth', '-i', {bams['bam']!r}, '-b', "
            f"{bams['bed']!r}, '-o', {str(tmp_path / 'sub')!r}], "
            "device='cpu')\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PANDEPTH_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(GOLDEN_DIR, "bed.bed.stat.gz.txt"), "rb") as fh:
        assert gunzip_bytes(str(tmp_path / "sub.bed.stat.gz")) == fh.read()


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


@pytest.mark.parametrize("broken", ["library", "loader"])
def test_native_failure_exits_nonzero(tmp_path, bams, capsys, monkeypatch,
                                      batch_calls, broken):
    """Without PANDEPTH_NO_NATIVE=1, a libpancov_io that does not load,
    or a native loader that cannot read the BAM, fails the run: it never
    moves onto the Python decoder."""
    import pandepth_tpu.io.native as native
    import pandepth_tpu_torch.run as port_run

    if broken == "library":
        monkeypatch.setattr(native, "load_library", lambda: None)
    else:
        monkeypatch.setattr(port_run, "_try_native_load",
                            lambda *a, **k: None)
    out = str(tmp_path / "o")
    rc = port_main(["pandepth", "-i", bams["bam"], "-o", out], device="cpu")
    assert rc != 0
    assert "libpancov_io" in capsys.readouterr().err
    assert not batch_calls
    assert not os.path.exists(out + ".chr.stat.gz")


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
    return ["-i", bams["bam"]]


@pytest.mark.parametrize("kind,extra", [
    ("bam", ["-a"]),
    ("bam", ["-w", "100"]),
    ("list", ["-a"]),
    ("paf", ["-a"]),
], ids=["site", "win_small", "list", "paf"])
def test_unported_inputs_exit_nonzero(tmp_path, bams, capsys, kind, extra):
    d = str(tmp_path)
    args = _unported_input(kind, d, bams)
    out = os.path.join(d, "o")
    rc = port_main(["pandepth", *args, *extra, "-o", out], device="cpu")
    assert rc != 0
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not os.path.exists(out + ".chr.stat.gz")


def _list_file(d, *paths):
    p = os.path.join(str(d), "in.list")
    with open(p, "w") as fh:
        fh.write("".join(f"{x}\n" for x in paths))
    return p


@pytest.mark.parametrize("enc", ["0", "1"], ids=["raw", "enc"])
@pytest.mark.parametrize("members,extra,table", [
    (("bam", "bam2"), [], "chr"),
    (("bam", "noidx"), [], "chr"),          # indexed and unindexed
    (("bam", "other"), [], "chr"),          # another contig table
    (("bam", "sam", "cram"), [], "chr"),    # one .list, three formats
    (("bam", "bam2"), ["-b", "{bed}"], "bed"),
    (("bam2", "sam_gz"), ["-g", "{gff}", "-f", "CDS"], "gene"),
], ids=["two_bams", "indexed_unindexed", "foreign_contigs",
        "bam_sam_cram", "bed", "gene"])
def test_list_tables_match_jax_cli(tmp_path, bams, monkeypatch,
                                   enc_finalizes, members, extra, table,
                                   enc):
    """A .list pools its members into one table (wrap18 on, every later
    member in the first file's contig space), under either feed."""
    _feed(monkeypatch, enc)
    args = ["-i", _list_file(tmp_path, *(bams[m] for m in members)),
            *(a.format(**bams) for a in extra)]
    got = _port_table(tmp_path, args, table=table)
    assert bool(enc_finalizes) == (enc == "1")
    assert got == _jax_table(tmp_path, args, table=table)


def test_list_no_native_matches_jax_cli(tmp_path, bams, monkeypatch,
                                        batch_calls):
    """PANDEPTH_NO_NATIVE=1: every member through the Python decoders and
    the CIGAR feed (later members' tids past the first file's contigs
    dropped)."""
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    args = ["-i", _list_file(tmp_path, bams["bam"], bams["other"],
                             bams["sam"])]
    got = _port_table(tmp_path, args)
    assert len(batch_calls) >= 3
    assert got == _jax_table(tmp_path, args)


def test_list_member_native_failure_exits_nonzero(tmp_path, bams, capsys,
                                                  monkeypatch, batch_calls):
    """A later BAM of a .list whose native loader fails fails the run, as
    the first one does."""
    import pandepth_tpu_torch.run as port_run

    real = port_run._try_native_load
    monkeypatch.setattr(port_run, "_try_native_load",
                        lambda path, *a, **k: None if path == bams["bam2"]
                        else real(path, *a, **k))
    out = str(tmp_path / "o")
    rc = port_main(["pandepth", "-i", _list_file(tmp_path, bams["bam"],
                                                 bams["bam2"]), "-o", out],
                   device="cpu")
    assert rc != 0
    assert "libpancov_io" in capsys.readouterr().err
    assert not batch_calls and not os.path.exists(out + ".chr.stat.gz")


@pytest.mark.parametrize("enc", ["0", "1"], ids=["raw", "enc"])
@pytest.mark.parametrize("inp,extra,table", [
    (("paf",), [], "chr"),
    (("paf_gz",), ["-w", "300"], "win"),
    (("paf",), ["-q", "30", "-x", "256"], "chr"),
    (("paf",), ["-r", "{fa}"], "chr"),              # -r alone: GC columns
    (("paf",), ["-c", "-r", "{fa}"], "chr"),
    (("paf",), ["-b", "{bed}"], "bed"),
    (("paf", "paf2"), [], "chr"),                   # a .list of PAFs
], ids=["chr", "gz_win", "filters", "ref_gc", "gc", "bed", "list"])
def test_paf_tables_match_jax_cli(tmp_path, bams, monkeypatch, inp, extra,
                                  table, enc):
    _feed(monkeypatch, enc)
    src = bams[inp[0]] if len(inp) == 1 else \
        _list_file(tmp_path, *(bams[p] for p in inp))
    args = ["-i", src, *(a.format(**bams) for a in extra)]
    got = _port_table(tmp_path, args, table=table)
    assert got == _jax_table(tmp_path, args, table=table)


def test_paf_no_native_matches_jax_cli(tmp_path, bams, monkeypatch):
    """PANDEPTH_NO_NATIVE=1: the Python PAF reader's intervals."""
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    args = ["-i", bams["paf"]]
    assert _port_table(tmp_path, args) == _jax_table(tmp_path, args)


@pytest.mark.parametrize("kind", ["list", "paf"])
def test_list_and_paf_import_no_jax(tmp_path, bams, kind):
    """A fresh process runs a .list of BAMs (encoded windows) or a PAF
    on the CPU without jax."""
    src = _list_file(tmp_path, bams["bam"], bams["bam2"]) \
        if kind == "list" else bams["paf"]
    code = ("import sys\n"
            "from pandepth_tpu_torch.cli import main\n"
            f"rc = main(['pandepth', '-i', {src!r}, '-o', "
            f"{str(tmp_path / 'sub')!r}], device='cpu')\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PANDEPTH_ENC="1",
               PANDEPTH_ENC_CAP="256", PANDEPTH_ENC_EXC="256")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert os.path.getsize(str(tmp_path / "sub.chr.stat.gz")) > 0
