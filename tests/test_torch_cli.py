"""The port's run end to end on the CPU: pandepth_tpu_torch.cli against
the committed golden tables and pandepth_tpu.cli on the same inputs
(byte-equal decompressed tables and ``.SiteDepth.gz``) for BAM, SAM,
gzipped SAM, CRAM, PAF, .list and unsorted inputs, through the native
feeds (encoded windows with PANDEPTH_ENC=1, which conftest sets, and raw
pairs with PANDEPTH_ENC=0) and the Python decoders' CIGAR feed, in chr,
-b, -g and -w modes (windows of 1, 100, 149 and 150 bp and more) and with
-a's per-base dump, on one device and through the sharded engine (8
rows); the engine election; its jax-free import, and its clean
failures."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import (CONTIGS, gunzip_bytes, make_bam, make_bed,
                            make_fasta, make_gff, random_reads)
from tests.test_paf import make_paf
from tests.test_sam import make_sam

from pandepth_tpu.io.bam_writer import write_bam
from pandepth_tpu.io.cram_writer import write_cram
from pandepth_tpu.cli import main as jax_main
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.engine import CoverageEngine
from pandepth_tpu_torch.device.layout import GenomeLayout
from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "chr.chr.stat.gz.txt")

# tests/test_golden.py's configurations and the table each writes
MODES = {"chr": ([], "chr"),
         "bed": (["-b", "{bed}"], "bed"),
         "gene": (["-g", "{gff}", "-f", "CDS"], "gene"),
         "gene_gc": (["-g", "{gff_safe}", "-c", "-r", "{fa}"], "gene"),
         "win": (["-w", "100"], "win"),
         "win500": (["-w", "500"], "win")}

# -a and -w below 150 (mode 6), with targets, filters and GC columns, and
# the outputs each writes
SMALL = {"site": (["-a"], ("chr.stat.gz", "SiteDepth.gz")),
         "site_bed": (["-a", "-b", "{bed}", "-d", "2"],
                      ("bed.stat.gz", "SiteDepth.gz")),
         "site_gene": (["-a", "-g", "{gff}", "-q", "20"],
                       ("gene.stat.gz", "SiteDepth.gz")),
         "w1": (["-w", "1"], ("win.stat.gz",)),
         "w100": (["-w", "100", "-d", "2"], ("win.stat.gz",)),
         "w149": (["-w", "149", "-q", "20", "-c", "-r", "{fa}"],
                  ("win.stat.gz",))}


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
             "other": str(d / "other.bam"), "unsorted": str(d / "uns.bam")}
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
    # the same reads out of coordinate order, no index
    recs = random_reads(n=800, seed=11)
    order = np.random.RandomState(3).permutation(len(recs))
    write_bam(paths["unsorted"], [c[0] for c in CONTIGS],
              [c[1] for c in CONTIGS], [recs[i] for i in order],
              make_index=False)
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


def _port_table(tmp_path, args, name="port", table="chr", device="cpu"):
    out = str(tmp_path / name)
    assert port_main(["pandepth", *args, "-o", out], device=device) == 0
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
@pytest.mark.parametrize("mode", ["chr", "bed", "gene", "gene_gc", "win"])
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
@pytest.mark.parametrize("mode", ["chr", "bed", "gene", "gene_gc", "win"])
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
    import pandepth_tpu_torch.io.native as native
    import pandepth_tpu_torch.run as port_run

    if broken == "library":
        monkeypatch.setattr(native, "load_library", lambda: None)
    else:
        monkeypatch.setattr(port_run, "try_native_load",
                            lambda *a, **k: None)
    out = str(tmp_path / "o")
    rc = port_main(["pandepth", "-i", bams["bam"], "-o", out], device="cpu")
    assert rc != 0
    assert "libpancov_io" in capsys.readouterr().err
    assert not batch_calls
    assert not os.path.exists(out + ".chr.stat.gz")


@pytest.fixture(scope="module")
def big_header(tmp_path_factory):
    """A coordinate-sorted BAM whose header takes more than 4 MiB of
    compressed bytes (random base64 @CO lines, as a fragmented assembly's
    contig table takes), with a .bai and, in another directory, without
    one."""
    import base64
    import shutil

    from pandepth_tpu_torch.io import bgzf
    from pandepth_tpu_torch.io.bam_writer import write_bam as port_write_bam

    d = tmp_path_factory.mktemp("big_header")
    names = [c[0] for c in CONTIGS]
    lengths = [c[1] for c in CONTIGS]
    noise = base64.b64encode(
        np.random.RandomState(21).bytes(9 << 19)).decode()
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths)) + \
        "".join(f"@CO\t{noise[i:i + 76]}\n"
                for i in range(0, len(noise), 76))
    path = str(d / "big.bam")
    port_write_bam(path, names, lengths, random_reads(n=800, seed=23),
                   header_text=text)
    # the compressed bytes of the blocks that the header's bytes fill
    hdr_bytes = 12 + len(text) + sum(9 + len(n) for n in names)
    with open(path, "rb") as fh:
        raw = fh.read()
    inflated = 0
    for off, bsize, payload in bgzf.iter_block_ranges(raw):
        inflated += len(bgzf.decompress_block(raw, off, payload, bsize))
        if inflated >= hdr_bytes:
            break
    assert off + bsize > 1 << 22
    (d / "noidx").mkdir()
    shutil.copy(path, str(d / "noidx" / "big.bam"))
    make_bed(str(d / "t.bed"))
    return {"bai": path, "noidx": str(d / "noidx" / "big.bam"),
            "bed": str(d / "t.bed")}


@pytest.mark.parametrize("index", ["bai", "noidx"])
@pytest.mark.parametrize("mode", ["chr", "bed"])
def test_large_header_takes_the_stream(tmp_path, big_header, monkeypatch,
                                       batch_calls, enc_finalizes, mode,
                                       index):
    """A BAM whose header is past the first 4 MiB of compressed bytes
    still takes the native stream, in chr mode and with -b, with and
    without a .bai: no batch reaches the CIGAR feed's add_batch, and the
    tables are byte-equal to pandepth_tpu.cli's."""
    _feed(monkeypatch, "1")
    args, table = MODES[mode]
    args = ["-i", big_header[index],
            *(a.format(bed=big_header["bed"]) for a in args)]
    got = _port_table(tmp_path, args, table=table)
    assert not batch_calls and enc_finalizes
    assert got == _jax_table(tmp_path, args, table=table)


def _outputs(tmp_path, args, names, device="cpu", jax=False):
    """The decompressed outputs ``names`` of one run of the port's CLI on
    ``device`` (or, with ``jax``, of pandepth_tpu.cli)."""
    out = str(tmp_path / ("jax" if jax else "port"))
    if jax:
        assert jax_main(["pandepth", *args, "-o", out]) == 0
    else:
        assert port_main(["pandepth", *args, "-o", out], device=device) == 0
    got = [gunzip_bytes(f"{out}.{name}") for name in names]
    assert all(len(g.splitlines()) > 1 for g in got)
    return got


def _small(tmp_path, bams, case, inp, device="cpu"):
    """SMALL[case] on input ``inp``, port against the JAX CLI."""
    extra, names = SMALL[case]
    src = bams[inp] if inp != "list" else \
        _list_file(tmp_path, bams["bam"], bams["noidx"], bams["sam"])
    args = ["-i", src, *(a.format(**bams) for a in extra)]
    got = _outputs(tmp_path, args, names, device)
    assert got == _outputs(tmp_path, args, names, jax=True)


@pytest.mark.parametrize("feed", ["raw", "enc", "no_native"])
@pytest.mark.parametrize("case", list(SMALL))
def test_small_windows_and_site_dump_match_jax_cli(tmp_path, bams,
                                                   monkeypatch,
                                                   enc_finalizes, case,
                                                   feed):
    """-a and -w 1/100/149 on the BAM through each feed: the tables and
    the .SiteDepth.gz byte-equal to pandepth_tpu.cli's."""
    if feed == "no_native":
        monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    else:
        _feed(monkeypatch, "1" if feed == "enc" else "0")
    _small(tmp_path, bams, case, "bam")
    assert bool(enc_finalizes) == (feed == "enc")


@pytest.mark.parametrize("inp,case", [
    ("noidx", "site"), ("noidx", "w100"),      # wrap18 on
    ("sam", "site"), ("sam", "w149"),
    ("sam_gz", "site_gene"),
    ("cram", "site"), ("cram", "w1"),
    ("list", "site"), ("list", "w100"),
    ("paf", "site"), ("paf_gz", "w100"),
    ("unsorted", "site"), ("unsorted", "w100"),
])
def test_small_modes_of_every_input_match_jax_cli(tmp_path, bams, inp,
                                                  case):
    _small(tmp_path, bams, case, inp)


@pytest.mark.parametrize("inp,case", [
    ("bam", "site"), ("bam", "site_bed"), ("bam", "w1"), ("bam", "w100"),
    ("bam", "w149"), ("list", "site"), ("paf", "w100"),
])
def test_sharded_small_modes_match_jax_cli(tmp_path, bams, monkeypatch,
                                           inp, case):
    """The sharded engine (8 CPU rows): -a from its merged host state,
    mode 6 through segment_stats on its kept state; against JAX's sharded
    engine (PANDEPTH_SHARDED=1 over the suite's 8 CPU devices)."""
    calls = []
    real = ShardedCoverageEngine.segment_stats

    def counted(self, *a, **k):
        calls.append(self.n_dev)
        return real(self, *a, **k)

    monkeypatch.setattr(ShardedCoverageEngine, "segment_stats", counted)
    monkeypatch.setenv("PANDEPTH_SHARDED", "1")
    _small(tmp_path, bams, case, inp, device=["cpu"] * 8)
    assert calls and set(calls) == {8}
    if case.startswith("w"):   # mode 6: one call per contig, after the first
        assert len(calls) > 1


def test_win6_without_native_formatter_matches_jax_cli(tmp_path, bams,
                                                       monkeypatch):
    """Where the native row formatter is absent, mode 6 writes its one-shot
    rows (``mode6_window_rows``): the same table."""
    import pandepth_tpu_torch.run as port_run

    monkeypatch.setattr(port_run, "write_win6_streaming",
                        lambda *a, **k: False)
    _small(tmp_path, bams, "w100", "bam")


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

    real = port_run.try_native_load
    monkeypatch.setattr(port_run, "try_native_load",
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


@pytest.mark.parametrize("inp,mode,native,rows", [
    ("bam", "chr", True, 8),
    ("bam", "bed", True, 8),
    ("bam", "gene", True, 8),
    ("bam", "win500", True, 8),
    ("bam", "chr", False, 8),
    ("bam", "bed", False, 8),
    ("bam", "gene_gc", False, 8),
    ("list", "chr", True, 8),
    ("list", "chr", False, 8),
    ("paf", "chr", True, 8),
    ("paf", "chr", False, 8),
    ("sam", "chr", True, 8),       # libpancov_io's SAM parse, int64 pairs
    ("cram", "bed", True, 8),      # CRAM intervals / the region cursor
    ("bam", "chr", True, 1),       # PANDEPTH_SHARDED=1 on one device
], ids=["chr", "bed", "gene", "win500", "chr_no_native", "bed_no_native",
        "gene_gc_no_native", "list", "list_no_native", "paf",
        "paf_no_native", "sam", "cram_bed", "one_row"])
def test_sharded_cli_matches_jax_and_golden(tmp_path, bams, monkeypatch,
                                            inp, mode, native, rows):
    """The port's CLI with device=["cpu"] * rows (the sharded engine, its
    kernels' twins) byte-equal to pandepth_tpu.cli with PANDEPTH_SHARDED=1
    over the suite's 8 CPU devices, and for the golden BAM's
    configurations to the golden tables."""
    calls = []
    real = ShardedCoverageEngine.segment_stats

    def counted(self, *a, **k):
        calls.append(self.n_dev)
        return real(self, *a, **k)

    monkeypatch.setattr(ShardedCoverageEngine, "segment_stats", counted)
    if not native:
        monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    if rows == 1:
        monkeypatch.setenv("PANDEPTH_SHARDED", "1")
    extra, table = MODES[mode]
    src = {"bam": bams["bam"], "paf": bams["paf"], "sam": bams["sam"],
           "cram": bams["cram"],
           "list": _list_file(tmp_path, bams["bam"], bams["bam2"])}[inp]
    args = ["-i", src, *(a.format(**bams) for a in extra)]
    got = _port_table(tmp_path, args, table=table, device=["cpu"] * rows)
    assert calls and set(calls) == {rows}
    monkeypatch.setenv("PANDEPTH_SHARDED", "1")
    assert got == _jax_table(tmp_path, args, table=table)
    if inp == "bam" and mode != "win500":     # -w 500 has no golden
        with open(os.path.join(GOLDEN_DIR, f"{mode}.{table}.stat.gz.txt"),
                  "rb") as fh:
            assert got == fh.read()


def test_engine_election(monkeypatch):
    """pandepth_tpu.run.make_engine's rule (tests/test_sharding.py:124):
    more than one device elects the sharded engine, one row per entry
    (repeats allowed); PANDEPTH_SHARDED=1 forces it even over one device,
    =0 forces the single-device engine on the first."""
    from pandepth_tpu_torch.run import make_engine

    lay = GenomeLayout(np.array([1000], np.int64))
    monkeypatch.delenv("PANDEPTH_SHARDED", raising=False)
    eng = make_engine(lay, ["cpu"] * 8)
    assert isinstance(eng, ShardedCoverageEngine) and eng.n_dev == 8
    assert isinstance(make_engine(lay, "cpu"), CoverageEngine)
    monkeypatch.setenv("PANDEPTH_SHARDED", "1")
    eng = make_engine(lay, "cpu")
    assert isinstance(eng, ShardedCoverageEngine) and eng.n_dev == 1
    monkeypatch.setenv("PANDEPTH_SHARDED", "0")
    assert isinstance(make_engine(lay, ["cpu"] * 8), CoverageEngine)


def test_resolve_devices():
    """No device means every visible CUDA device, of which there must be
    one; a sequence keeps its repeats; no other device type runs."""
    from pandepth_tpu_torch.cli import resolve_devices

    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert resolve_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        resolve_devices(["cpu", "meta"])
    if not torch.cuda.is_available():
        for dev in (None, ["cpu", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_devices(dev)
