"""The reference's 18-bit depth cells (quirk Q1) in the port: ``run.prepare``
gives the engine the ``wrap18`` that ``pandepth_tpu.run.run_alignment``
decides (``-a``, ``-w`` below 150, no usable index, a ``.list``), for
every combination of them; and on an indexed BAM deeper than 2^18 (one
400 bp contig, 270,000 ``20M`` reads at 100 and five ``50M`` reads at
300) the port's ``-a`` dump and chr table, its ``-w 100`` table and its
plain chr table are byte-equal to ``pandepth_tpu.cli``'s, on one device
and on 8 rows of the sharded engine."""

import itertools

import pytest

import pandepth_tpu.run as jax_run
from pandepth_tpu.cli import main as jax_main
from pandepth_tpu.cli import parse_args as jax_parse
from tests.fixtures import gunzip_bytes, make_bam

import pandepth_tpu_torch.run as port_run
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.cli import parse_args as port_parse
from pandepth_tpu_torch import synth


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The deep BAM (synth.deep_bam: ~10 s) and the small
    BAMs of the election test, one with an index and one without."""
    d = tmp_path_factory.mktemp("wrap18")
    paths = {"deep": synth.deep_bam(str(d)), "bam": str(d / "t.bam"),
             "noidx": str(d / "noidx.bam"), "bam2": str(d / "t2.bam"),
             "dir": d}
    make_bam(paths["bam"], n=200, seed=11)
    make_bam(paths["noidx"], n=200, seed=11, make_index=False)
    make_bam(paths["bam2"], n=200, seed=12)
    return paths


class _Elected(Exception):
    pass


def _jax_wrap18(monkeypatch, argv) -> bool:
    """The wrap18 that pandepth_tpu.run.run hands its engine for argv."""
    def make_engine(layout, **kw):
        raise _Elected(kw["wrap18"])

    monkeypatch.setattr(jax_run, "make_engine", make_engine)
    with pytest.raises(_Elected) as got:
        jax_run.run(jax_parse(argv))
    return got.value.args[0]


@pytest.mark.parametrize(
    "indexed,site,win,many,no_index_flag",
    list(itertools.product((True, False), (False, True),
                           (None, "100", "1500"), (False, True),
                           (False, True))))
def test_prepare_elects_jax_wrap18(deep, monkeypatch, indexed, site, win,
                                   many, no_index_flag):
    # the Python decoders: prepare starts no native loader
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    first = deep["bam"] if indexed else deep["noidx"]
    argv = ["pandepth", "-i", first, "-o", str(deep["dir"] / "x")]
    if many:
        lst = str(deep["dir"] / f"in{int(indexed)}.list")
        with open(lst, "w") as fh:
            fh.write(f"{first}\n{deep['bam2']}\n")
        argv[2] = lst
    argv += (["-a"] if site else []) + (["-w", win] if win else []) \
        + (["-s"] if no_index_flag else [])
    st = port_run.prepare(port_parse(argv), "cpu")
    assert st.engine.wrap18 == _jax_wrap18(monkeypatch, argv)
    # the rule itself, as pandepth_tpu/run.py states it
    assert st.engine.wrap18 == (site or (win == "100") or not indexed
                                or no_index_flag or many)


@pytest.fixture(scope="module")
def jax_deep(deep, tmp_path_factory):
    """pandepth_tpu.cli's outputs on the deep BAM, per case."""
    cache = {}

    def get(case):
        if case not in cache:
            args, names = CASES[case]
            out = str(tmp_path_factory.mktemp("jaxdeep") / "j")
            assert jax_main(["pandepth", "-i", deep["deep"], *args, "-o",
                             out]) == 0
            cache[case] = [gunzip_bytes(f"{out}.{n}") for n in names]
        return cache[case]

    return get


CASES = {"site": (["-a"], ("SiteDepth.gz", "chr.stat.gz")),
         "w100": (["-w", "100"], ("win.stat.gz",)),
         "chr": ([], ("chr.stat.gz",))}


@pytest.mark.parametrize("device", ["cpu", "rows8"])
@pytest.mark.parametrize("case", list(CASES))
def test_deep_bam_matches_jax(deep, jax_deep, tmp_path, case, device):
    args, names = CASES[case]
    out = str(tmp_path / "p")
    dev = ["cpu"] * 8 if device == "rows8" else device
    assert port_main(["pandepth", "-i", deep["deep"], *args, "-o", out],
                     device=dev) == 0
    got = [gunzip_bytes(f"{out}.{n}") for n in names]
    assert got == jax_deep(case)
    if case == "site":
        # 270,000 reads at 101..120 wrap to 270,000 - 2^18 in an 18-bit
        # cell, as in the reference
        assert synth.DEEP_READS - (1 << 18) == 7856
        assert b"c1\t101\t7856\n" in got[0]

