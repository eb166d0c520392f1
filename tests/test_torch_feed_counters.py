"""The native feed's counters and the targets' and index's spans.

``feed.read`` is the share of the BAM's compressed bytes that a stream's
walk consumed (``NativeBamStream.read_share``), ``feed.kept`` the share of
its decoded records that the ``-x``/``-q`` and region filters kept
(``kept_share``), ``feed.inflate`` the seconds its threads spent
inflating BGZF blocks (``inflate_seconds``); each is read as the stream
closes. ``targets.parse``
(the GFF tokenize), ``targets.merge`` (the merge of its rows into genes)
and ``feed.index`` (the BAI's load and query) are spans. A verbose run
prints each once.
"""

import re

import numpy as np
import pytest

from tests import test_torch_ranged_walk as layout

from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.io.bamindex import load_index_for, record_starts
from pandepth_tpu_torch.io.native import NativeBamStream, load_library

N_READS = 40_000
SPANS = ("targets.parse", "targets.merge", "feed.index", "feed.read",
         "feed.kept", "feed.inflate")


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """An indexed BAM of chr1 reads whose blocks are stored, so that the
    header's read is a small part of the file, and its reads' FLAGs."""
    if load_library() is None:
        pytest.skip("libpancov_io does not build here")
    tid, pos, flag = layout._reads(N_READS)
    body, bins = layout._body(tid, pos, flag)
    n_full = len(body) // layout.FULL
    sizes = [layout.FULL] * n_full + [len(body) - n_full * layout.FULL]
    hdr, blocks = layout._layout(body, sizes, [0] * len(sizes))
    path = str(tmp_path_factory.mktemp("counters") / "s.bam")
    layout._write(path, tid, pos, flag, bins, sizes, hdr, blocks, True)
    return path, flag


def _drain(r):
    while True:
        n = r.wait()
        if n < 0:
            break
        r.take64(n)
    out = r.read_share(), r.kept_share(), r.split_share()
    r.close()
    return out


@pytest.mark.parametrize("splits", [False, True])
@pytest.mark.parametrize("flags", [1796, 0])
def test_whole_file_stream_reads_all(bam, splits, flags):
    """A whole-file stream, serial or in index-cut splits, consumes every
    compressed byte, and keeps exactly the records its FLAG mask passes."""
    path, flag = bam
    cuts = record_starts(load_index_for(path)) if splits else None
    read, kept, split = _drain(NativeBamStream(path, flags, 0, threads=3,
                                               cuts=cuts))
    assert read == 1.0
    assert kept == np.count_nonzero((flag & flags) == 0) / N_READS
    assert split == (1.0 if splits else 0.0)


def _phases(text):
    out = {}
    for line in text.splitlines():
        m = re.match(r"^INFO: phase (\S+): ([0-9.]+)s$", line)
        if m:
            out.setdefault(m.group(1), []).append(float(m.group(2)))
    return out


def _verbose_run(bam, tmp_path, capfd, args):
    capfd.readouterr()
    assert port_main(["pandepth", "-i", bam, "-o", str(tmp_path / "o"),
                      "-v", *args], device="cpu") == 0
    return _phases(capfd.readouterr().err)


def test_sparse_ranged_run(bam, tmp_path, capfd):
    """One gene near the start: the ranged stream reads the chunks of the
    16 kb index bins around it (a fifth of the file) and keeps some of the
    records it decodes; the targets' and the index's spans and both
    counters print once."""
    path, _ = bam
    gff = str(tmp_path / "g.gff3")
    with open(gff, "w") as fh:
        fh.write("chr1\tt\texon\t2000\t2300\t.\t+\t.\tID=e1;Parent=g1\n")
    got = _verbose_run(path, tmp_path, capfd, ["-g", gff, "-f", "exon"])
    for name in SPANS:
        assert len(got.get(name, [])) == 1, (name, got)
    assert 0.0 < got["feed.read"][0] < 0.5
    assert got["feed.inflate"][0] > 0.0
    assert 0.0 < got["feed.kept"][0] < 1.0
    # the phase prints to 3 decimals, the spans to 6
    assert got["targets.parse"][0] + got["targets.merge"][0] <= \
        got["targets"][0] + 0.0005


def test_whole_file_run(bam, tmp_path, capfd):
    """Chromosome mode reads the whole file and prints no targets' or
    index spans (it has neither a target file nor an index query)."""
    path, flag = bam
    got = _verbose_run(path, tmp_path, capfd, [])
    assert got["feed.read"] == [1.0]
    assert got["feed.kept"] == [
        round(np.count_nonzero((flag & 1796) == 0) / N_READS, 6)]
    for name in ("targets.parse", "targets.merge", "feed.index"):
        assert name not in got
