"""The inputs of a (configuration, seed), and the reference's table for
them, made once and kept under ``portbench/cache/`` inside the checkout.

A directory a configuration and seed: ``<config>-<hash of its file>/<seed>/``
holds ``sample.bam`` and its ``.bai``, ``genes.gff3`` where the
configuration has an annotation, and ``reference.<table>.txt`` once a run
has judged on it. It is made under a temporary name and renamed, so a
run that is killed leaves no torn input. The newest ``KEEP``
directories of a configuration are kept.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import time
from typing import Optional

from portbench.inputs import synth
from portbench.reference import pandepth

KEEP = 12


@dataclasses.dataclass
class Inputs:
    dir: str
    bam: str
    gff: Optional[str]
    seconds: float   # spent making them in this run (0 when cached)


def _key(cfg_name: str, cfg_text: str) -> str:
    return f"{cfg_name}-{hashlib.sha256(cfg_text.encode()).hexdigest()[:12]}"


def ensure(cache: str, cfg_name: str, cfg_text: str, cfg: dict,
           seed: int) -> Inputs:
    top = os.path.join(cache, _key(cfg_name, cfg_text))
    d = os.path.join(top, str(seed))
    gff = os.path.join(d, "genes.gff3") if "annotation" in cfg else None
    done = os.path.join(d, "done")
    t0 = time.perf_counter()
    if os.path.exists(done):
        os.utime(done)
        return Inputs(d, os.path.join(d, "sample.bam"), gff, 0.0)
    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(tmp)
    synth.write_bam(os.path.join(tmp, "sample.bam"), cfg,
                    synth.make_reads(cfg, seed))
    if gff is not None:
        synth.write_gff3(os.path.join(tmp, "genes.gff3"), cfg,
                         synth.make_annotation(cfg, seed))
    open(os.path.join(tmp, "done"), "w").close()
    os.replace(tmp, d)
    _prune(top)
    return Inputs(d, os.path.join(d, "sample.bam"), gff,
                  time.perf_counter() - t0)


def _prune(top: str) -> None:
    kept = []
    for name in os.listdir(top):
        done = os.path.join(top, name, "done")
        if os.path.exists(done):
            kept.append((os.path.getmtime(done), name))
    for _, name in sorted(kept, reverse=True)[KEEP:]:
        shutil.rmtree(os.path.join(top, name), ignore_errors=True)


def reference_text(cfg: dict, seed: int, inputs: Inputs,
                   exclude: Optional[int] = None) -> str:
    """The table the program must write for these inputs, by the plain
    reference; with ``exclude`` the FLAG mask that the reference applies
    instead of the configuration's (a control)."""
    p = cfg["pandepth"]
    contigs = synth.genome(cfg)
    names = [nm for nm, _ in contigs]
    reads = synth.make_reads(cfg, seed)
    depth = pandepth.Depth([ln for _, ln in contigs], reads.tid, reads.pos,
                           reads.flag, reads.mapq, reads.cigars,
                           p["exclude_flags"] if exclude is None
                           else exclude, p["min_mapq"], p["min_depth"],
                           kind=reads.kind)
    if p["table"] == "chr":
        return pandepth.chr_table(names, depth)
    with open(inputs.gff) as fh:
        text = fh.read()
    return pandepth.gene_table(names, depth, text, p["feature"])


def reference(cfg: dict, seed: int, inputs: Inputs) -> bytes:
    """:func:`reference_text`, kept beside the inputs once made."""
    path = os.path.join(inputs.dir, f"reference.{cfg['pandepth']['table']}"
                                    ".txt")
    if os.path.exists(path):
        with open(path, "rb") as fh:
            return fh.read()
    data = reference_text(cfg, seed, inputs).encode()
    with open(path + ".tmp", "wb") as fh:
        fh.write(data)
    os.replace(path + ".tmp", path)
    return data
