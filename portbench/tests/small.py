"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test can run, and
the program runners that the harness's tests put in the program's place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

from portbench import spec

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port on the CPU, through its own launcher
CPU_ENV = {"PANDEPTH_FORCE_PLATFORM": "cpu"}


def small_cell(root: str, config: str = "capsicum_chr",
               reads: int = 30_000) -> spec.Cell:
    """The cell ``chr_skim8m_warm`` with the configuration
    ``portbench/configs/<config>.json`` (``capsicum_exon``, whose cell is
    left out of BENCHMARK.json, too), cut to 3 contigs of 400 kb,
    ``reads`` reads a sample over the first 100 kb of each and (with an
    annotation) 60 genes of 300 exons."""
    cell = spec.load_cell(root, "chr_skim8m_warm")
    with open(os.path.join(spec.HERE, "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    cfg["genome"].update(contigs=3, contig_length=400_000)
    cfg["reads_per_sample"] = reads
    cfg["covered_bases_per_contig"] = 100_000
    if "annotation" in cfg:
        cfg["annotation"].update(genes=60, exons=300)
    text = json.dumps(cfg)
    return dataclasses.replace(cell, config_name=config, config=cfg,
                               config_text=text)


def faulty(fault: str):
    """The program with ``fault`` planted where it makes its answer (see
    faulty_program.py)."""
    return [sys.executable, os.path.join(HERE, "faulty_program.py"), fault]
