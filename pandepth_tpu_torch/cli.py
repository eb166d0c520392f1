"""pandepth-compatible command line for the PyTorch port.

``parse_args`` is the port's copy of ``pandepth_tpu.cli.parse_args``:
it replicates the reference's hand-rolled argv loop (bamCov_help01,
src/PanDepth.cpp:84-293) — same flags, same ``.list`` expansion, same
GFF-vs-GTF and BED column autodetection, same hidden ``-s`` flag; the
reference strips *all* dashes from an option token (``replace_all``),
so ``--i`` == ``-i``. The run is ``pandepth_tpu_torch.run.run`` on the
devices of :func:`resolve_devices`, which
:func:`pandepth_tpu_torch.boot.start_up` decides once the run has started
its feed. Usage::

    python -m pandepth_tpu_torch.cli -i x.bam -o out
"""

from __future__ import annotations

import sys
from typing import List, Optional

from pandepth_tpu_torch import __version__
from pandepth_tpu_torch.config import MODE_BED3, RunConfig
from pandepth_tpu_torch.io.text import read_list
from pandepth_tpu_torch.targets.parse import (detect_bed_mode,
                                              detect_gff_mode)

HELP = """\
Usage: pandepth -i in.bam [-g gene.gff | -b region.bed] -o outPrefix
 Input/Output options:
   -i    <str>     input of sam/bam/cram/paf or #.list file
   -o    <str>     prefix of output file
 Target options:
   -g    <str>     input gff/gtf file for gene region
   -f    <str>     gff/gtf feature type to parse, CDS or exon [CDS]
   -b    <str>     input bed file for list of regions
   -w    <int>     windows size (bp)
   -a              output all the site depth
 Filter options:
   -q    <int>     min mapping quality [0]
   -d    <int>     min site depth for statistics [1]
   -x    <int>     exclude reads with any of the bits in FLAG set [1796]
 Other options:
   -t    <int>     number of threads [3]
   -r    <str>     reference genome file for cram decode or GC parse
   -c              enable the calculation of GC content (requires -r)
   -h              show this help [{version}]
"""


def _help() -> None:
    print(HELP.format(version=__version__))


def parse_args(argv: List[str]) -> Optional[RunConfig]:
    """Return a RunConfig, or None when the run should not proceed
    (help shown / argument error, matching the reference's 0 return)."""
    if len(argv) <= 1:
        _help()
        return None
    cfg = RunConfig()
    bed_files: List[str] = []
    i = 1
    n = len(argv)

    def lack(flag: str) -> None:
        print(f"Error: Lack argument for the option -{flag}",
              file=sys.stderr)

    while i < n:
        tok = argv[i]
        if not tok.startswith("-"):
            print("Error: Command option error! Please check the provided "
                  "options.", file=sys.stderr)
            return None
        flag = tok.replace("-", "")
        needs_arg = flag in ("i", "o", "r", "f", "x", "g", "b", "t", "w",
                             "q", "d")
        if needs_arg:
            if i + 1 == n:
                lack(flag)
                return None
            i += 1
            arg = argv[i]

        if flag == "i":
            ext = arg.rsplit(".", 1)[-1] if "." in arg else ""
            if ext in ("list", "List"):
                cfg.inputs.extend(read_list(arg))
            else:
                cfg.inputs.append(arg)
        elif flag == "o":
            cfg.out_prefix = arg
        elif flag == "c":
            cfg.gc = True
        elif flag == "a":
            cfg.site_output = True
        elif flag == "r":
            cfg.reference = arg
        elif flag == "f":
            cfg.feature_type = arg
        elif flag == "x":
            cfg.flags = int(arg)
        elif flag == "g":
            cfg.target_file = arg
            mode = detect_gff_mode(arg)
            if mode == 0:
                print("Error: The format of the input GFF/GTF file is "
                      f"incorrect. Please check the file format: {arg}",
                      file=sys.stderr)
                return None
            cfg.mode = mode
        elif flag == "b":
            bed_files.append(arg)
            cfg.mode = MODE_BED3
        elif flag == "t":
            cfg.threads = int(arg)
        elif flag == "w":
            cfg.win_size = int(arg)
            if cfg.win_size < 1:
                print("Warning: -w should >= 1, set to 1", file=sys.stderr)
                cfg.win_size = 1
        elif flag == "q":
            cfg.min_mapq = int(arg)
        elif flag == "s":
            cfg.use_index = False
        elif flag in ("v", "verbose"):
            cfg.verbose = True  # extension: phase timing to stderr
        elif flag == "d":
            cfg.min_depth = int(arg)
            if cfg.min_depth < 1:
                cfg.min_depth = 1
        elif flag in ("help", "h"):
            _help()
            return None
        else:
            print(f"Error UnKnow argument -{flag}", file=sys.stderr)
            return None
        i += 1

    if not cfg.inputs or not cfg.out_prefix:
        print("Error: lack argument -i or -o ", file=sys.stderr)
        return None

    # -b resolution happens after the loop (src/PanDepth.cpp:264-291):
    # only when no -g was given does the first bed file become the target
    if bed_files and not cfg.target_file:
        cfg.target_file = bed_files[0]
        cfg.mode = detect_bed_mode(bed_files[0])
    return cfg


def resolve_devices(device=None) -> list:
    """The devices a run uses. ``None`` means every visible CUDA device
    (``cuda:0`` .. ``cuda:n-1``), of which there must be one: there is no
    CPU fallback; or, when the caller's environment asks for it with
    ``PANDEPTH_FORCE_PLATFORM=cpu`` (the JAX package's switch), the CPU.
    Otherwise one device or a sequence of them (repeats allowed: the
    sharded engine puts one row on each entry); pass ``"cpu"`` explicitly
    to run the plain PyTorch twins."""
    import os

    import torch

    from pandepth_tpu_torch.run import devices_of

    if device is None and os.environ.get("PANDEPTH_FORCE_PLATFORM") == "cpu":
        return [torch.device("cpu")]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; "
                               "pandepth_tpu_torch runs on an NVIDIA GPU "
                               "(pass device='cpu' to run its plain "
                               "PyTorch twins)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = devices_of(device)
    for dev in devs:
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"pandepth_tpu_torch runs on cuda or cpu, "
                               f"not {dev}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; "
                               "pandepth_tpu_torch runs on an NVIDIA GPU "
                               "(pass device='cpu' to run its plain "
                               "PyTorch twins)")
    return devs


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Parse ``argv`` and run on ``device`` (see :func:`resolve_devices`;
    more than one device elects the sharded engine). With
    ``device=None`` the run decides the devices when it makes its engine
    (:func:`pandepth_tpu_torch.boot.start_up`, which also starts torch,
    the CUDA context and the kernel library while a thread stashes the
    first file's encoded windows); an explicit ``device`` is checked here
    first."""
    cfg = parse_args(argv if argv is not None else sys.argv)
    if cfg is None:
        return 0
    if device is not None:
        try:
            device = resolve_devices(device)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    from pandepth_tpu_torch.boot import InitError
    from pandepth_tpu_torch.run import run

    try:
        return run(cfg, device)
    except InitError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"Error: Failed to open the file: {e.filename or e}",
              file=sys.stderr)
        return 1
    except Exception as e:  # malformed inputs: clean error, no traceback
        import struct
        import zlib

        if isinstance(e, (ValueError, struct.error, zlib.error,
                          EOFError, IndexError, KeyError)):
            print(f"Error: malformed input: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
