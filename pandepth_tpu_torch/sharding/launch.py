"""Multi-process launcher: ``python -m pandepth_tpu_torch.sharding.launch``.

Takes every pandepth flag and the job's topology; start it once per
rank, one rank per device:

    python -m pandepth_tpu_torch.sharding.launch \\
        --coordinator host0:29500 --nprocs 4 --rank $RANK \\
        -i samples.list -o out

``--coordinator`` also takes an init URL (``file:///shared/store``);
without the three topology flags it reads torchrun's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``.
``--backend`` is ``nccl`` (the default on CUDA) or ``gloo`` (the default
on the CPU; on CUDA it lets several ranks share one card), ``--device``
the rank's device (default ``cuda:LOCAL_RANK``; ``cpu`` runs the plain
PyTorch twins).

The run is decided on the WHOLE input list before a rank takes its
share: the 18-bit depth wrap of a multi-file run, the contig space of
the list's first file, the targets and their read filter. Then rank i
decodes files i, i + P, ... each as the list member it is
(:func:`~pandepth_tpu_torch.sharding.distributed.process_read_shard`),
a rank with no file joins the exchange with no events, every rank
computes the same tables, and rank 0 writes them. The single-process CLI
stays ``python -m pandepth_tpu_torch.cli``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

TOPOLOGY = {"--coordinator": str, "--nprocs": int, "--rank": int,
            "--backend": str, "--device": str}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    topo = {}
    rest: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] in TOPOLOGY and i + 1 < len(argv):
            topo[argv[i]] = TOPOLOGY[argv[i]](argv[i + 1])
            i += 2
        else:
            rest.append(argv[i])
            i += 1

    from pandepth_tpu_torch.cli import parse_args

    config = parse_args(rest)   # rest[0] is the program name
    if config is None:
        return 0

    import torch.distributed as dist

    from pandepth_tpu_torch.run import run
    from pandepth_tpu_torch.sharding.distributed import (init_multihost,
                                                         process_read_shard)

    device = init_multihost(topo.get("--coordinator"), topo.get("--nprocs"),
                            topo.get("--rank"), topo.get("--backend"),
                            topo.get("--device"))
    # run.make_engine elects the multi-process engine on it, a world of
    # one included
    os.environ["PANDEPTH_MULTIHOST"] = "1"
    try:
        rc = run(config, device, share=process_read_shard(config.inputs))
        # a rank that tore its group down at once (a run refused before
        # the exchange) would cut the others off while they still join
        dist.barrier()
        return rc
    finally:
        os.environ.pop("PANDEPTH_MULTIHOST")
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
