"""Joining a multi-process job: the port of
``pandepth_tpu/sharding/distributed.py`` onto ``torch.distributed``.

One process per rank and one rank per device. Every rank decodes its own
share of the input files (:func:`process_read_shard`), the events cross
to the rank that owns their genome range (:mod:`.mesh`), and every rank
ends with the same tables; rank 0 writes them. Typical use, one process
per card on each host:

    from pandepth_tpu_torch.sharding.distributed import init_multihost
    device = init_multihost("host0:29500", num_processes=8,
                            process_id=RANK)

With no arguments it reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). The
backend is NCCL on CUDA devices and gloo on the CPU; gloo on CUDA devices
is taken only when asked for (several ranks on one card, which NCCL
refuses). An initialization that fails raises: the backend is never
switched behind the caller's back.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device=None) -> torch.device:
    """Join the job's default process group; returns this rank's device.

    ``coordinator`` is ``host:port`` (rank 0 listens there) or an init
    URL (``tcp://...``, ``file:///...``); without it ``MASTER_ADDR`` and
    ``MASTER_PORT`` are read. ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. The device is ``device`` when
    given, else ``cuda:LOCAL_RANK`` (or ``cuda:rank % device_count``);
    with no CUDA device it must be ``"cpu"``. ``backend`` defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU."""
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator: pass host:port, or set "
                             "MASTER_ADDR and MASTER_PORT")
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    world = num_processes if num_processes is not None else \
        _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = _rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev   # NCCL starts now: a failure raises here
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    return dev


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it explicitly")
    return int(os.environ[name])


def _rank_device(device, rank: int) -> torch.device:
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{dev}: no CUDA device is available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"pandepth_tpu_torch runs on cuda or cpu, not "
                             f"{dev}")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch twins")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def process_read_shard(paths: Sequence[str],
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None
                       ) -> List[Tuple[int, str]]:
    """This rank's share of the input files, as (index in the whole
    list, path): rank i takes files i, i + P, i + 2P, ... (multi-sample
    depth is additive, so any partition works). A rank may get none."""
    pi = dist.get_rank() if process_index is None else process_index
    pc = dist.get_world_size() if process_count is None else process_count
    return [(k, p) for k, p in enumerate(paths) if k % pc == pi]


def worst_exit(rc: int, device: torch.device, group=None) -> int:
    """The largest of the ranks' exit codes ``rc`` (0 when every rank
    succeeded): one ``all_reduce(MAX)`` on ``device``, which every rank
    calls, whatever its own outcome, so that a rank-local failure ends the
    whole job together instead of leaving the others in a collective."""
    flag = torch.tensor([int(rc)], dtype=torch.int64, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return int(flag.item())


def agree(group, device: torch.device, fields: Dict[str, int]) -> None:
    """Raise on every rank unless every rank passes the same ``fields``
    (the world size, the layout, the range cuts, the run's decisions) as
    rank 0: a rank that disagrees would exchange events into the wrong
    ranges. One ``all_gather`` of the values, on ``device`` (gloo takes
    CUDA tensors too)."""
    names = list(fields)
    mine = torch.tensor([int(fields[k]) for k in names], dtype=torch.int64,
                        device=device)
    every = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    every = torch.stack(every).cpu()
    bad = [(r, k) for r in range(every.shape[0])
           for i, k in enumerate(names) if every[r, i] != every[0, i]]
    if bad:
        raise RuntimeError("ranks disagree with rank 0 on " + ", ".join(
            f"{k} (rank {r})" for r, k in bad))
