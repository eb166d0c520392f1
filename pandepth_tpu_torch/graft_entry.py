"""The port's twin of the repository's ``__graft_entry__.py``.

- :func:`entry` gives the fused single-device step
  (:func:`pandepth_tpu_torch.device.step.coverage_step`: the
  ``extract_events``, ``sweep_scan`` and ``eval_boundaries`` kernels on a
  card, their plain twins on the CPU) and its example arguments, the JAX
  entry's tiny problem as tensors.
- :func:`dryrun_multichip` runs the read-parallel, range-sharded step
  (:func:`pandepth_tpu_torch.sharding.mesh.sharded_coverage_step`) over
  ``n`` ranks, each a spawned process with a slice of the reads, and
  checks every rank's result against ``coverage_step`` on all of them.
  Process groups take the place of JAX's mesh.

On the CPU, and on the card::

    python -m pandepth_tpu_torch.graft_entry 2 cpu
    python -m pandepth_tpu_torch.graft_entry 2
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile
import time
from typing import Tuple

import numpy as np

from pandepth_tpu_torch.device.layout import GenomeLayout

FLAGS_MASK, MIN_MAPQ, MIN_DEP = 1796, -1, 1
#: each rank's time limit in :func:`dryrun_multichip`, its start included
RANK_SECONDS = 300


def tiny_problem(n_reads: int = 64, n_ops: int = 128, seed: int = 0):
    """``__graft_entry__._tiny_problem``'s draws as numpy: (layout, the
    read columns (tid, pos, flag, mapq, op_code, op_len, op_read), the
    segments' global (lo, hi)). Two contigs of 9000 and 5000 bp, two
    ``M`` ops a read, four segments."""
    rng = np.random.RandomState(seed)
    layout = GenomeLayout(np.array([9000, 5000], np.int64))
    tid = rng.randint(0, 2, n_reads).astype(np.int32)
    pos = rng.randint(0, 4000, n_reads).astype(np.int32)
    flag = np.where(rng.rand(n_reads) < 0.1, 1024, 0).astype(np.int32)
    mapq = rng.randint(0, 60, n_reads).astype(np.int32)
    op_read = np.repeat(np.arange(n_reads, dtype=np.int32), 2)[:n_ops]
    op_code = np.zeros(n_ops, np.int32)
    op_len = rng.randint(1, 80, n_ops).astype(np.int32)
    seg_tid = np.array([0, 0, 1, 1], np.int32)
    s1 = np.array([1, 2000, 1, 2500], np.int64)
    e1 = np.array([3000, 9000, 2500, 5000], np.int64)
    lo = layout.offsets[seg_tid] + s1 - 1
    hi = layout.offsets[seg_tid] + e1
    return layout, (tid, pos, flag, mapq, op_code, op_len, op_read), (lo, hi)


def _tensors(arrays, dev):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def entry(device=None):
    """(fn, args): ``coverage_step`` with the JAX entry's flags
    (``flags_mask=1796, min_mapq=-1, min_dep=1, wrap18=False``) and the
    tiny problem's eleven arguments on ``device`` (default ``cuda:0``);
    ``fn(*args)`` is (cover, depth_sum) of the four segments."""
    import torch

    from pandepth_tpu_torch.device.step import coverage_step

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    layout, cols, (lo, hi) = tiny_problem()
    fn = functools.partial(coverage_step, flags_mask=FLAGS_MASK,
                           min_mapq=MIN_MAPQ, min_dep=MIN_DEP, wrap18=False)
    return fn, _tensors((*cols, layout.offsets, layout.limits, lo, hi), dev)


def _rank(n: int, rank: int, backend: str, device: str, store: str,
          out: str) -> None:
    """One rank of :func:`dryrun_multichip`: its eight reads (and their
    sixteen ops, ``op_read`` rebased to the slice, as the JAX dryrun
    rebases it) through ``sharded_coverage_step``, and ``coverage_step``
    on all the reads on the same device; both written to
    ``out/rank{rank}.npz``."""
    # every rank is a process of this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    from pandepth_tpu_torch.device.step import coverage_step
    from pandepth_tpu_torch.sharding.distributed import init_multihost
    from pandepth_tpu_torch.sharding.mesh import sharded_coverage_step

    dev = init_multihost(store, n, rank, backend, device)
    try:
        layout, cols, seg = tiny_problem(n_reads=8 * n, n_ops=16 * n)
        per = cols[0].shape[0] // n
        reads = slice(rank * per, (rank + 1) * per)
        ops = slice(2 * rank * per, 2 * (rank + 1) * per)
        local = (*(c[reads] for c in cols[:4]), cols[4][ops], cols[5][ops],
                 cols[6][ops] % per)
        lay = (layout.offsets, layout.limits)
        step = sharded_coverage_step(None, FLAGS_MASK, MIN_MAPQ, MIN_DEP)
        cover, dsum = step(*_tensors((*local, *lay,
                                      layout.shard_bounds(n), *seg), dev))
        want = coverage_step(*_tensors((*cols, *lay, *seg), dev),
                             flags_mask=FLAGS_MASK, min_mapq=MIN_MAPQ,
                             min_dep=MIN_DEP)
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 cover=cover.cpu().numpy(), dsum=dsum.cpu().numpy(),
                 want_cover=want[0].cpu().numpy(),
                 want_dsum=want[1].cpu().numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _plan(n: int, device) -> Tuple[str, list]:
    """(backend, each rank's device): gloo on the CPU for ``"cpu"``; by
    default one NCCL rank a card when there are ``n`` cards, else gloo
    ranks sharing ``cuda:0`` (NCCL refuses two ranks on one card); gloo
    ranks sharing any other device given."""
    import torch

    if device is not None:
        return "gloo", [str(torch.device(device))] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' "
                           "for gloo ranks on the CPU)")
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cuda:0"] * n


def dryrun_multichip(n_devices: int, device=None,
                     seconds: float = RANK_SECONDS) -> dict:
    """Run the sharded step over ``n_devices`` ranks (spawned processes
    joined through a file store; devices as :func:`_plan` picks them) and
    check every rank's (cover, dsum) against ``coverage_step`` on all the
    reads. A rank that fails, or a job that passes ``seconds``, kills
    every rank and raises. Returns the cover, the depth sums, the backend
    and the devices."""
    import multiprocessing as mp

    backend, devs = _plan(n_devices, device)
    ctx = mp.get_context("spawn")   # CUDA does not survive a fork
    with tempfile.TemporaryDirectory(prefix="pdt-dryrun") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(n_devices, r, backend,
                                                 devs[r], store, tmp))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        t0 = time.monotonic()
        try:
            while any(p.exitcode is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode]
                if bad:
                    raise RuntimeError(
                        f"dryrun_multichip({n_devices}): rank {bad[0]} "
                        f"exited {procs[bad[0]].exitcode}")
                if time.monotonic() - t0 > seconds:
                    raise RuntimeError(f"dryrun_multichip({n_devices}): "
                                       f"passed {seconds} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank "
                               f"{bad[0]} exited {procs[bad[0]].exitcode}")
        got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(n_devices)]
    for r, g in enumerate(got):
        if not (np.array_equal(g["cover"], g["want_cover"])
                and np.array_equal(g["dsum"], g["want_dsum"])):
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): rank {r}'s (cover, dsum) "
                f"({g['cover'].tolist()}, {g['dsum'].tolist()}) differ from "
                f"coverage_step's ({g['want_cover'].tolist()}, "
                f"{g['want_dsum'].tolist()})")
    print(f"dryrun_multichip({n_devices}): OK ({backend} ranks on "
          f"{', '.join(devs)}, cover={got[0]['cover'].tolist()})")
    return {"cover": got[0]["cover"], "dsum": got[0]["dsum"],
            "backend": backend, "devices": devs}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    where = sys.argv[2] if len(sys.argv) > 2 else None
    dryrun_multichip(n, where)
    fn, args = entry(where)
    print("entry():", [tuple(x.shape) for x in fn(*args)])
