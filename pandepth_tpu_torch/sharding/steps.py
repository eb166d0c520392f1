"""K9 on PyTorch tensors: the two programs of
``pandepth_tpu/sharding/engine.py:_sharded_steps`` — ``finalize``
(:81-99) and ``eval_only`` (:101-106), with ``local_eval`` (:73-79) —
for the rows that one device holds.

The genome axis is cut into ranges; row r holds the events inside
[bounds[r], bounds[r+1]) in a (rows, width) block whose slot 0 is
reserved for the row's carry event and whose tail is sentinel padding
with delta 0. :func:`finalize_rows` writes each row's carry
(:func:`shard_carry`), sorts every row on its own (K2's
``sort_pairs``), scans each (K2, ``sweep_scan``) and evaluates the
segments clipped to each row's range, summed over the rows
(:func:`eval_pair_rows`);
:func:`eval_pair_rows` alone is ``eval_only`` on the kept state. The
engine (:mod:`pandepth_tpu_torch.sharding.engine`) adds the rows' sums
of every device on the first one, JAX's ``psum``.

Each kernel has its plain twin here (``*_reference``): a CPU tensor runs
the twin, a CUDA tensor the kernel of ``csrc/sweep_kernels.cu`` or the
call raises. All arithmetic is integer and exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pandepth_tpu_torch.device import kernels, sweep

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _int32_wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits, as JAX's astype(int32)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def shard_carry_reference(pos2d: torch.Tensor, delta2d: torch.Tensor,
                          bounds: torch.Tensor,
                          left: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`shard_carry`, in place; returns the totals."""
    totals = delta2d[:, 1:].sum(1, dtype=torch.int64)
    carry = left.sum() + torch.cumsum(totals, 0) - totals
    delta2d[:, 0] = _int32_wrap(carry)
    pos2d[:, 0] = bounds[:pos2d.shape[0]].to(pos2d.dtype)
    return totals


def shard_carry(pos2d: torch.Tensor, delta2d: torch.Tensor,
                bounds: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """Each row's depth carried in from the ranges to its left, injected
    as its first event, in place: row r's delta total past slot 0
    (returned, int64), the exclusive prefix of the totals from the sum of
    ``left`` (the totals of the rows on earlier devices), cast to int32
    into delta slot 0, and ``bounds[r]`` (the range's start, int64) into
    position slot 0, in the block's position words."""
    if sweep._use_kernel(pos2d):
        return kernels.shard_carry(pos2d, delta2d, bounds, left)
    return shard_carry_reference(pos2d, delta2d, bounds, left)


def check_cuts(cuts):
    """``cuts`` (a host sequence of range cuts), refused unless they are
    non-decreasing: the ``eval_pair_rows`` kernel finds the rows that a
    segment crosses by searching them. Returns ``cuts``."""
    if any(a > b for a, b in zip(cuts[:-1], cuts[1:])):
        raise ValueError(f"range cuts must be non-decreasing, got "
                         f"{list(cuts)}")
    return cuts


def eval_pair_rows_reference(pos_s2: torch.Tensor, depth2: torch.Tensor,
                             c_cov2: torch.Tensor, c_sum2: torch.Tensor,
                             bounds: torch.Tensor, min_dep: int,
                             lo: torch.Tensor, hi: torch.Tensor):
    """The twin of :func:`eval_pair_rows`: K3's twin on each row, the
    segments clipped to the row's range, summed."""
    cover = torch.zeros(lo.shape[0], dtype=torch.int64, device=lo.device)
    dsum = torch.zeros_like(cover)
    for r in range(pos_s2.shape[0]):
        a, z = int(bounds[r]), int(bounds[r + 1])
        c, s = sweep.eval_pair_reference(
            pos_s2[r], depth2[r], c_cov2[r], c_sum2[r], min_dep,
            lo.clamp(a, z).to(pos_s2.dtype), hi.clamp(a, z).to(pos_s2.dtype))
        cover += c
        dsum += s
    return cover, dsum


def eval_pair_rows(pos_s2: torch.Tensor, depth2: torch.Tensor,
                   c_cov2: torch.Tensor, c_sum2: torch.Tensor,
                   bounds: torch.Tensor, min_dep: int, lo: torch.Tensor,
                   hi: torch.Tensor):
    """(cover, dsum) int64 per segment over the rows of one device, the
    rows of one (2, B) buffer: ``lo``/``hi`` (int64 global bounds)
    clipped to each row's [bounds[r], bounds[r+1]], Q(hi) - Q(lo) on that
    row's state, summed over the rows (JAX's ``local_eval`` and its
    ``psum``). ``bounds`` is non-decreasing (``check_cuts``)."""
    if sweep._use_kernel(pos_s2):
        return kernels.eval_pair_rows(pos_s2, depth2, c_cov2, c_sum2,
                                      bounds, min_dep, lo, hi)
    return torch.stack(eval_pair_rows_reference(
        pos_s2, depth2, c_cov2, c_sum2, bounds, min_dep, lo, hi))


def sort_scan_rows(pos2d: torch.Tensor, delta2d: torch.Tensor, min_dep: int,
                   wrap18: bool, pos_max: int) -> State:
    """The sweep state of every row: K2's stable sort of each row (the
    ``sort_pairs`` kernel's row form, or its twin on the CPU), then K2's
    scans row by row (``sweep_scan``, or its twin), written into one
    (rows, width) array each."""
    pos_s2, delta_s2 = sweep.sort_pairs(pos2d, delta2d, pos_max)
    depth2 = torch.empty_like(delta_s2)
    c_cov2 = torch.empty(pos_s2.shape, dtype=torch.int64,
                         device=pos_s2.device)
    c_sum2 = torch.empty_like(c_cov2)
    for r in range(pos_s2.shape[0]):
        out = (depth2[r], c_cov2[r], c_sum2[r])
        if sweep._use_kernel(pos_s2):
            kernels.sweep_scan(pos_s2[r], delta_s2[r], min_dep, wrap18,
                               pos_max, out=out)
        else:
            for o, v in zip(out, sweep.sweep_scan_reference(
                    pos_s2[r], delta_s2[r], min_dep, wrap18, pos_max)):
                o.copy_(v)
    return pos_s2, depth2, c_cov2, c_sum2


def finalize_rows(pos2d: torch.Tensor, delta2d: torch.Tensor,
                  bounds: torch.Tensor, left: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, min_dep: int, wrap18: bool,
                  pos_max: int):
    """JAX's ``finalize`` for the rows of one device, queued on one
    stream: the carry (in place into ``pos2d``/``delta2d``), the sort and
    scans, and the clipped eval of ``lo``/``hi``. ``bounds`` is the
    (rows + 1,) int64 range cuts of these rows, ``left`` the int64
    totals of the rows on earlier devices. Returns ((2, B) (cover, dsum),
    the rows' delta totals, the state (pos_s2, depth2, c_cov2, c_sum2))."""
    totals = shard_carry(pos2d, delta2d, bounds, left)
    state = sort_scan_rows(pos2d, delta2d, min_dep, wrap18, pos_max)
    return eval_pair_rows(*state, bounds, min_dep, lo, hi), totals, state
