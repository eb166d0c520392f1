"""K10 on PyTorch: the port of ``pandepth_tpu/sharding/mesh.py``, the
range-bucketed event exchange between the ranks of a
``torch.distributed`` job.

Rank r of a world of n owns the genome range
[bounds[r], bounds[r + 1]) of ``layout.shard_bounds(n)`` and holds it as
one row laid out as K9's (:mod:`.steps`). Each rank's local events go
through three steps:

1. :func:`bucket_events`: a stable counting sort of the live events
   (delta != 0) by destination range, with each range's count and delta
   sum (the ``bucket_events`` kernel of ``csrc/sweep_kernels.cu`` on a
   CUDA tensor, :func:`bucket_events_reference` on a CPU tensor);
2. :func:`bucket_exchange`: ``all_to_all_single`` of the counts gives
   the receive splits, then ``all_to_all_single`` of the positions and
   of the deltas with exactly those splits, and ``all_reduce`` of the
   sums gives every range's delta total. The received events come in
   source-rank order, each source's in its stable destination order:
   JAX's received rows with their padding removed. There is no capacity
   guess and no overflow retry;
3. :func:`exchange_sorted`: K9 on the one row (the carry of the ranges
   to the left, the stable library sort, K2), then :func:`state_eval`:
   K9's clipped eval and an ``all_reduce`` of (cover, dsum), JAX's
   ``psum``.

:func:`sharded_coverage_step` composes K6 ``extract_events`` on each
rank's local read shard with the three. There is no ``make_mesh``: the
JAX step flattens its mesh into one axis, which is the group's ranks
here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from pandepth_tpu_torch.device import events, kernels, sweep
from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32
from pandepth_tpu_torch.sharding import steps
from pandepth_tpu_torch.sharding.distributed import agree


def bucket_events_reference(pos: torch.Tensor, delta: torch.Tensor,
                            bounds: torch.Tensor, tier: int):
    """The twin of :func:`bucket_events`: ``searchsorted`` of the inner
    cuts, a stable sort of the destinations, gathers, ``bincount`` and
    ``index_add_``. Returns the same four tensors, its buffers filled
    past sum(counts) with the dead events."""
    world = bounds.shape[0] - 1
    key = pos.to(torch.int64)
    if tier == TIER_U32:
        key &= 0xFFFFFFFF
    dest = torch.searchsorted(bounds[1:-1].contiguous(), key, right=True)
    dest = torch.where(delta != 0, dest.clamp_(max=world - 1), world)
    order = torch.sort(dest, stable=True)[1]
    counts = torch.bincount(dest, minlength=world + 1)[:world]
    sums = torch.zeros(world + 1, dtype=torch.int64, device=pos.device)
    sums.index_add_(0, dest, delta.to(torch.int64))
    return pos[order], delta[order], counts.to(torch.int32), sums[:world]


def bucket_events(pos: torch.Tensor, delta: torch.Tensor,
                  bounds: torch.Tensor, tier: int):
    """(out_pos, out_delta, counts, sums): the live events ordered by
    destination range [bounds[r], bounds[r + 1]) (positions at or past
    the last cut in the last range), stable, in the first sum(counts)
    slots of buffers of the input's length; each range's live count
    (int32) and delta sum (int64). ``pos`` holds the tier's words (the
    uint32 tier's as int32 bit patterns, compared unsigned)."""
    if sweep._use_kernel(pos):
        return kernels.bucket_events(pos, delta, bounds, tier)
    return bucket_events_reference(pos, delta, bounds, tier)


class Exchanged(NamedTuple):
    """What :func:`bucket_exchange` leaves on a rank: the events of its
    range in the tier's words, in source-rank order, (world,) int64
    delta totals of every range, and the bytes the rank sent and
    received through the collectives."""
    pos: torch.Tensor
    delta: torch.Tensor
    range_sums: torch.Tensor
    nbytes: int


def bucket_exchange(pos: torch.Tensor, delta: torch.Tensor,
                    bounds: torch.Tensor, tier: int, group=None
                    ) -> Exchanged:
    """Bucket this rank's events by range and send each bucket to the
    rank owning it (``bounds``: the (world + 1,) int64 cuts on the
    rank's device, the same on every rank). One host sync: the counts
    this rank sends and receives, ``world`` integers each."""
    world = dist.get_world_size(group)
    if bounds.shape[0] != world + 1:
        raise ValueError(f"bucket_exchange: {bounds.shape[0]} cuts for a "
                         f"world of {world}")
    out_pos, out_delta, counts, sums = bucket_events(pos, delta, bounds,
                                                     tier)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=group)
    dist.all_reduce(sums, group=group)
    splits = torch.stack([counts, recv_counts]).cpu().tolist()
    send, recv = splits
    n_send, n_recv = sum(send), sum(recv)
    got_pos = out_pos.new_empty(n_recv)
    got_delta = out_delta.new_empty(n_recv)
    for out, into in ((got_pos, out_pos), (got_delta, out_delta)):
        dist.all_to_all_single(out, into[:n_send], output_split_sizes=recv,
                               input_split_sizes=send, group=group)
    word = pos.element_size() + 4
    nbytes = 2 * 4 * world + word * (n_send + n_recv) + 2 * 8 * world
    return Exchanged(got_pos, got_delta, sums, nbytes)


def row_block(ex: Exchanged, tier: int, pos_max: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The received events as K9's one-row block: slot 0 free for the
    carry, then the events in their received order, widened to int64 in
    the uint32 tier, and one sentinel slot (``pos_max``, delta 0) when
    nothing came."""
    n = ex.pos.shape[0]
    dtype = torch.int32 if tier == TIER_I32 else torch.int64
    p2 = torch.full((1, 1 + max(n, 1)), pos_max, dtype=dtype,
                    device=ex.pos.device)
    d2 = torch.zeros(p2.shape, dtype=torch.int32, device=ex.pos.device)
    p2[0, 1:1 + n] = ex.pos.to(torch.int64) & 0xFFFFFFFF \
        if tier == TIER_U32 else ex.pos
    d2[0, 1:1 + n] = ex.delta
    return p2, d2


def exchange_sorted(pos: torch.Tensor, delta: torch.Tensor,
                    bounds: torch.Tensor, tier: int, min_dep: int,
                    wrap18: bool, pos_max: int, group=None):
    """JAX's ``_exchange_sorted``: the exchange, then this rank's row
    through K9's carry (the delta totals of the ranges left of it), the
    stable sort and K2. Returns (state, the row's (2,) bounds, the
    exchange)."""
    ex = bucket_exchange(pos, delta, bounds, tier, group)
    rank = dist.get_rank(group)
    p2, d2 = row_block(ex, tier, pos_max)
    row_bounds = bounds[rank:rank + 2]
    steps.shard_carry(p2, d2, row_bounds, ex.range_sums[:rank])
    state = steps.sort_scan_rows(p2, d2, min_dep, wrap18, pos_max)
    return state, row_bounds, ex


def state_eval(state: steps.State, row_bounds: torch.Tensor, min_dep: int,
               seg_lo: torch.Tensor, seg_hi: torch.Tensor, group=None):
    """JAX's ``_state_eval``: (cover, dsum) of the int64 segments clipped
    to this rank's range, summed over the ranks (``all_reduce``)."""
    both = steps.eval_pair_rows(*state, row_bounds, min_dep, seg_lo, seg_hi)
    dist.all_reduce(both, group=group)
    return both[0], both[1]


def sharded_coverage_step(group, flags_mask: int, min_mapq: int,
                          min_dep: int, wrap18: bool = False):
    """A coverage step over the ranks of ``group``. The returned
    function takes this rank's local shard and the replicated rest, all
    on the rank's device:

      tid/pos/flag/mapq: (N,) int32, the rank's reads
      op_code/op_len/op_read: (M,) int32, their CIGAR stream, op_read
        indexing the local reads
      offsets/limits: (n_targets,) int64, the genome layout
      bounds: (world + 1,) int64, the range cuts
      seg_lo/seg_hi: (B,) int64, the segments

    and returns the (B,) int64 (cover, depth_sum) of every rank's reads,
    the same on every rank."""
    pos_max = torch.iinfo(torch.int64).max

    def run(tid, pos, flag, mapq, opc, opl, opr, offsets, limits, bounds,
            seg_lo, seg_hi):
        cuts = steps.check_cuts(bounds.tolist())
        agree(group, bounds.device, {
            "world": dist.get_world_size(group), "n_targets": offsets.shape[0],
            **{f"bound{i}": int(b) for i, b in enumerate(cuts)}})
        ev_pos, ev_delta = events.extract_events(
            tid, pos, flag, mapq, opc, opl, opr, offsets, limits,
            flags_mask=flags_mask, min_mapq=min_mapq)
        state, row_bounds, _ = exchange_sorted(
            ev_pos, ev_delta, bounds, TIER_I64, min_dep, wrap18, pos_max,
            group)
        return state_eval(state, row_bounds, min_dep, seg_lo, seg_hi, group)

    return run
