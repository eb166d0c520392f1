"""MultihostCoverageEngine on PyTorch: the port of
``pandepth_tpu/sharding/multihost.py``.

Every process of a ``torch.distributed`` job is one rank on one device,
decodes its own share of the input files into this engine, and owns one
row of the genome axis: the range [bounds[rank], bounds[rank + 1]) of
``layout.shard_bounds(world)``. The feeds accumulate on the host as in
:class:`~pandepth_tpu_torch.sharding.engine.ShardedCoverageEngine`; the
first ``segment_stats`` after a feed runs :meth:`exchange` (the local
events to the device in one copy, K10's bucketing and the exact-split
``all_to_all_single``, :mod:`.mesh`), then K9's finalize on the rank's
row, and an ``all_reduce`` of (cover, dsum); later chunks and calls
evaluate the kept row and reduce again. Every rank gets the same tables;
the run writes them on rank 0 (``run.finalize_and_write``).

Multi-sample depth is additive, so it does not matter which rank decoded
which file. JAX's ``_row_cap``, its ``pmax`` and its capacity-doubling
loops exist only because XLA needs static shapes: the exchange here
sends exactly what each rank holds. ``write_site_depth`` (``-a``) is not
ported (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pandepth_tpu_torch.device.hosteval import SegmentStats
from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32
from pandepth_tpu_torch.device.layout import GenomeLayout
from pandepth_tpu_torch.sharding import mesh, steps
from pandepth_tpu_torch.sharding.distributed import agree
from pandepth_tpu_torch.sharding.engine import ShardedCoverageEngine, _Block


class MultihostCoverageEngine(ShardedCoverageEngine):
    """ShardedCoverageEngine over the ranks of ``group`` (the default
    process group unless given): one row, this rank's, on ``device``."""

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False, *, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("MultihostCoverageEngine: no process group; "
                               "start the run through "
                               "pandepth_tpu_torch.sharding.launch")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        super().__init__(layout, flags_mask=flags_mask, min_mapq=min_mapq,
                         min_dep=min_dep, wrap18=wrap18,
                         devices=[device] * self.world)
        self.device = self.devices[0]
        self._blocks = [_Block(self.device, self.rank, 1, self.bounds)]
        self._cuts = torch.from_numpy(self.bounds).to(self.device)
        self.tier = {np.int32: TIER_I32, np.uint32: TIER_U32,
                     np.int64: TIER_I64}[self.pos_dtype]
        self._row: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._left: Optional[torch.Tensor] = None
        #: exchanges run (one per feed)
        self.n_exchanges = 0

    def _signature(self) -> dict:
        """What every rank must share with rank 0 before an exchange."""
        lay = self.layout
        return {"world": self.world, "total": lay.total,
                "n_targets": lay.n_targets,
                "lengths_crc": zlib.crc32(lay.lengths.tobytes()),
                "bounds_crc": zlib.crc32(self.bounds.tobytes()),
                "flags_mask": self.flags_mask, "min_mapq": self.min_mapq,
                "min_dep": self.min_dep, "wrap18": int(self.wrap18)}

    def _upload(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's events on its device in one copy each, positions in
        the tier's words (the uint32 tier as its 32-bit patterns)."""
        if self._chunks:
            pos = np.concatenate([c[0] for c in self._chunks])
            delta = np.concatenate([c[1] for c in self._chunks])
        else:
            pos = np.zeros(0, self.pos_dtype)
            delta = np.zeros(0, np.int32)
        if self.pos_dtype is np.uint32:
            pos = pos.view(np.int32)
        return (torch.from_numpy(pos).to(self.device),
                torch.from_numpy(delta).to(self.device))

    def exchange(self) -> None:
        """Send this rank's events to the ranks owning their ranges and
        keep what this rank receives as its row; a collective, which every
        rank calls once per feed (``segment_stats`` calls it when the feed
        changed on any rank)."""
        agree(self.group, self.device, self._signature())
        pos, delta = self._upload()
        ex = mesh.bucket_exchange(pos, delta, self._cuts, self.tier,
                                  self.group)
        self._row = mesh.row_block(ex, self.tier, self.pos_sentinel)
        self._left = ex.range_sums[:self.rank]
        self.n_exchanges += 1
        self._finalized = False

    def _finalize(self, lo: np.ndarray, hi: np.ndarray):
        """K9's finalize on this rank's row, exchanged first unless
        :meth:`exchange` ran for this feed. Returns [(cover, dsum)]."""
        if self._row is None:
            self.exchange()
        blk = self._blocks[0]
        p2, d2 = self._row
        self._row = None
        both, _, blk.state = steps.finalize_rows(
            p2, d2, blk.bounds, self._left, *self._queries(lo, hi, blk),
            self.min_dep, self.wrap18, self.pos_sentinel)
        self._finalized = True
        return [both]

    def _psum(self, outs) -> Tuple[np.ndarray, np.ndarray]:
        """(cover, dsum) summed over the ranks, brought to the host."""
        both = outs[0]
        dist.all_reduce(both, group=self.group)
        both = both.cpu().numpy()
        return both[0], both[1]

    def _push(self, pos: np.ndarray, delta: np.ndarray) -> None:
        super()._push(pos, delta)
        self._row = None

    def segment_stats(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                      seg_end: np.ndarray,
                      chunk: int = 1 << 20) -> SegmentStats:
        """Stats for 1-based inclusive [seg_start, seg_end] segments; a
        collective. A feed on any rank since the last finalize makes every
        rank exchange and finalize again."""
        stale = torch.tensor([int(not self._finalized)], device=self.device)
        dist.all_reduce(stale, op=dist.ReduceOp.MAX, group=self.group)
        self._finalized = not bool(stale.item())
        return super().segment_stats(seg_tid, seg_start, seg_end, chunk)
