"""ShardedCoverageEngine on PyTorch: the port of
``pandepth_tpu/sharding/engine.py:ShardedCoverageEngine`` (K9).

The flattened genome axis is cut into contiguous ranges, one row per
entry of ``devices``; an entry may repeat, which puts several rows on
one device (the CPU tests use ``["cpu"] * 8`` where JAX uses its 8
virtual CPU devices):

- the feeds stay on the host as numpy chunks; at the finalize the host
  buckets every event by the range owning its position
  (:meth:`_bucketed`, one ``searchsorted`` and a stable argsort), and
  each device gets its rows in one copy;
- each row carries the depth from the ranges to its left as one event
  at the range's start (the ``shard_carry`` kernel); each device learns
  the delta totals of the rows on earlier devices by one copy of them
  (JAX's ``all_gather`` of one scalar per device);
- each row is sorted and scanned as the single-device sweep is, and each
  segment is evaluated clipped to each row's range, summed over the rows
  (the ``eval_pair_rows`` kernel); every device's sums are added on the
  first (JAX's ``psum``).

``segment_stats`` finalizes on its first chunk of segments and keeps
the per-row state for later chunks and calls, which run the clipped
eval alone. Rows that are neighbours in ``devices`` and share a device
form one block there; the blocks are finalized in order.

Not ported: ``dense_depth`` and its merged host state, which serve only
``-a`` and ``-w`` below 150 (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pandepth_tpu_torch.device.hosteval import (SENTINEL, SegmentStats,
                                                host_extract_events,
                                                pad_pow2, pos_dtype_for)
from pandepth_tpu_torch.device.layout import GenomeLayout
from pandepth_tpu_torch.sharding import steps


class _Block:
    """The rows [r0, r0 + rows) of the engine, on one device: their range
    cuts (rows + 1,) int64 there, and once finalized their state."""

    def __init__(self, device: torch.device, r0: int, rows: int,
                 bounds: np.ndarray):
        self.device, self.r0, self.rows = device, r0, rows
        self.bounds = torch.from_numpy(
            np.ascontiguousarray(bounds[r0:r0 + rows + 1])).to(device)
        self.state: Optional[steps.State] = None


class ShardedCoverageEngine:
    """CoverageEngine-compatible engine sharding the genome axis over the
    rows of ``devices`` (events accumulate on the host and are bucketed
    by range at finalize time)."""

    # host bucketing filters sentinels anyway: unpadded feeds are best
    wants_padded_events = False

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False, *, devices: Sequence):
        self.layout = layout
        self.flags_mask = int(flags_mask)
        self.min_mapq = int(min_mapq)
        self.min_dep = max(int(min_dep), 1)
        self.wrap18 = bool(wrap18)
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedCoverageEngine: no device given")
        self.n_dev = len(self.devices)
        self.bounds = steps.check_cuts(layout.shard_bounds(self.n_dev))
        self.pos_dtype = pos_dtype_for(layout.total)
        self.pos_sentinel = int(np.iinfo(self.pos_dtype).max)
        self._blocks: List[_Block] = []
        r0 = 0
        for dev, run in itertools.groupby(self.devices):
            rows = len(list(run))
            self._blocks.append(_Block(dev, r0, rows, self.bounds))
            r0 += rows
        self._chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self._finalized = False
        self.n_reads_seen = 0

    @property
    def pos_bits32(self) -> bool:
        return self.pos_dtype is not np.int64

    @property
    def pos_sentinel32(self) -> int:
        return int(np.array(self.pos_sentinel,
                            np.uint64).astype(np.uint32).view(np.int32))

    # ----------------------------------------------------------- feeds
    def _push(self, pos: np.ndarray, delta: np.ndarray) -> None:
        self._chunks.append((pos, delta))
        self._finalized = False

    def add_start_end(self, starts: np.ndarray,
                      ends: np.ndarray) -> None:
        if starts.shape[0] == 0:
            return
        pos = np.concatenate([starts, ends])
        delta = np.concatenate([np.ones(starts.shape[0], np.int32),
                                np.full(ends.shape[0], -1, np.int32)])
        live = pos < self.pos_sentinel
        self._push(pos[live].astype(self.pos_dtype, copy=False),
                   delta[live])

    def add_padded_events(self, starts: np.ndarray,
                          ends: np.ndarray) -> None:
        self.add_start_end(starts, ends)

    def add_intervals(self, tid: np.ndarray, start0: np.ndarray,
                      end0: np.ndarray) -> None:
        if tid.shape[0] == 0:
            return
        lay = self.layout
        floor = lay.offsets[tid]
        limit = lay.limits[tid]
        s = np.clip(floor + start0, floor, limit)
        e = np.clip(floor + end0, floor, limit)
        live = e > s
        self.add_start_end(s[live], e[live])

    def add_events(self, pos: np.ndarray, delta: np.ndarray) -> None:
        live = (pos < SENTINEL) & (delta != 0)
        if not live.any():
            return
        self._push(pos[live].astype(self.pos_dtype, copy=False),
                   delta[live].astype(np.int32, copy=False))

    def add_batch(self, batch) -> None:
        """A columnar read batch (any object with ``ReadBatch``'s fields),
        extracted on the host."""
        if batch.n_reads == 0:
            return
        self.n_reads_seen += batch.n_reads
        s, e = host_extract_events(batch, self.layout.offsets,
                                   self.layout.limits, self.flags_mask,
                                   self.min_mapq)
        self.add_start_end(s, e)

    # -------------------------------------------------------- finalize
    def _bucketed(self) -> Tuple[np.ndarray, np.ndarray]:
        """(n_dev, 1 + cap) position/delta rows: row d holds exactly the
        events inside [bounds[d], bounds[d+1]) (events at the global end
        land in the last range) from slot 1, sentinel-padded with delta
        0; slot 0 is the carry's, written on the device."""
        n_dev = self.n_dev
        if self._chunks:
            pos = np.concatenate([c[0] for c in self._chunks])
            delta = np.concatenate([c[1] for c in self._chunks])
        else:
            pos = np.zeros(0, self.pos_dtype)
            delta = np.zeros(0, np.int32)
        dest = np.searchsorted(self.bounds[1:-1], pos,
                               side="right").astype(np.int32)
        np.minimum(dest, n_dev - 1, out=dest)
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=n_dev)
        cap = pad_pow2(int(counts.max()) if counts.size else 1,
                       floor=256)
        pos2d = np.full((n_dev, 1 + cap), self.pos_sentinel, self.pos_dtype)
        delta2d = np.zeros((n_dev, 1 + cap), np.int32)
        pos_s = pos[order]
        delta_s = delta[order]
        offs = np.concatenate([[0], np.cumsum(counts)])
        for d in range(n_dev):
            a, b = int(offs[d]), int(offs[d + 1])
            pos2d[d, 1: 1 + b - a] = pos_s[a:b]
            delta2d[d, 1: 1 + b - a] = delta_s[a:b]
        return pos2d, delta2d

    def _upload_rows(self, pos2d: np.ndarray, delta2d: np.ndarray,
                     blk: _Block) -> Tuple[torch.Tensor, torch.Tensor]:
        """A block's rows on its device, positions in the tier's device
        words (the uint32 tier crosses as its 32-bit words and widens
        there)."""
        rows = slice(blk.r0, blk.r0 + blk.rows)
        pos = pos2d[rows]
        if self.pos_dtype is np.uint32:
            dev = torch.from_numpy(pos.view(np.int32)).to(blk.device)
            dev = dev.to(torch.int64).bitwise_and_(0xFFFFFFFF)
        else:
            dev = torch.from_numpy(pos).to(blk.device)
        return dev, torch.from_numpy(delta2d[rows]).to(blk.device)

    def _finalize(self, lo: np.ndarray, hi: np.ndarray):
        """Bucket, upload, carry, sort, scan and evaluate every block;
        keeps the state. Returns each block's (2, B) (cover, dsum)."""
        pos2d, delta2d = self._bucketed()
        totals: List[torch.Tensor] = []
        outs = []
        for blk in self._blocks:
            p2, d2 = self._upload_rows(pos2d, delta2d, blk)
            left = torch.cat([t.to(blk.device) for t in totals]) if totals \
                else torch.zeros(0, dtype=torch.int64, device=blk.device)
            both, tot, blk.state = steps.finalize_rows(
                p2, d2, blk.bounds, left, *self._queries(lo, hi, blk),
                self.min_dep, self.wrap18, self.pos_sentinel)
            totals.append(tot)
            outs.append(both)
            del p2, d2
        self._finalized = True
        return outs

    @staticmethod
    def _queries(lo: np.ndarray, hi: np.ndarray, blk: _Block):
        q = torch.from_numpy(np.stack([lo, hi])).to(blk.device)
        return q[0], q[1]

    def _psum(self, outs) -> Tuple[np.ndarray, np.ndarray]:
        """Every block's (2, B) (cover, dsum) added on the first device,
        brought to the host in one copy."""
        dev0 = self._blocks[0].device
        both = outs[0]
        for o in outs[1:]:
            both = both + o.to(dev0)
        both = both.cpu().numpy()
        return both[0], both[1]

    def segment_bounds(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                       seg_end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global [lo, hi) int64 of 1-based inclusive segments, clamped
        into each contig's padded range (the single-device engine's
        clamping)."""
        lay = self.layout
        lo = lay.offsets[seg_tid] + np.maximum(
            np.asarray(seg_start, np.int64) - 1, 0)
        hi = lay.offsets[seg_tid] + np.asarray(seg_end, np.int64)
        lo = np.minimum(lo, lay.limits[seg_tid])
        hi = np.minimum(hi, lay.limits[seg_tid])
        return lo, np.maximum(hi, lo)

    def segment_stats(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                      seg_end: np.ndarray,
                      chunk: int = 1 << 20) -> SegmentStats:
        """Stats for 1-based inclusive [seg_start, seg_end] segments."""
        lo, hi = self.segment_bounds(seg_tid, seg_start, seg_end)
        b = lo.shape[0]
        cover = np.empty(b, np.int64)
        dsum = np.empty(b, np.int64)
        for i in range(0, b, chunk):
            j = min(i + chunk, b)
            if not self._finalized:
                outs = self._finalize(lo[i:j], hi[i:j])
            else:
                outs = [steps.eval_pair_rows(
                    *blk.state, blk.bounds, self.min_dep,
                    *self._queries(lo[i:j], hi[i:j], blk))
                    for blk in self._blocks]
            cover[i:j], dsum[i:j] = self._psum(outs)
        return SegmentStats(cover=cover, depth_sum=dsum)
