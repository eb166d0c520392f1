"""CoverageEngine on PyTorch: raw start/end event pairs or columnar read
batches in, per-segment statistics out. The port of the raw-event half
of ``pandepth_tpu/device/engine.py``.

Host-staged pairs go to the device in one copy per flush, and the
``pack_events`` kernel turns them into +-1 events there. A read batch
(``add_batch``, the Python decoders' CIGAR feed) goes up as its seven
int32 columns in one copy, and the ``extract_events`` kernel turns it
into events in the engine's position tier. ``segment_stats`` runs sort
-> ``sweep_scan`` -> ``eval_pair`` on one stream and brings (cover,
dsum) back in one copy. The engine presents the surface that the shared
run helpers of ``pandepth_tpu.run`` read (``pos_dtype`` is the numpy
dtype the native feed views its buffers as).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from pandepth_tpu.device.hosteval import SegmentStats, pos_dtype_for
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.convert import device_pos_dtype
from pandepth_tpu_torch.device.events import extract_events


class CoverageEngine:
    """Accumulates coverage events for one genome layout on ``device``."""

    # the native loaders hand over sentinel-padded pos_dtype arrays
    wants_padded_events = True
    # encoded windows exist for a narrow TPU link; PANDEPTH_ENC is not read
    wants_encoded_windows = False
    # the shared run helpers must never start jax for this engine
    jax_free = True

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False, *, device):
        # the native feeds filter by flags and MAPQ themselves; add_batch
        # filters here
        self.layout = layout
        self.flags_mask = int(flags_mask)
        self.min_mapq = int(min_mapq)
        self.min_dep = max(int(min_dep), 1)
        self.wrap18 = bool(wrap18)
        self.device = torch.device(device)
        self.pos_dtype = pos_dtype_for(layout.total)
        self.pos_sentinel = int(np.iinfo(self.pos_dtype).max)
        self._dev_dtype = device_pos_dtype(self.pos_dtype)
        self._dev_np = np.int32 if self._dev_dtype == torch.int32 \
            else np.int64
        # the uint32 tier uploads its bit patterns as int32 words
        self._raw_np = np.int64 if self.pos_dtype is np.int64 else np.int32
        self._stage: List[Tuple[np.ndarray, np.ndarray]] = []
        self._staged = 0
        self._flush_events = int(os.environ.get(
            "PANDEPTH_FLUSH_EVENTS", 48 << 20))
        self._chunks: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._layout_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._state: Optional[Tuple[torch.Tensor, ...]] = None
        self.n_reads_seen = 0
        self.keep_state = True

    @property
    def pos_bits32(self) -> bool:
        """True when positions ride the 32-bit native feed (int32 or
        uint32 tier)."""
        return self.pos_dtype is not np.int64

    @property
    def pos_sentinel32(self) -> int:
        """pos_sentinel as the signed-int32 bit pattern the native feed
        writes (-1 for the uint32 tier)."""
        return int(np.array(self.pos_sentinel,
                            np.uint64).astype(np.uint32).view(np.int32))

    # ------------------------------------------------------------------
    def add_start_end(self, starts: np.ndarray, ends: np.ndarray) -> None:
        """Stage global [start, end) pairs; sentinel-tailed slots are
        fine (they pack to zero deltas)."""
        if starts.shape[0] == 0:
            return
        self._stage.append((starts.astype(self.pos_dtype, copy=False),
                            ends.astype(self.pos_dtype, copy=False)))
        self._staged += starts.shape[0]
        self._state = None
        if self._staged >= self._flush_events:
            self._flush_stage()

    add_padded_events = add_start_end

    def upload_staged(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """One host->device copy of all staged pairs: the raw start and
        end words on the device (int32 for the 32-bit tiers, int64
        otherwise), or None when nothing is staged."""
        if not self._stage:
            return None
        m = self._staged
        buf = np.empty(2 * m, self.pos_dtype)
        o = 0
        for s, e in self._stage:
            k = s.shape[0]
            buf[o: o + k] = s
            buf[m + o: m + o + k] = e
            o += k
        self._stage = []
        self._staged = 0
        dev = torch.from_numpy(buf.view(self._raw_np)).to(self.device)
        return dev[:m], dev[m:]

    def _flush_stage(self) -> None:
        raw = self.upload_staged()
        if raw is not None:
            self._chunks.append(sweep.pack_events(*raw, self.pos_sentinel))

    def add_batch(self, batch) -> None:
        """Extract the events of a columnar ``ReadBatch`` on the device.
        Nothing is padded: the kernel takes any N and M."""
        n, m = batch.n_reads, batch.n_total_ops
        if n == 0:
            return
        self.n_reads_seen += n
        if m == 0:
            return
        cols = torch.from_numpy(np.concatenate([
            batch.tid, batch.pos, batch.flag, batch.mapq, batch.op_code,
            batch.op_len, batch.op_read]).astype(np.int32, copy=False))
        c = cols.to(self.device)
        if self._layout_dev is None:
            lay = torch.from_numpy(np.stack([self.layout.offsets,
                                             self.layout.limits]))
            lay = lay.to(self.device)
            self._layout_dev = (lay[0], lay[1])
        self._chunks.append(extract_events(
            c[:n], c[n:2 * n], c[2 * n:3 * n], c[3 * n:4 * n],
            c[4 * n:4 * n + m], c[4 * n + m:4 * n + 2 * m],
            c[4 * n + 2 * m:], *self._layout_dev,
            flags_mask=self.flags_mask, min_mapq=self.min_mapq,
            sentinel=self.pos_sentinel, pos_dtype=self._dev_dtype))
        self._state = None

    def add_intervals(self, tid: np.ndarray, start0: np.ndarray,
                      end0: np.ndarray) -> None:
        """Depth +1 over 0-based half-open [start0, end0) intervals,
        clamped into each contig's padded range."""
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
        """Append pre-built events; positions past the tier clamp to the
        sentinel."""
        if pos.shape[0] == 0:
            return
        p = np.minimum(pos, self.pos_sentinel).astype(self.pos_dtype)
        self._chunks.append((
            torch.from_numpy(p.astype(self._dev_np)).to(self.device),
            torch.from_numpy(np.asarray(delta, np.int32)).to(self.device)))
        self._state = None

    # ------------------------------------------------------------------
    def _event_chunks(self):
        self._flush_stage()
        if self._chunks:
            return ([c[0] for c in self._chunks],
                    [c[1] for c in self._chunks])
        return ([torch.full((1,), self.pos_sentinel, dtype=self._dev_dtype,
                            device=self.device)],
                [torch.zeros(1, dtype=torch.int32, device=self.device)])

    def sweep_state(self):
        """(pos_sorted, depth, c_cov, c_sum) tensors; cached until new
        events arrive."""
        if self._state is None:
            cp, cd = self._event_chunks()
            full = sweep.sort_events(torch.cat(cp), torch.cat(cd),
                                     min_dep=self.min_dep,
                                     wrap18=self.wrap18,
                                     pos_max=self.pos_sentinel)
            self._chunks = [(full[0], full[4])]
            self._state = full[:4]
        return self._state

    def segment_bounds(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                       seg_end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global [lo, hi) of 1-based inclusive segments, clamped into each
        contig's padded range exactly like the depth writes are."""
        lay = self.layout
        lo = lay.offsets[seg_tid] + np.maximum(seg_start - 1, 0)
        hi = lay.offsets[seg_tid] + np.asarray(seg_end, np.int64)
        lo = np.minimum(lo, lay.limits[seg_tid])
        hi = np.minimum(hi, lay.limits[seg_tid])
        return lo, np.maximum(hi, lo)

    def queries(self, lo: np.ndarray, hi: np.ndarray):
        """Segment bounds on the device in the position dtype, one copy."""
        q = torch.from_numpy(np.stack([lo, hi]).astype(self._dev_np))
        q = q.to(self.device)
        return q[0], q[1]

    @staticmethod
    def _fetch(cover: torch.Tensor, dsum: torch.Tensor) -> SegmentStats:
        both = torch.stack([cover, dsum]).cpu().numpy()
        return SegmentStats(cover=both[0], depth_sum=both[1])

    def segment_stats(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                      seg_end: np.ndarray, chunk: int = 1 << 20,
                      keep_state: Optional[bool] = None) -> SegmentStats:
        """Stats for 1-based inclusive [seg_start, seg_end] segments.

        The first call runs the whole finalize (sort,
        scan, eval) in one queue; with ``keep_state`` the sweep state stays
        on the device for later calls.
        """
        keep = self.keep_state if keep_state is None else keep_state
        lo, hi = self.segment_bounds(seg_tid, seg_start, seg_end)
        b = lo.shape[0]

        if self._state is None and b <= chunk:
            cp, cd = self._event_chunks()
            q_lo, q_hi = self.queries(lo, hi)
            out = sweep.finalize_chunked(
                cp, cd, q_lo, q_hi, min_dep=self.min_dep,
                wrap18=self.wrap18, want_state=keep,
                pos_max=self.pos_sentinel)
            if keep:
                self._state = out[2:6]
                self._chunks = [(out[2], out[6])]
            return self._fetch(out[0], out[1])

        pos_s, depth, c_cov, c_sum = self.sweep_state()
        cover = np.empty(b, np.int64)
        dsum = np.empty(b, np.int64)
        for i in range(0, b, chunk):
            j = min(i + chunk, b)
            q_lo, q_hi = self.queries(lo[i:j], hi[i:j])
            st = self._fetch(*sweep.eval_pair(pos_s, depth, c_cov, c_sum,
                                              self.min_dep, q_lo, q_hi))
            cover[i:j] = st.cover
            dsum[i:j] = st.depth_sum
        return SegmentStats(cover=cover, depth_sum=dsum)
