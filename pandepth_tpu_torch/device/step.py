"""The single-device coverage step: the port of
``pandepth_tpu/device/step.py``.

A read batch and segment boundaries in, per-segment statistics out:
``extract_events``, then ``sort_events``, then ``eval_boundaries`` at
``seg_lo`` and ``seg_hi`` (one call on both), queued on one stream with
no host synchronisation. It has no kernel of its own.
"""

from __future__ import annotations

import torch

from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.events import extract_events


def coverage_step(tid, pos, flag, mapq, op_code, op_len, op_read,
                  offsets, limits, seg_lo, seg_hi,
                  flags_mask: int = 1796, min_mapq: int = -1,
                  min_dep: int = 1, wrap18: bool = False):
    """(cover, depth_sum) int64 (B,) per 0-based half-open global segment
    [seg_lo, seg_hi) (int64), for one batch of reads."""
    ev_pos, ev_delta = extract_events(
        tid, pos, flag, mapq, op_code, op_len, op_read, offsets, limits,
        flags_mask=flags_mask, min_mapq=min_mapq)
    # int64 positions: the last piece ends at the int64 max, as in JAX
    pos_s, depth, c_cov, c_sum, _ = sweep.sort_events(
        ev_pos, ev_delta, min_dep=min_dep, wrap18=wrap18)
    # one eval_boundaries call on both sides (JAX calls it twice): on the
    # card one launch where two cost twice the host's time
    b = seg_lo.shape[0]
    q_cov, q_sum = sweep.eval_boundaries(pos_s, depth, c_cov, c_sum,
                                         min_dep, torch.cat([seg_lo, seg_hi]))
    return q_cov[b:] - q_cov[:b], q_sum[b:] - q_sum[:b]
