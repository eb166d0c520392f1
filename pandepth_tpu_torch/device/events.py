"""CIGAR -> coverage-event extraction on PyTorch tensors: the port of
``pandepth_tpu/device/events.py``.

Every M/=/X op of a kept read becomes a +1 event at its reference start
and a -1 event at its end; padded and filtered slots become (SENTINEL,
0), SENTINEL = 1 << 62. Same signature and return values as the JAX
function, plus the engine's tier: ``sentinel`` and ``pos_dtype`` default
to SENTINEL and int64; with a tier's sentinel and device dtype every
position is clamped to at most the sentinel and cast, which is what
``pandepth_tpu/device/engine.py:add_batch`` applies after extraction
(its int64 tier keeps dead slots at 1 << 62). A CPU tensor runs the plain twin
(:func:`extract_events_reference`); a CUDA tensor runs the
``extract_events`` kernel of ``csrc/sweep_kernels.cu`` or the call
raises.
"""

from __future__ import annotations

import torch

from pandepth_tpu.device.hosteval import (DEPTH_MASK, REF_CONSUME_MASK,
                                          SENTINEL)
from pandepth_tpu_torch.device import kernels, sweep

_I64_MAX = torch.iinfo(torch.int64).max


def _op_bit(mask: int, op_code: torch.Tensor) -> torch.Tensor:
    """Bit ``op_code`` of ``mask`` (0 outside [0, 32), as XLA shifts)."""
    ok = (op_code >= 0) & (op_code < 32)
    return torch.where(ok, (mask >> op_code.clamp(0, 31)) & 1, 0)


def extract_events_reference(tid, pos, flag, mapq, op_code, op_len, op_read,
                             offsets, limits, flags_mask: int,
                             min_mapq: int, sentinel: int = SENTINEL,
                             pos_dtype: torch.dtype = torch.int64):
    """Plain twin of the kernel, line for line the JAX function."""
    keep = (flag & flags_mask) == 0
    keep &= tid >= 0
    if min_mapq >= 1:
        keep &= mapq >= min_mapq

    consumes = _op_bit(REF_CONSUME_MASK, op_code)
    clen = (op_len * consumes).to(torch.int64)
    c = torch.cumsum(clen, 0)
    excl = c - clen
    n = tid.shape[0]
    read = op_read.to(torch.int64)
    # jax.ops.segment_min over op_read
    base = torch.full((n,), _I64_MAX, dtype=torch.int64,
                      device=tid.device).scatter_reduce(0, read, excl,
                                                        "amin")
    off = excl - base[read]

    is_depth = _op_bit(DEPTH_MASK, op_code) == 1
    is_depth &= keep[read] & (op_len > 0)

    # JAX gathers at max(tid, 0) and clamps past the last target
    tid_safe = tid.to(torch.int64).clamp(0, max(offsets.shape[0] - 1, 0))
    read_base = offsets[tid_safe] + pos.to(torch.int64)
    read_limit = limits[tid_safe]
    read_floor = offsets[tid_safe]

    start = read_base[read] + off
    end = start + op_len
    start = torch.clamp(start, read_floor[read], read_limit[read])
    end = torch.clamp(end, read_floor[read], read_limit[read])

    live = is_depth & (end > start)
    ev_pos = torch.cat([torch.where(live, start, SENTINEL),
                        torch.where(live, end, SENTINEL)])
    one = live.to(torch.int32)
    ev_delta = torch.cat([one, -one])
    return ev_pos.clamp(max=sentinel).to(pos_dtype), ev_delta


def extract_events(tid, pos, flag, mapq, op_code, op_len, op_read,
                   offsets, limits, flags_mask: int, min_mapq: int,
                   sentinel: int = SENTINEL,
                   pos_dtype: torch.dtype = torch.int64):
    """Turn a columnar read batch into coverage events.

    tid, pos, flag, mapq: (N,) int32; rows to drop carry tid = -1.
    op_code, op_len, op_read: (M,) int32 flattened CIGAR stream,
    ``op_read`` non-decreasing. offsets, limits: (n_targets,) int64.
    Returns ev_pos (2M,) ``pos_dtype`` (starts, then ends) and ev_delta
    (2M,) int32.
    """
    if not sweep._use_kernel(tid):
        return extract_events_reference(tid, pos, flag, mapq, op_code,
                                        op_len, op_read, offsets, limits,
                                        flags_mask, min_mapq, sentinel,
                                        pos_dtype)
    return kernels.extract_events(tid, pos, flag, mapq, op_code, op_len,
                                  op_read, offsets, limits, flags_mask,
                                  min_mapq, sentinel, pos_dtype)
