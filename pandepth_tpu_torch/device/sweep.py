"""Position-sorted event sweep on PyTorch tensors: the port of
``pandepth_tpu/device/sweep.py`` (and of ``_pack_events`` from
``pandepth_tpu/device/engine.py``).

Same signatures and return tuples as the JAX functions. Each function
has a plain PyTorch twin (``*_reference``) in this module. The dispatch
rule: a CPU tensor goes to the twin; a CUDA tensor goes to the
hand-written kernel (``csrc/sweep_kernels.cu``) or the call raises.
Nothing falls back.

Positions are int32 or int64 tensors (:mod:`convert` carries the uint32
tier as int64). ``pos_max`` names the tier's max, the end of the last
sweep piece: it defaults to the dtype's max and is 0xFFFFFFFF for the
uint32 tier. ``method`` is accepted for the JAX signature and ignored.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pandepth_tpu_torch.device import kernels
from pandepth_tpu_torch.device.convert import tier_for_max
from pandepth_tpu_torch.device.kernels import TIER_U32

WRAP18_MASK = 0x3FFFF
_U32_MASK = 0xFFFFFFFF


def _use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"pandepth_tpu_torch runs on cuda or cpu, not "
                     f"{t.device}")


def _pos_max(pos: torch.Tensor, pos_max: Optional[int]) -> int:
    return int(torch.iinfo(pos.dtype).max) if pos_max is None \
        else int(pos_max)


# ---------------------------------------------------------------------
# K1: pandepth_tpu/device/engine.py:_pack_events

def pack_events_reference(starts: torch.Tensor, ends: torch.Tensor,
                          sentinel: int):
    if tier_for_max(sentinel) == TIER_U32:
        # raw uint32 bit patterns arrive as int32: zero-extend
        starts = starts.to(torch.int64) & _U32_MASK
        ends = ends.to(torch.int64) & _U32_MASK
    pos = torch.cat([starts, ends])
    delta = torch.cat([(starts < sentinel).to(torch.int32),
                       -(ends < sentinel).to(torch.int32)])
    return pos, delta


def pack_events(starts: torch.Tensor, ends: torch.Tensor, sentinel: int):
    """(M,) starts and ends -> (2M,) positions, (2M,) int32 deltas (+1 at
    a start, -1 at an end, 0 at a sentinel slot). ``sentinel`` names the
    tier; 32-bit tiers take int32 words, the int64 tier int64."""
    if _use_kernel(starts):
        return kernels.pack_events(starts, ends, tier_for_max(sentinel))
    return pack_events_reference(starts, ends, sentinel)


# ---------------------------------------------------------------------
# K2: pandepth_tpu/device/sweep.py:sort_events

def sweep_scan_reference(pos_s: torch.Tensor, delta_s: torch.Tensor,
                         min_dep: int, wrap18: bool, pos_max: int):
    """(depth, c_cov, c_sum) of sorted events: the twin of the
    ``sweep_scan`` kernel."""
    depth = torch.cumsum(delta_s, 0, dtype=torch.int32)
    if wrap18:
        depth = depth & WRAP18_MASK
    covered = depth >= min_dep
    nxt = torch.cat([pos_s[1:], torch.full((1,), pos_max,
                                           dtype=pos_s.dtype,
                                           device=pos_s.device)])
    # sorted, so nxt >= pos_s and no tier's subtraction wraps
    plen = torch.where(covered, nxt - pos_s, 0).to(torch.int64)
    c_cov = torch.cumsum(plen, 0)
    c_sum = torch.cumsum(plen * depth.to(torch.int64), 0)
    return depth, c_cov, c_sum


def sort_events_reference(ev_pos: torch.Tensor, ev_delta: torch.Tensor,
                          min_dep: int = 1, wrap18: bool = False,
                          pos_max: Optional[int] = None):
    pos_s, order = torch.sort(ev_pos, stable=True)
    delta_s = ev_delta[order]
    depth, c_cov, c_sum = sweep_scan_reference(
        pos_s, delta_s, min_dep, wrap18, _pos_max(ev_pos, pos_max))
    return pos_s, depth, c_cov, c_sum, delta_s


def sort_events(ev_pos: torch.Tensor, ev_delta: torch.Tensor,
                min_dep: int = 1, wrap18: bool = False,
                pos_max: Optional[int] = None):
    """Sort events and build the sweep state: (pos_sorted, depth int32,
    c_cov int64, c_sum int64, delta_sorted int32). The stable library
    sort stands where JAX used ``lax.sort_key_val``; the scans are the
    ``sweep_scan`` kernel."""
    if not _use_kernel(ev_pos):
        return sort_events_reference(ev_pos, ev_delta, min_dep, wrap18,
                                     pos_max)
    pos_s, order = torch.sort(ev_pos, stable=True)
    delta_s = ev_delta[order]
    depth, c_cov, c_sum = kernels.sweep_scan(
        pos_s, delta_s, min_dep, wrap18, _pos_max(ev_pos, pos_max))
    return pos_s, depth, c_cov, c_sum, delta_s


# ---------------------------------------------------------------------
# K3: pandepth_tpu/device/sweep.py:eval_pair and
# K5: pandepth_tpu/device/sweep.py:eval_boundaries

def eval_boundaries_reference(pos_s: torch.Tensor, depth: torch.Tensor,
                              c_cov: torch.Tensor, c_sum: torch.Tensor,
                              min_dep: int, x: torch.Tensor):
    x = x.to(pos_s.dtype)
    r = torch.searchsorted(pos_s, x, side="left")
    e = pos_s.shape[0]
    i_full = (r - 2).clamp(0, e - 1)
    i_part = (r - 1).clamp(0, e - 1)
    full_cov = torch.where(r >= 2, c_cov[i_full], 0)
    full_sum = torch.where(r >= 2, c_sum[i_full], 0)
    dep = depth[i_part].to(torch.int64)
    ind = (dep >= min_dep).to(torch.int64)
    diff = (x - pos_s[i_part]).to(torch.int64)
    part = torch.where(r >= 1, diff * ind, 0)
    return full_cov + part, full_sum + part * dep


def eval_boundaries(pos_s: torch.Tensor, depth: torch.Tensor,
                    c_cov: torch.Tensor, c_sum: torch.Tensor, min_dep: int,
                    x: torch.Tensor):
    """(Q_cov(x), Q_sum(x)) int64: the integrals of the covered indicator
    and of covered depth over [0, x), per boundary ``x`` (in the position
    dtype)."""
    if not _use_kernel(pos_s):
        return eval_boundaries_reference(pos_s, depth, c_cov, c_sum,
                                         min_dep, x)
    return kernels.eval_boundaries(pos_s, depth, c_cov, c_sum, min_dep, x)


def eval_pair_reference(pos_s: torch.Tensor, depth: torch.Tensor,
                        c_cov: torch.Tensor, c_sum: torch.Tensor,
                        min_dep: int, lo: torch.Tensor, hi: torch.Tensor,
                        method: Optional[str] = None):
    b = lo.shape[0]
    q_cov, q_sum = eval_boundaries_reference(pos_s, depth, c_cov, c_sum,
                                             min_dep, torch.cat([lo, hi]))
    return q_cov[b:] - q_cov[:b], q_sum[b:] - q_sum[:b]


def eval_pair(pos_s: torch.Tensor, depth: torch.Tensor, c_cov: torch.Tensor,
              c_sum: torch.Tensor, min_dep: int, lo: torch.Tensor,
              hi: torch.Tensor, method: Optional[str] = None):
    """Per-segment (cover, dsum) int64 = Q(hi) - Q(lo).
    ``lo``/``hi`` are in the position dtype."""
    if not _use_kernel(pos_s):
        return eval_pair_reference(pos_s, depth, c_cov, c_sum, min_dep,
                                   lo, hi)
    return kernels.eval_pair(pos_s, depth, c_cov, c_sum, min_dep, lo, hi)


# ---------------------------------------------------------------------
# K4: pandepth_tpu/device/sweep.py:finalize_chunked

def _one_buffer(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    return chunks[0] if len(chunks) == 1 else torch.cat(list(chunks))


def finalize_chunked_reference(chunks_pos, chunks_delta, seg_lo, seg_hi,
                               min_dep: int = 1, wrap18: bool = False,
                               method: Optional[str] = None,
                               want_state: bool = True,
                               pos_max: Optional[int] = None):
    pos_s, depth, c_cov, c_sum, delta_s = sort_events_reference(
        _one_buffer(chunks_pos), _one_buffer(chunks_delta), min_dep,
        wrap18, pos_max)
    cover, dsum = eval_pair_reference(pos_s, depth, c_cov, c_sum, min_dep,
                                      seg_lo, seg_hi)
    if not want_state:
        return cover, dsum
    return cover, dsum, pos_s, depth, c_cov, c_sum, delta_s


def finalize_chunked(chunks_pos, chunks_delta, seg_lo, seg_hi,
                     min_dep: int = 1, wrap18: bool = False,
                     method: Optional[str] = None, want_state: bool = True,
                     pos_max: Optional[int] = None):
    """Sort + scan + boundary eval over a tuple of event chunks, queued
    on one stream with no host synchronisation. Returns (cover, dsum) and,
    with ``want_state``, the sweep state (pos_s, depth, c_cov, c_sum,
    delta_s) after them."""
    pos_s, depth, c_cov, c_sum, delta_s = sort_events(
        _one_buffer(chunks_pos), _one_buffer(chunks_delta), min_dep,
        wrap18, pos_max)
    cover, dsum = eval_pair(pos_s, depth, c_cov, c_sum, min_dep, seg_lo,
                            seg_hi)
    if not want_state:
        return cover, dsum
    return cover, dsum, pos_s, depth, c_cov, c_sum, delta_s
