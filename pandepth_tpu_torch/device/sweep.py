"""Position-sorted event sweep on PyTorch tensors: the port of
``pandepth_tpu/device/sweep.py`` (and of ``_pack_events`` from
``pandepth_tpu/device/engine.py``), the encoded-window decode of its
``finalize_encoded`` included.

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

from typing import Optional, Sequence, Tuple

import torch

from pandepth_tpu_torch.device import kernels
from pandepth_tpu_torch.device.convert import tier_for_max
from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_U32

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


# ---------------------------------------------------------------------
# K8: pandepth_tpu/device/sweep.py:finalize_encoded, with its decoders
# _decode_enc_group (:133) and _decode_const_group (:175)
#
# A group is the JAX operand: (codes, excs, slots, bases) in the mixed
# format, (codes, excs, slots, bases, lens, ns) in the const format.
# codes, excs and slots are tuples of same-shape blocks: codes (B, 2, CAP)
# or (B, CAP), uint8 or uint16 carried as its int16 bits (see
# convert.codes_to_torch); excs int64 and slots int32, (B, 2, CE) or
# (B, CE), unused slots at CAP. bases (NB*B,) in the tier's words; lens
# and ns (NB*B,) int32.

def _widen_codes(codes: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The code values as int64, and the escape value (the code type's
    max)."""
    if codes.dtype == torch.uint8:
        return codes.to(torch.int64), 0xFF
    if codes.dtype == torch.int16:
        return codes.to(torch.int64) & 0xFFFF, 0xFFFF
    raise ValueError(f"codes must be uint8 or int16 (uint16 bits), not "
                     f"{codes.dtype}")


def _zigzag(z):
    """The zigzag decode, of an int64 tensor or an int."""
    return (z >> 1) ^ -(z & 1)


def _tier_values(x: torch.Tensor, tier: int) -> torch.Tensor:
    """int64 values reduced as the tier's arithmetic wraps (int32 and
    uint32 are modular in JAX), in the tier's device words."""
    if tier == TIER_I32:
        return (((x & _U32_MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)
    if tier == TIER_U32:
        return x & _U32_MASK
    return x


def _corrections(vals: torch.Tensor, slots: torch.Tensor, cap: int,
                 tier: int) -> torch.Tensor:
    """(rows, CAP) int64: ``vals`` added at ``slots`` per row, as JAX's
    scatter-add does; slots outside [0, CAP) (unused ones hold CAP) are
    dropped."""
    ok = (slots >= 0) & (slots < cap)
    idx = torch.where(ok, slots, cap).to(torch.int64)
    vals = torch.where(ok, _tier_values(vals, tier).to(torch.int64), 0)
    out = torch.zeros(slots.shape[0], cap + 1, dtype=torch.int64,
                      device=slots.device)
    return out.scatter_add_(1, idx, vals)[:, :cap]


def _row_starts(dd: torch.Tensor, excd: torch.Tensor, sd: torch.Tensor,
                bases: torch.Tensor, tier: int) -> torch.Tensor:
    """(rows, CAP) int64 starts, not yet reduced to the tier: base + the
    running sum of the decoded deltas, escapes applied."""
    z, esc = _widen_codes(dd)
    corr = _corrections(excd - _zigzag(esc), sd, dd.shape[1], tier)
    delta = _tier_values(_zigzag(z) + corr, tier).to(torch.int64)
    return bases.to(torch.int64)[:, None] + torch.cumsum(delta, 1)


def decode_enc_group_reference(codes, excs, slots, bases,
                               pos_max: Optional[int] = None):
    """The twin of JAX's ``_decode_enc_group``: a mixed-format group ->
    flat (starts, ends) in the tier's words, row-major."""
    tier = tier_for_max(_pos_max(bases, pos_max))
    cc, ee, ss = torch.cat(list(codes)), torch.cat(list(excs)), \
        torch.cat(list(slots))
    starts = _row_starts(cc[:, 0], ee[:, 0], ss[:, 0], bases, tier)
    ll, esc = _widen_codes(cc[:, 1])
    lens = ll + _corrections(ee[:, 1] - esc, ss[:, 1], ll.shape[1], tier)
    return (_tier_values(starts, tier).ravel(),
            _tier_values(starts + lens, tier).ravel())


def decode_const_group_reference(codes, excs, slots, bases, lens, ns,
                                 pos_max: Optional[int] = None):
    """The twin of JAX's ``_decode_const_group``: a const-length group ->
    flat (starts, ends); row r's length is lens[r] for its first ns[r]
    slots and 0 after them."""
    tier = tier_for_max(_pos_max(bases, pos_max))
    cc, ee, ss = torch.cat(list(codes)), torch.cat(list(excs)), \
        torch.cat(list(slots))
    starts = _row_starts(cc, ee, ss, bases, tier)
    live = torch.arange(cc.shape[1], device=cc.device)[None, :] \
        < ns[:, None]
    ln = torch.where(live, lens.to(torch.int64)[:, None], 0)
    return (_tier_values(starts, tier).ravel(),
            _tier_values(starts + ln, tier).ravel())


def _group_rows(group) -> Tuple[int, int]:
    """(rows, CAP) of a group."""
    return sum(c.shape[0] for c in group[0]), group[0][0].shape[-1]


def _decode_into(group, tier: int, pos: torch.Tensor, delta: torch.Tensor,
                 off: int) -> int:
    """A group's starts then ends, through the K8 kernel block by block,
    into pos/delta from ``off``; returns the offset after them."""
    const = len(group) == 6
    rows, cap = _group_rows(group)
    r0 = 0
    for i, codes in enumerate(group[0]):
        b = codes.shape[0]
        sl = slice(r0, r0 + b)
        kernels.decode_enc(codes, group[1][i], group[2][i], group[3][sl],
                           group[4][sl] if const else None,
                           group[5][sl] if const else None, tier, pos,
                           delta, off + r0 * cap, off + (rows + r0) * cap)
        r0 += b
    return off + 2 * rows * cap


def decode_enc_group(codes, excs, slots, bases,
                     pos_max: Optional[int] = None):
    """A mixed-format group -> flat (starts, ends) in the tier's words."""
    if not _use_kernel(bases):
        return decode_enc_group_reference(codes, excs, slots, bases,
                                          pos_max)
    return _decode_alone((codes, excs, slots, bases), pos_max)


def decode_const_group(codes, excs, slots, bases, lens, ns,
                       pos_max: Optional[int] = None):
    """A const-length group -> flat (starts, ends) in the tier's words."""
    if not _use_kernel(bases):
        return decode_const_group_reference(codes, excs, slots, bases, lens,
                                            ns, pos_max)
    return _decode_alone((codes, excs, slots, bases, lens, ns), pos_max)


def _decode_alone(group, pos_max: Optional[int]):
    tier = tier_for_max(_pos_max(group[3], pos_max))
    rows, cap = _group_rows(group)
    pos = torch.empty(2 * rows * cap, dtype=group[3].dtype,
                      device=group[3].device)
    delta = torch.empty_like(pos, dtype=torch.int32)
    _decode_into(group, tier, pos, delta, 0)
    return pos[:rows * cap], pos[rows * cap:]


def _present(g8, g16, gc8, gc16) -> list:
    return [g for g in (g8, g16, gc8, gc16) if g is not None and g[0]]


def finalize_encoded_reference(g8, g16, gc8, gc16, raw_pos, raw_delta,
                               seg_lo, seg_hi, min_dep: int = 1,
                               wrap18: bool = False,
                               method: Optional[str] = None,
                               want_state: bool = True,
                               pos_max: Optional[int] = None):
    """The twin of :func:`finalize_encoded`: the decoders' twins, one
    concatenation, :func:`finalize_chunked_reference`."""
    cp, cd = [], []
    for g in _present(g8, g16, gc8, gc16):
        decode = decode_const_group_reference if len(g) == 6 \
            else decode_enc_group_reference
        s, e = decode(*g, pos_max=pos_max)
        ones = torch.ones(s.shape[0], dtype=torch.int32, device=s.device)
        cp += [s, e]
        cd += [ones, -ones]
    return finalize_chunked_reference(cp + list(raw_pos), cd + list(raw_delta),
                                      seg_lo, seg_hi, min_dep, wrap18,
                                      want_state=want_state, pos_max=pos_max)


def finalize_encoded(g8, g16, gc8, gc16, raw_pos, raw_delta, seg_lo, seg_hi,
                     min_dep: int = 1, wrap18: bool = False,
                     method: Optional[str] = None, want_state: bool = True,
                     pos_max: Optional[int] = None):
    """Decode the four code groups (mixed u8, mixed u16, const u8, const
    u16; a group may be None), merge them with the raw event chunks in
    JAX's order ``[s8, e8, s16, e16, sc8, ec8, sc16, ec16, *raw_pos]``,
    +1 at each start and -1 at each end, and finalize as
    :func:`finalize_chunked`. On a CUDA tensor the K8 kernel writes every
    group straight into the one event buffer at its offset, and the raw
    chunks are copied in after them."""
    groups = _present(g8, g16, gc8, gc16)
    if not groups and not raw_pos:
        raise ValueError("finalize_encoded: no events")
    first = groups[0][3] if groups else raw_pos[0]
    kw = dict(min_dep=min_dep, wrap18=wrap18, want_state=want_state,
              pos_max=_pos_max(first, pos_max))
    if not _use_kernel(first):
        return finalize_encoded_reference(g8, g16, gc8, gc16, raw_pos,
                                          raw_delta, seg_lo, seg_hi, **kw)
    tier = tier_for_max(kw["pos_max"])
    n = sum(2 * r * c for r, c in map(_group_rows, groups)) \
        + sum(p.shape[0] for p in raw_pos)
    pos = torch.empty(n, dtype=first.dtype, device=first.device)
    delta = torch.empty(n, dtype=torch.int32, device=first.device)
    off = 0
    for g in groups:
        off = _decode_into(g, tier, pos, delta, off)
    for p, d in zip(raw_pos, raw_delta):
        pos[off:off + p.shape[0]].copy_(p)
        delta[off:off + p.shape[0]].copy_(d)
        off += p.shape[0]
    return finalize_chunked([pos], [delta], seg_lo, seg_hi, **kw)
