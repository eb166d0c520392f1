"""The sweep state carried across between the two packages.

The JAX package keeps positions in the numpy dtype that
``pandepth_tpu.device.hosteval.pos_dtype_for`` picks: int32 below 2 Gb,
uint32 up to 4 Gb, int64 beyond. PyTorch has no uint32 arithmetic
(subtraction, ``<`` and ``searchsorted`` raise), so the port carries
uint32-tier positions as zero-extended int64. The tier's max (the
sentinel, and the end of the last sweep piece) stays the uint32 max.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pandepth_tpu_torch.device.kernels import TIER_I32, TIER_I64, TIER_U32

_TIERS = {np.dtype(np.int32): TIER_I32, np.dtype(np.uint32): TIER_U32,
          np.dtype(np.int64): TIER_I64}
_TIER_BY_MAX = {int(np.iinfo(dt).max): tier for dt, tier in _TIERS.items()}


def device_pos_dtype(np_pos_dtype) -> torch.dtype:
    """int32 -> torch.int32; uint32 and int64 -> torch.int64."""
    return torch.int32 if tier_of(np_pos_dtype) == TIER_I32 else torch.int64


def tier_of(np_pos_dtype) -> int:
    """The kernel tier of a numpy position dtype."""
    try:
        return _TIERS[np.dtype(np_pos_dtype)]
    except KeyError:
        raise ValueError(f"no position tier for {np_pos_dtype}") from None


def tier_for_max(pos_max: int) -> int:
    """The tier whose max (sentinel) is ``pos_max``."""
    try:
        return _TIER_BY_MAX[int(pos_max)]
    except KeyError:
        raise ValueError(f"{pos_max} is no tier's sentinel") from None


def state_from_numpy(pos_s: np.ndarray, depth: np.ndarray,
                     c_cov: np.ndarray, c_sum: np.ndarray, pos_dtype,
                     device) -> Tuple[torch.Tensor, ...]:
    """The JAX package's (pos_s, depth, c_cov, c_sum) as the port's
    tensors on ``device``."""
    words = np.int32 if device_pos_dtype(pos_dtype) == torch.int32 \
        else np.int64
    # np.array copies: the JAX package's arrays may be read-only
    pos = np.array(pos_s, pos_dtype).astype(words)
    return tuple(torch.from_numpy(a).to(device) for a in (
        pos, np.array(depth, np.int32), np.array(c_cov, np.int64),
        np.array(c_sum, np.int64)))


def state_to_numpy(pos_s: torch.Tensor, depth: torch.Tensor,
                   c_cov: torch.Tensor, c_sum: torch.Tensor,
                   pos_dtype) -> Tuple[np.ndarray, ...]:
    """The port's sweep state as the JAX package's numpy arrays, positions
    back in ``pos_dtype``."""
    return (pos_s.cpu().numpy().astype(pos_dtype, copy=False),
            depth.cpu().numpy(), c_cov.cpu().numpy(), c_sum.cpu().numpy())


def code_words(code_dtype) -> type:
    """The numpy dtype whose bytes carry a code plane to the device:
    uint8 as it is, uint16 as its raw bits in int16, because PyTorch's
    uint16 has almost no arithmetic. Never a wider type, which would
    multiply the bytes that cross."""
    if np.dtype(code_dtype) == np.uint16:
        return np.int16
    if np.dtype(code_dtype) != np.uint8:
        raise ValueError(f"codes must be uint8 or uint16, not {code_dtype}")
    return np.uint8


def codes_to_torch(codes: np.ndarray) -> torch.Tensor:
    """A uint8 or uint16 code block as a tensor of the same bytes (see
    :func:`code_words`)."""
    codes = np.ascontiguousarray(codes)
    return torch.from_numpy(codes.view(code_words(codes.dtype)))


def positions_to_words(pos: np.ndarray, pos_dtype) -> np.ndarray:
    """Positions of the ``pos_dtype`` tier as the port's device words:
    int32 for the int32 tier, zero-extended int64 for the uint32 tier,
    int64 for the int64 tier."""
    words = np.int32 if device_pos_dtype(pos_dtype) == torch.int32 \
        else np.int64
    return np.asarray(pos).astype(pos_dtype).astype(words)


def enc_group_from_numpy(group, pos_dtype, device) -> tuple:
    """One group operand of the JAX package's ``finalize_encoded``, as
    numpy arrays (tuples of code, escape and slot blocks, the bases, and
    for the const format the lens and ns), as the port's tensors on
    ``device``: codes by :func:`codes_to_torch`, escapes int64, slots,
    lens and ns int32, bases in the tier's words."""
    codes, excs, slots, bases, *const = group

    def dev(a, dt=None):
        return torch.from_numpy(np.array(a, dt) if dt else a).to(device)

    return (tuple(codes_to_torch(c).to(device) for c in codes),
            tuple(dev(e, np.int64) for e in excs),
            tuple(dev(s, np.int32) for s in slots),
            dev(positions_to_words(bases, pos_dtype)),
            *(dev(a, np.int32) for a in const))
