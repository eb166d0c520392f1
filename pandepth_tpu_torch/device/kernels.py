"""Build and bind the hand-written CUDA kernels (``csrc/sweep_kernels.cu``).

At first use the source is compiled with ``nvcc`` into a shared library
with a plain C interface, under ``pandepth_tpu_torch/_build/`` and keyed
by a hash of the source and the flags, then loaded with ``ctypes``. No
PyTorch headers are involved, so the build takes seconds. A failed build
raises: there is no fallback.

Each wrapper checks its tensors, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the C entry point reports a CUDA error, and adds
one to its entry in :data:`launches` when it launched its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sweep_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# position tiers, as the C interface numbers them
TIER_I32, TIER_U32, TIER_I64 = 0, 1, 2

#: launches per kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"pack_events": 0, "sweep_scan": 0,
                            "eval_pair": 0, "extract_events": 0,
                            "eval_boundaries": 0, "decode_enc": 0,
                            "shard_carry": 0, "eval_pair_rows": 0,
                            "bucket_events": 0}
#: ptxas's register / shared-memory report from the last build
build_log: str = ""

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "pandepth_tpu_torch cannot be built")


def build() -> Path:
    """Compile the kernels if this source has not been built yet; return
    the shared library's path."""
    global build_log
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsweep_kernels_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp),
           str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
    build_log = r.stderr
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for name in ("pdt_sweep_scan_scratch", "pdt_decode_enc_scratch",
                     "pdt_extract_events_scratch",
                     "pdt_bucket_events_scratch"):
            getattr(lib, name).restype = i64
        lib.pdt_sweep_scan_scratch.argtypes = [i64]
        lib.pdt_decode_enc_scratch.argtypes = [i64, i64]
        lib.pdt_extract_events_scratch.argtypes = [i64]
        lib.pdt_bucket_events_scratch.argtypes = [i64, ctypes.c_int]
        lib.pdt_pack_events.restype = ctypes.c_int
        lib.pdt_pack_events.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                        i64, vp, vp, vp]
        lib.pdt_sweep_scan.restype = ctypes.c_int
        lib.pdt_sweep_scan.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                       i64, i32, ctypes.c_int, i64, vp, vp,
                                       vp, vp, vp]
        lib.pdt_eval_pair.restype = ctypes.c_int
        lib.pdt_eval_pair.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                      vp, vp, i64, i32, vp, vp, i64, vp, vp,
                                      vp]
        lib.pdt_eval_boundaries.restype = ctypes.c_int
        lib.pdt_eval_boundaries.argtypes = [ctypes.c_int, ctypes.c_int, vp,
                                            vp, vp, vp, i64, i32, vp, i64,
                                            vp, vp, vp]
        lib.pdt_extract_events.restype = ctypes.c_int
        lib.pdt_extract_events.argtypes = [ctypes.c_int, vp, vp, vp, vp, i64,
                                           vp, vp, vp, i64, vp, vp, i64, i32,
                                           i32, ctypes.c_int, i64, vp, vp,
                                           vp, vp]
        lib.pdt_decode_enc.restype = ctypes.c_int
        lib.pdt_decode_enc.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, vp, vp, vp, vp, vp, vp,
                                       vp, i64, i64, vp, vp, vp, vp, vp, vp]
        lib.pdt_shard_carry.restype = ctypes.c_int
        lib.pdt_shard_carry.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                        i64, i64, vp, vp, i64, vp, vp, vp]
        lib.pdt_chase.restype = ctypes.c_int
        lib.pdt_chase.argtypes = [ctypes.c_int, vp, i64, vp, vp]
        lib.pdt_eval_pair_rows.restype = ctypes.c_int
        lib.pdt_eval_pair_rows.argtypes = [ctypes.c_int, ctypes.c_int, vp,
                                           vp, vp, vp, i64, i64, vp, i32,
                                           vp, vp, i64, vp, vp, vp]
        for name in ("pdt_bucket_tile", "pdt_bucket_max_world",
                     "pdt_sweep_scan_tile", "pdt_decode_enc_tile",
                     "pdt_extract_events_tile", "pdt_eval_pair_win",
                     "pdt_decode_enc_max_blocks", "pdt_carry_run"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = []
        lib.pdt_bucket_events.restype = ctypes.c_int
        lib.pdt_bucket_events.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                          i64, vp, ctypes.c_int, vp, vp, vp,
                                          vp, vp, vp]
        _lib = lib
        return lib


def _loaded() -> ctypes.CDLL:
    """:func:`library`, without taking its lock once it has loaded."""
    return _lib if _lib is not None else library()


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _require(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")


def _one_device(name: str, *ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: tensors on different devices")


def pack_events(starts: torch.Tensor, ends: torch.Tensor,
                tier: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (M,) raw start/end words -> (2M,) positions, (2M,) int32 deltas.
    The raw words are int32 for both 32-bit tiers (uint32 bit patterns in
    the uint32 tier) and int64 for the int64 tier."""
    raw = torch.int64 if tier == TIER_I64 else torch.int32
    _require("pack_events", starts, raw)
    _require("pack_events", ends, raw)
    if ends.shape != starts.shape or ends.device != starts.device:
        raise ValueError("pack_events: starts and ends differ in shape "
                         "or device")
    m = starts.shape[0]
    pos = torch.empty(2 * m, device=starts.device,
                      dtype=torch.int32 if tier == TIER_I32 else torch.int64)
    delta = torch.empty(2 * m, dtype=torch.int32, device=starts.device)
    if m:
        lib = _loaded()
        _check("pack_events", lib.pdt_pack_events(
            starts.get_device(), tier, _p(starts), _p(ends), m, _p(pos),
            _p(delta), _stream(starts)))
        launches["pack_events"] += 1
    return pos, delta


def _pos64(name: str, pos: torch.Tensor) -> int:
    if pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: positions must be int32 or int64, got "
                         f"{pos.dtype}")
    return int(pos.dtype == torch.int64)


def sweep_scan(pos_s: torch.Tensor, delta_s: torch.Tensor, min_dep: int,
               wrap18: bool, pos_max: int, out=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's arithmetic over sorted events: (depth int32, c_cov int64,
    c_sum int64), inclusive, the last piece measured against ``pos_max``
    (the tier's max); written into ``out`` (three tensors of those
    types) when it is given."""
    pos64 = _pos64("sweep_scan", pos_s)
    _require("sweep_scan", pos_s, pos_s.dtype)
    _require("sweep_scan", delta_s, torch.int32)
    if delta_s.shape != pos_s.shape:
        raise ValueError("sweep_scan: pos_s and delta_s differ in shape")
    n = pos_s.shape[0]
    dev = pos_s.device
    if out is None:
        out = (torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.int64, device=dev))
    depth, c_cov, c_sum = out
    for t, dt in zip(out, (torch.int32, torch.int64, torch.int64)):
        _require("sweep_scan", t, dt)
        if t.shape != pos_s.shape or t.device != dev:
            raise ValueError("sweep_scan: an output differs from pos_s in "
                             "shape or device")
    if n:
        lib = _loaded()
        scratch = torch.empty(lib.pdt_sweep_scan_scratch(n),
                              dtype=torch.int64, device=dev)
        _check("sweep_scan", lib.pdt_sweep_scan(
            pos_s.get_device(), pos64, _p(pos_s), _p(delta_s), n,
            int(min_dep), int(bool(wrap18)), int(pos_max), _p(depth),
            _p(c_cov), _p(c_sum), _p(scratch), _stream(pos_s)))
        launches["sweep_scan"] += 1
    return depth, c_cov, c_sum


def eval_pair(pos_s: torch.Tensor, depth: torch.Tensor, c_cov: torch.Tensor,
              c_sum: torch.Tensor, min_dep: int, lo: torch.Tensor,
              hi: torch.Tensor, out=None) -> torch.Tensor:
    """K3: (2, B) int64, the rows (cover, dsum) = Q(hi) - Q(lo) per
    segment, one buffer that one copy brings to the host (written into
    ``out`` when it is given); ``lo`` and ``hi`` in the dtype of
    ``pos_s``."""
    pos64 = _pos64("eval_pair", pos_s)
    for t in (pos_s, lo, hi):
        _require("eval_pair", t, pos_s.dtype)
    _require("eval_pair", depth, torch.int32)
    _require("eval_pair", c_cov, torch.int64)
    _require("eval_pair", c_sum, torch.int64)
    _one_device("eval_pair", pos_s, depth, c_cov, c_sum, lo, hi)
    e = pos_s.shape[0]
    if not (depth.shape[0] == c_cov.shape[0] == c_sum.shape[0] == e) \
            or lo.shape != hi.shape or e == 0:
        raise ValueError("eval_pair: inconsistent sweep state or query "
                         "shapes")
    b = lo.shape[0]
    if out is None:
        out = torch.empty((2, b), dtype=torch.int64, device=lo.device)
    if out.dtype != torch.int64 or tuple(out.shape) != (2, b) \
            or not out.is_contiguous() or out.device != lo.device:
        raise ValueError(f"eval_pair: out must be a contiguous (2, {b}) "
                         f"int64 tensor on {lo.device}")
    if b:
        _check("eval_pair", _loaded().pdt_eval_pair(
            pos_s.get_device(), pos64, _p(pos_s), _p(depth), _p(c_cov),
            _p(c_sum), e, int(min_dep), _p(lo), _p(hi), b, _p(out[0]),
            _p(out[1]), _stream(pos_s)))
        launches["eval_pair"] += 1
    return out


def eval_boundaries(pos_s: torch.Tensor, depth: torch.Tensor,
                    c_cov: torch.Tensor, c_sum: torch.Tensor, min_dep: int,
                    x: torch.Tensor, out=None) -> torch.Tensor:
    """K5: (2, B) int64, the rows (Q_cov(x), Q_sum(x)) per boundary, one
    buffer (written into ``out`` when it is given); ``x`` in the dtype of
    ``pos_s``."""
    pos64 = _pos64("eval_boundaries", pos_s)
    for t in (pos_s, x):
        _require("eval_boundaries", t, pos_s.dtype)
    _require("eval_boundaries", depth, torch.int32)
    _require("eval_boundaries", c_cov, torch.int64)
    _require("eval_boundaries", c_sum, torch.int64)
    _one_device("eval_boundaries", pos_s, depth, c_cov, c_sum, x)
    e = pos_s.shape[0]
    if not (depth.shape[0] == c_cov.shape[0] == c_sum.shape[0] == e) \
            or e == 0:
        raise ValueError("eval_boundaries: inconsistent sweep state")
    b = x.shape[0]
    if out is None:
        out = torch.empty((2, b), dtype=torch.int64, device=x.device)
    if out.dtype != torch.int64 or tuple(out.shape) != (2, b) \
            or not out.is_contiguous() or out.device != x.device:
        raise ValueError(f"eval_boundaries: out must be a contiguous "
                         f"(2, {b}) int64 tensor on {x.device}")
    if b:
        _check("eval_boundaries", _loaded().pdt_eval_boundaries(
            pos_s.get_device(), pos64, _p(pos_s), _p(depth), _p(c_cov),
            _p(c_sum), e, int(min_dep), _p(x), b, _p(out[0]), _p(out[1]),
            _stream(pos_s)))
        launches["eval_boundaries"] += 1
    return out


def chase(nxt: torch.Tensor, k: int) -> torch.Tensor:
    """A measurement helper (no JAX counterpart, no launch count): one
    thread follows ``k`` links of the int64 chain ``nxt`` (i = nxt[i],
    from 0), each load's address the value of the one before; returns
    where it ends, a (1,) int64 tensor. Its device time at two ``k`` gives
    the card's time a dependent load."""
    _require("chase", nxt, torch.int64)
    out = torch.empty(1, dtype=torch.int64, device=nxt.device)
    _check("chase", _loaded().pdt_chase(nxt.get_device(), _p(nxt), int(k),
                                        _p(out), _stream(nxt)))
    return out


def extract_events(tid: torch.Tensor, pos: torch.Tensor, flag: torch.Tensor,
                   mapq: torch.Tensor, op_code: torch.Tensor,
                   op_len: torch.Tensor, op_read: torch.Tensor,
                   offsets: torch.Tensor, limits: torch.Tensor,
                   flags_mask: int, min_mapq: int, sentinel: int,
                   pos_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: a columnar read batch -> (2M,) ``pos_dtype`` positions (starts
    at [0, M), ends at [M, 2M); dead slots at 1 << 62; all clamped to at
    most ``sentinel``) and (2M,) int32 deltas. ``op_read`` must be
    non-decreasing and ``op_len`` non-negative."""
    cols = (tid, pos, flag, mapq, op_code, op_len, op_read)
    dev = tid.device
    # one pass over the tensors; _require names the first that fails
    if dev.type != "cuda" or not all(
            t.dtype == dt and t.dim() == 1 and t.is_contiguous()
            and t.device == dev
            for ts, dt in ((cols, torch.int32),
                           ((offsets, limits), torch.int64)) for t in ts):
        for t in cols:
            _require("extract_events", t, torch.int32)
        _require("extract_events", offsets, torch.int64)
        _require("extract_events", limits, torch.int64)
        _one_device("extract_events", *cols, offsets, limits)
    if pos_dtype not in (torch.int32, torch.int64) \
            or not 0 < sentinel <= torch.iinfo(pos_dtype).max:
        raise ValueError(f"extract_events: sentinel {sentinel} does not "
                         f"fit {pos_dtype}")
    n, m, nt = tid.shape[0], op_code.shape[0], offsets.shape[0]
    if not (pos.shape[0] == flag.shape[0] == mapq.shape[0] == n
            and op_len.shape[0] == op_read.shape[0] == m
            and limits.shape[0] == nt) or (m and (n == 0 or nt == 0)):
        raise ValueError("extract_events: inconsistent batch shapes")
    ev_pos = torch.empty(2 * m, dtype=pos_dtype, device=dev)
    ev_delta = torch.empty(2 * m, dtype=torch.int32, device=dev)
    if m:
        lib = _loaded()
        scratch = torch.empty(lib.pdt_extract_events_scratch(m),
                              dtype=torch.int64, device=dev)
        _check("extract_events", lib.pdt_extract_events(
            dev.index, tid.data_ptr(), pos.data_ptr(), flag.data_ptr(),
            mapq.data_ptr(), n, op_code.data_ptr(), op_len.data_ptr(),
            op_read.data_ptr(), m, offsets.data_ptr(), limits.data_ptr(),
            nt, int(flags_mask), int(min_mapq),
            int(pos_dtype == torch.int64), int(sentinel), ev_pos.data_ptr(),
            ev_delta.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        launches["extract_events"] += 1
    return ev_pos, ev_delta


def _word(tier: int) -> torch.dtype:
    return torch.int32 if tier == TIER_I32 else torch.int64


def decode_enc(codes: Sequence[torch.Tensor],
               excs: Sequence[torch.Tensor], slots: Sequence[torch.Tensor],
               bases: torch.Tensor, lens: Optional[torch.Tensor],
               ns: Optional[torch.Tensor], tier: int, pos: torch.Tensor,
               delta: torch.Tensor, s_off: int, e_off: int) -> None:
    """K8 on a group of stacked blocks of windows, written in place into
    the event buffer ``pos``/``delta``: the group's row g (counted through
    the blocks in order) has its CAP starts at ``pos[s_off + g * CAP:]``
    and its ends at ``pos[e_off + g * CAP:]``, with +1 and -1 at the same
    slots of ``delta``. One launch for every ``pdt_decode_enc_max_blocks()``
    blocks.

    Each block of ``codes`` is (B, 2, CAP) in the mixed format or (B, CAP)
    in the const format (then ``lens`` and ``ns`` are (rows,) int32 over
    the whole group), uint8, or uint16 carried as its int16 bits; its
    ``excs`` (int64) and ``slots`` (int32) are (B, 2, CE) or (B, CE);
    ``bases`` ((rows,)) and ``pos`` are the tier's words."""
    if not codes or not (len(codes) == len(excs) == len(slots)):
        raise ValueError("decode_enc: needs as many code, escape and slot "
                         "blocks, at least one")
    const = codes[0].dim() == 2
    word = _word(tier)
    dt = codes[0].dtype
    if dt not in (torch.uint8, torch.int16):
        raise ValueError(f"decode_enc: codes must be uint8 or int16 (uint16 "
                         f"bits), got {dt}")
    shape = tuple(codes[0].shape)
    if const != (lens is not None) or const != (ns is not None) \
            or not (const or (codes[0].dim() == 3 and shape[1] == 2)):
        raise ValueError(f"decode_enc: codes of shape {shape} need lens "
                         f"and ns exactly in the const format")
    cap, ce = shape[-1], excs[0].shape[-1]
    rows = sum(c.shape[0] for c in codes)
    blocks = list(zip(codes, excs, slots))
    for c, e, sl in blocks:
        b = c.shape[0]
        if tuple(c.shape[1:]) != shape[1:] \
                or tuple(e.shape) != (b,) + shape[1:-1] + (ce,) \
                or sl.shape != e.shape:
            raise ValueError("decode_enc: inconsistent block shapes")
    if tuple(bases.shape) != (rows,) or (const and (
            tuple(lens.shape) != (rows,) or tuple(ns.shape) != (rows,))):
        raise ValueError("decode_enc: bases, lens or ns do not have one "
                         "entry per row of the group")
    for name, t, want in (
            *(("codes", c, dt) for c, _, _ in blocks),
            *(("excs", e, torch.int64) for _, e, _ in blocks),
            *(("slots", sl, torch.int32) for _, _, sl in blocks),
            ("bases", bases, word),
            *((("lens", lens, torch.int32),
               ("ns", ns, torch.int32)) if const else ())):
        if t.device.type != "cuda" or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"decode_enc: {name} must be a contiguous "
                             f"{want} CUDA tensor, got {t.dtype} on "
                             f"{t.device}")
    _require("decode_enc", pos, word)
    _require("decode_enc", delta, torch.int32)
    _one_device("decode_enc", bases, pos, delta,
                *(t for blk in blocks for t in blk))
    n = rows * cap
    if delta.shape != pos.shape or min(s_off, e_off) < 0 \
            or max(s_off, e_off) + n > pos.shape[0] \
            or abs(s_off - e_off) < n:
        raise ValueError("decode_enc: the group's start and end slots do "
                         "not fit the event buffer apart")
    if n == 0:
        return
    lib = _loaded()
    most = lib.pdt_decode_enc_max_blocks()
    ps, pd = pos.element_size(), delta.element_size()
    none = ctypes.c_void_p(0)
    r0 = 0
    for k in range(0, len(blocks), most):
        part = blocks[k:k + most]
        nb = len(part)
        part_rows = sum(c.shape[0] for c, _, _ in part)
        sub = slice(r0, r0 + part_rows)
        scratch = torch.empty(lib.pdt_decode_enc_scratch(part_rows, cap),
                              dtype=torch.int64, device=pos.device)
        vp = ctypes.c_void_p * nb
        s0, e0 = s_off + r0 * cap, e_off + r0 * cap
        _check("decode_enc", lib.pdt_decode_enc(
            pos.get_device(), tier, int(dt == torch.int16), int(const), nb,
            vp(*(c.data_ptr() for c, _, _ in part)),
            vp(*(e.data_ptr() for _, e, _ in part)),
            vp(*(sl.data_ptr() for _, _, sl in part)),
            (ctypes.c_int64 * nb)(*(c.shape[0] for c, _, _ in part)),
            ctypes.c_void_p(bases[sub].data_ptr()),
            ctypes.c_void_p(lens[sub].data_ptr()) if const else none,
            ctypes.c_void_p(ns[sub].data_ptr()) if const else none,
            cap, ce, ctypes.c_void_p(pos.data_ptr() + s0 * ps),
            ctypes.c_void_p(pos.data_ptr() + e0 * ps),
            ctypes.c_void_p(delta.data_ptr() + s0 * pd),
            ctypes.c_void_p(delta.data_ptr() + e0 * pd), _p(scratch),
            _stream(pos)))
        launches["decode_enc"] += 1
        r0 += part_rows


def _require_rows(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: Tuple[int, int]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor of "
                         f"shape {shape}, got {t.dtype} of shape "
                         f"{tuple(t.shape)}")


def shard_carry(pos2d: torch.Tensor, delta2d: torch.Tensor,
                bounds: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """K9's carry, in place, on one device's (rows, width) event block:
    each row's delta total past slot 0 (returned, (rows,) int64), the
    exclusive prefix of the totals from ``left``'s sum (the (L,) int64
    totals of the rows on earlier devices), each row's prefix cast to
    int32 into its delta slot 0 and ``bounds[r]`` into its position slot
    0. ``bounds`` is int64 with at least ``rows`` entries. One launch;
    the totals and the kernel's scratch are one allocation."""
    pos64 = _pos64("shard_carry", pos2d)
    if pos2d.dim() != 2:
        raise ValueError(f"shard_carry: needs a (rows, width) block, got "
                         f"shape {tuple(pos2d.shape)}")
    rows, width = pos2d.shape
    _require_rows("shard_carry", pos2d, pos2d.dtype, (rows, width))
    _require_rows("shard_carry", delta2d, torch.int32, (rows, width))
    _require("shard_carry", bounds, torch.int64)
    _require("shard_carry", left, torch.int64)
    _one_device("shard_carry", pos2d, delta2d, bounds, left)
    if width < 2 or bounds.shape[0] < rows:
        raise ValueError(f"shard_carry: {rows} rows of width {width} with "
                         f"{bounds.shape[0]} bounds")
    if rows == 0:
        return torch.empty(0, dtype=torch.int64, device=pos2d.device)
    # the totals, then the kernel's ticket and row sums
    buf = torch.empty(2 * rows + 1, dtype=torch.int64, device=pos2d.device)
    totals = buf[:rows]
    _check("shard_carry", _loaded().pdt_shard_carry(
        pos2d.get_device(), pos64, _p(pos2d), _p(delta2d), rows, width,
        _p(bounds), _p(left), left.shape[0], _p(totals), _p(buf[rows:]),
        _stream(pos2d)))
    launches["shard_carry"] += 1
    return totals


def eval_pair_rows(pos_s2: torch.Tensor, depth2: torch.Tensor,
                   c_cov2: torch.Tensor, c_sum2: torch.Tensor,
                   bounds: torch.Tensor, min_dep: int, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """K9's clipped eval: (cover, dsum) int64 per segment, the sum over
    the rows of Q(hi_r) - Q(lo_r) on row r's sweep state, where lo_r and
    hi_r are ``lo``/``hi`` (int64 global bounds) clipped to
    [bounds[r], bounds[r + 1]]; ``bounds`` non-decreasing (the engine's
    range cuts). (2, B), the rows (cover, dsum) of one buffer."""
    pos64 = _pos64("eval_pair_rows", pos_s2)
    if pos_s2.dim() != 2:
        raise ValueError(f"eval_pair_rows: needs (rows, width) rows, got "
                         f"shape {tuple(pos_s2.shape)}")
    shape = tuple(pos_s2.shape)
    rows, width = shape
    for t, dt in ((pos_s2, pos_s2.dtype), (depth2, torch.int32),
                  (c_cov2, torch.int64), (c_sum2, torch.int64)):
        _require_rows("eval_pair_rows", t, dt, shape)
    for t in (bounds, lo, hi):
        _require("eval_pair_rows", t, torch.int64)
    _one_device("eval_pair_rows", pos_s2, depth2, c_cov2, c_sum2, bounds,
                lo, hi)
    if rows == 0 or width == 0 or bounds.shape[0] != rows + 1 \
            or lo.shape != hi.shape:
        raise ValueError("eval_pair_rows: inconsistent rows, bounds or "
                         "query shapes")
    b = lo.shape[0]
    out = torch.empty((2, b), dtype=torch.int64, device=lo.device)
    if b:
        _check("eval_pair_rows", _loaded().pdt_eval_pair_rows(
            pos_s2.get_device(), pos64, _p(pos_s2), _p(depth2), _p(c_cov2),
            _p(c_sum2), rows, width, _p(bounds), int(min_dep), _p(lo),
            _p(hi), b, _p(out[0]), _p(out[1]), _stream(pos_s2)))
        launches["eval_pair_rows"] += 1
    return out


def bucket_events(pos: torch.Tensor, delta: torch.Tensor,
                  bounds: torch.Tensor, tier: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """K10's bucketing: the live events (delta != 0) of ``pos``/``delta``
    ordered by destination range, stable, where range r is
    [bounds[r], bounds[r + 1]) and positions past the last cut go to the
    last range. ``pos`` holds the tier's words (int32 for both 32-bit
    tiers, the uint32 tier's as bit patterns compared unsigned; int64),
    ``bounds`` the (world + 1,) int64 cuts. Returns (out_pos, out_delta)
    of the input's length, of which the first sum(counts) slots are
    defined, and each range's live count (int32) and delta sum (int64)."""
    word = torch.int64 if tier == TIER_I64 else torch.int32
    _require("bucket_events", pos, word)
    _require("bucket_events", delta, torch.int32)
    _require("bucket_events", bounds, torch.int64)
    _one_device("bucket_events", pos, delta, bounds)
    n, world = pos.shape[0], bounds.shape[0] - 1
    lib = _loaded()
    if delta.shape != pos.shape or n > (1 << 31) - 1 \
            or not 1 <= world <= lib.pdt_bucket_max_world():
        raise ValueError(f"bucket_events: {n} events, {delta.shape[0]} "
                         f"deltas, {world} ranges")
    dev = pos.device
    out_pos, out_delta = torch.empty_like(pos), torch.empty_like(delta)
    counts = torch.empty(world, dtype=torch.int32, device=dev)
    sums = torch.empty(world, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.pdt_bucket_events_scratch(n, world) if n else 0,
                          dtype=torch.int64, device=dev)
    _check("bucket_events", lib.pdt_bucket_events(
        pos.get_device(), tier, _p(pos), _p(delta), n, _p(bounds), world,
        _p(out_pos), _p(out_delta), _p(counts), _p(sums), _p(scratch),
        _stream(pos)))
    if n:
        launches["bucket_events"] += 1
    return out_pos, out_delta, counts, sums
