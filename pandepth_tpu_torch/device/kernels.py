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
from typing import Dict, Optional, Tuple

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
                            "eval_boundaries": 0, "decode_enc": 0}
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
        lib.pdt_sweep_scan_tile.restype = i64
        lib.pdt_sweep_scan_tile.argtypes = []
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
                                       ctypes.c_int, ctypes.c_int, vp, vp,
                                       vp, vp, vp, vp, i64, i64, i64, vp,
                                       vp, vp, vp, vp, vp]
        _lib = lib
        return lib


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
        lib = library()
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
               wrap18: bool, pos_max: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's arithmetic over sorted events: (depth int32, c_cov int64,
    c_sum int64), inclusive, the last piece measured against ``pos_max``
    (the tier's max)."""
    pos64 = _pos64("sweep_scan", pos_s)
    _require("sweep_scan", pos_s, pos_s.dtype)
    _require("sweep_scan", delta_s, torch.int32)
    if delta_s.shape != pos_s.shape:
        raise ValueError("sweep_scan: pos_s and delta_s differ in shape")
    n = pos_s.shape[0]
    dev = pos_s.device
    depth = torch.empty(n, dtype=torch.int32, device=dev)
    c_cov = torch.empty(n, dtype=torch.int64, device=dev)
    c_sum = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        lib = library()
        nblk = -(-n // lib.pdt_sweep_scan_tile())
        scratch = torch.empty(3 * nblk, dtype=torch.int64, device=dev)
        _check("sweep_scan", lib.pdt_sweep_scan(
            pos_s.get_device(), pos64, _p(pos_s), _p(delta_s), n,
            int(min_dep), int(bool(wrap18)), int(pos_max), _p(depth),
            _p(c_cov), _p(c_sum), _p(scratch), _stream(pos_s)))
        launches["sweep_scan"] += 1
    return depth, c_cov, c_sum


def eval_pair(pos_s: torch.Tensor, depth: torch.Tensor, c_cov: torch.Tensor,
              c_sum: torch.Tensor, min_dep: int, lo: torch.Tensor,
              hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (cover, dsum) int64 = Q(hi) - Q(lo) per segment; ``lo`` and
    ``hi`` in the dtype of ``pos_s``."""
    pos64 = _pos64("eval_pair", pos_s)
    for t in (pos_s, lo, hi):
        _require("eval_pair", t, pos_s.dtype)
    _require("eval_pair", depth, torch.int32)
    _require("eval_pair", c_cov, torch.int64)
    _require("eval_pair", c_sum, torch.int64)
    e = pos_s.shape[0]
    if not (depth.shape[0] == c_cov.shape[0] == c_sum.shape[0] == e) \
            or lo.shape != hi.shape or e == 0:
        raise ValueError("eval_pair: inconsistent sweep state or query "
                         "shapes")
    b = lo.shape[0]
    cover = torch.empty(b, dtype=torch.int64, device=lo.device)
    dsum = torch.empty(b, dtype=torch.int64, device=lo.device)
    if b:
        lib = library()
        _check("eval_pair", lib.pdt_eval_pair(
            pos_s.get_device(), pos64, _p(pos_s), _p(depth), _p(c_cov),
            _p(c_sum), e, int(min_dep), _p(lo), _p(hi), b, _p(cover),
            _p(dsum), _stream(pos_s)))
        launches["eval_pair"] += 1
    return cover, dsum


def eval_boundaries(pos_s: torch.Tensor, depth: torch.Tensor,
                    c_cov: torch.Tensor, c_sum: torch.Tensor, min_dep: int,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (Q_cov(x), Q_sum(x)) int64 per boundary; ``x`` in the dtype of
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
    q_cov = torch.empty(b, dtype=torch.int64, device=x.device)
    q_sum = torch.empty(b, dtype=torch.int64, device=x.device)
    if b:
        lib = library()
        _check("eval_boundaries", lib.pdt_eval_boundaries(
            pos_s.get_device(), pos64, _p(pos_s), _p(depth), _p(c_cov),
            _p(c_sum), e, int(min_dep), _p(x), b, _p(q_cov), _p(q_sum),
            _stream(pos_s)))
        launches["eval_boundaries"] += 1
    return q_cov, q_sum


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
    non-decreasing."""
    cols = (tid, pos, flag, mapq, op_code, op_len, op_read)
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
    if any(t.shape[0] != n for t in cols[1:4]) \
            or any(t.shape[0] != m for t in cols[5:]) \
            or limits.shape[0] != nt or (m and (n == 0 or nt == 0)):
        raise ValueError("extract_events: inconsistent batch shapes")
    dev = tid.device
    ev_pos = torch.empty(2 * m, dtype=pos_dtype, device=dev)
    ev_delta = torch.empty(2 * m, dtype=torch.int32, device=dev)
    if m:
        lib = library()
        nblk = -(-m // lib.pdt_sweep_scan_tile())
        scratch = torch.empty(m + n + nblk, dtype=torch.int64, device=dev)
        _check("extract_events", lib.pdt_extract_events(
            tid.get_device(), _p(tid), _p(pos), _p(flag), _p(mapq), n,
            _p(op_code), _p(op_len), _p(op_read), m, _p(offsets),
            _p(limits), nt, int(flags_mask), int(min_mapq),
            int(pos_dtype == torch.int64), int(sentinel), _p(ev_pos),
            _p(ev_delta), _p(scratch), _stream(tid)))
        launches["extract_events"] += 1
    return ev_pos, ev_delta


def _word(tier: int) -> torch.dtype:
    return torch.int32 if tier == TIER_I32 else torch.int64


def decode_enc(codes: torch.Tensor, excs: torch.Tensor, slots: torch.Tensor,
               bases: torch.Tensor, lens: Optional[torch.Tensor],
               ns: Optional[torch.Tensor], tier: int, pos: torch.Tensor,
               delta: torch.Tensor, s_off: int, e_off: int) -> None:
    """K8 on one stacked block of B windows, written in place into the
    event buffer ``pos``/``delta``: row r's CAP starts at
    ``pos[s_off + r * CAP:]`` and its ends at ``pos[e_off + r * CAP:]``,
    with +1 and -1 at the same slots of ``delta``.

    ``codes`` is (B, 2, CAP) in the mixed format or (B, CAP) in the const
    format (then ``lens`` and ``ns`` are (B,) int32), uint8, or uint16
    carried as its int16 bits; ``excs`` (int64) and ``slots`` (int32) are
    (B, 2, CE) or (B, CE); ``bases`` and ``pos`` are the tier's words."""
    const = codes.dim() == 2
    word = _word(tier)
    if codes.dtype not in (torch.uint8, torch.int16):
        raise ValueError(f"decode_enc: codes must be uint8 or int16 (uint16 "
                         f"bits), got {codes.dtype}")
    shape = tuple(codes.shape)
    if const != (lens is not None) or const != (ns is not None) \
            or not (const or (codes.dim() == 3 and shape[1] == 2)):
        raise ValueError(f"decode_enc: codes of shape {shape} need lens "
                         f"and ns exactly in the const format")
    rows, cap = shape[0], shape[-1]
    ce = excs.shape[-1]
    if tuple(excs.shape) != shape[:-1] + (ce,) \
            or slots.shape != excs.shape or tuple(bases.shape) != (rows,) \
            or (const and (tuple(lens.shape) != (rows,)
                           or tuple(ns.shape) != (rows,))):
        raise ValueError("decode_enc: inconsistent block shapes")
    for name, t, dt in (("codes", codes, codes.dtype),
                        ("excs", excs, torch.int64),
                        ("slots", slots, torch.int32),
                        ("bases", bases, word),
                        *((("lens", lens, torch.int32),
                           ("ns", ns, torch.int32)) if const else ())):
        if t.device.type != "cuda" or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"decode_enc: {name} must be a contiguous "
                             f"{dt} CUDA tensor, got {t.dtype} on "
                             f"{t.device}")
    _require("decode_enc", pos, word)
    _require("decode_enc", delta, torch.int32)
    _one_device("decode_enc", codes, excs, slots, bases, pos, delta)
    n = rows * cap
    if delta.shape != pos.shape or min(s_off, e_off) < 0 \
            or max(s_off, e_off) + n > pos.shape[0] \
            or abs(s_off - e_off) < n:
        raise ValueError("decode_enc: the block's start and end slots do "
                         "not fit the event buffer apart")
    if rows > 65535:
        raise ValueError(f"decode_enc: {rows} rows in one block (at most "
                         f"65535)")
    if n == 0:
        return
    lib = library()
    ntiles = -(-cap // lib.pdt_sweep_scan_tile())
    scratch = torch.empty(rows * ntiles, dtype=torch.int64,
                          device=pos.device)
    ps, pd = pos.element_size(), delta.element_size()
    none = ctypes.c_void_p(0)
    _check("decode_enc", lib.pdt_decode_enc(
        pos.get_device(), tier, int(codes.dtype == torch.int16), int(const),
        _p(codes), _p(excs), _p(slots), _p(bases),
        _p(lens) if const else none, _p(ns) if const else none, rows, cap,
        ce, ctypes.c_void_p(pos.data_ptr() + s_off * ps),
        ctypes.c_void_p(pos.data_ptr() + e_off * ps),
        ctypes.c_void_p(delta.data_ptr() + s_off * pd),
        ctypes.c_void_p(delta.data_ptr() + e_off * pd), _p(scratch),
        _stream(pos)))
    launches["decode_enc"] += 1
