"""ctypes bindings for libpancov_io (the C++ host decode library): the
port's own copy of ``pandepth_tpu/io/native``.

Builds the shared library on first use with the system g++ (the
toolchain is a baked-in dependency; pybind11 is not, so the library
exposes a plain C ABI). Set ``PANDEPTH_NO_NATIVE=1`` to force the pure
Python decoders.

The library builds to ``_build/libpancov_io_torch.so`` beside this file,
or under ``PANDEPTH_NATIVE_BUILD`` when that is set: its own file name,
so the JAX package's library in the same directory is never overwritten
(a process may load both; ``ctypes.CDLL`` keeps their symbols apart).
It is rebuilt when ``pancov_io.cpp`` is newer than it; deleting the file
forces a rebuild. ``host_finalize`` binds the native host sweep
(``pancov_host_finalize``) that the host engine runs
(``device/host_engine.py``). The one BAM decoder here is
:class:`NativeBamStream`, in bounded memory whatever the file's size
(the JAX package's whole-file reader and loader are not copied). The
stream's opt-in parallel record walk (the JAX package's
``PANDEPTH_PAR_WALK=1``) is left out of this copy of ``pancov_io.cpp``:
it measured slower than the serial walk, and it trusted each record's
length to fit the offsets it reserved.
Instead, a whole-file stream given the index's record starts
(``NativeBamStream(cuts=...)``) walks the splits between them on every
thread, each split read, inflated and walked by one thread, and checks
that each split ends on the next cut; a ranged stream
(``vranges=...``) walks runs of its ranges the same way, each range
checked to end on its chunk end.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pancov_io.cpp")
_LIB_DIR = os.environ.get("PANDEPTH_NATIVE_BUILD",
                          os.path.join(_HERE, "_build"))
_LIB = os.path.join(_LIB_DIR, "libpancov_io_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    os.makedirs(_LIB_DIR, exist_ok=True)
    base = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
            "-fPIC", "-o", _LIB, _SRC]
    # libdeflate decompresses BGZF ~2-3x faster than zlib; link it when
    # a system or vendored copy (PANDEPTH_LIBDEFLATE: a directory with
    # lib/libdeflate.a and include/) is available, else fall back to zlib
    attempts = []
    ld = os.environ.get("PANDEPTH_LIBDEFLATE")
    if ld and os.path.exists(os.path.join(ld, "lib", "libdeflate.a")):
        attempts.append(base + ["-DUSE_LIBDEFLATE",
                                f"-I{ld}/include", f"-L{ld}/lib",
                                "-ldeflate", "-lz", "-lpthread"])
    attempts.append(base + ["-DUSE_LIBDEFLATE", "-ldeflate", "-lz",
                            "-lpthread"])
    attempts.append(base + ["-lz", "-lpthread"])
    err = "no build attempts"
    for cmd in attempts:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            err = str(e)
            continue
        if r.returncode == 0:
            return None
        err = r.stderr[-2000:]
    return err


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load libpancov_io; None when unavailable."""
    global _lib, _build_error
    if os.environ.get("PANDEPTH_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_LIB) or (
                os.path.exists(_SRC) and
                os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(_LIB)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.pancov_stream_open.restype = ctypes.c_void_p
        lib.pancov_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        for name, res, args in [
            ("pancov_stream_wait", ctypes.c_int64, [ctypes.c_void_p]),
            ("pancov_stream_n_records", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_split_records", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_kept_records", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_read_bytes", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_progress", None,
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
              ctypes.POINTER(ctypes.c_int64),
              ctypes.POINTER(ctypes.c_int64)]),
            ("pancov_stream_error", None,
             [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
            ("pancov_stream_n_targets", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_name_len", ctypes.c_int64,
             [ctypes.c_void_p, ctypes.c_int64]),
            ("pancov_stream_name", None,
             [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]),
            ("pancov_stream_target_len", ctypes.c_int64,
             [ctypes.c_void_p, ctypes.c_int64]),
            ("pancov_stream_text_len", ctypes.c_int64,
             [ctypes.c_void_p]),
            ("pancov_stream_text", None,
             [ctypes.c_void_p, ctypes.c_char_p]),
            ("pancov_stream_close", None, [ctypes.c_void_p]),
            ("pancov_stream_wait_ns", ctypes.c_int64, [ctypes.c_void_p]),
        ]:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        lib.pancov_stream_take32.restype = None
        lib.pancov_stream_take32.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32]
        lib.pancov_stream_take64.restype = None
        lib.pancov_stream_take64.argtypes = [ctypes.c_void_p, i64p,
                                             i64p]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
        for enc_name, dp in (("pancov_stream_take_enc_acc", u8p),
                             ("pancov_stream_take_enc_acc16", u16p)):
            fn = getattr(lib, enc_name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, dp, dp, i64p, i64p, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
        lib.pancov_site_depth_write.restype = ctypes.c_int
        lib.pancov_site_depth_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, i32p,
            ctypes.c_int64, ctypes.c_int]
        lib.pancov_host_finalize.restype = ctypes.c_int64
        lib.pancov_host_finalize.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), i64p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            i64p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int,
            i64p, i64p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.pancov_win_rows_write.restype = ctypes.c_int
        lib.pancov_win_rows_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, i64p, i64p,
            i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.pancov_id_rows_write.restype = ctypes.c_int
        lib.pancov_id_rows_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, i64p, i64p,
            u8p, i64p, i64p, i64p, i64p, i64p, ctypes.c_int64,
            ctypes.c_int]
        lib.pancov_fasta_gc_load.restype = ctypes.c_void_p
        lib.pancov_fasta_gc_load.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.pancov_fasta_gc_count.restype = ctypes.c_int64
        lib.pancov_fasta_gc_count.argtypes = [ctypes.c_void_p]
        lib.pancov_fasta_gc_len.restype = ctypes.c_int64
        lib.pancov_fasta_gc_len.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int64]
        lib.pancov_fasta_gc_name.restype = ctypes.c_int
        lib.pancov_fasta_gc_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int]
        lib.pancov_fasta_gc_packed_size.restype = ctypes.c_int64
        lib.pancov_fasta_gc_packed_size.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int64]
        lib.pancov_fasta_gc_copy.restype = None
        lib.pancov_fasta_gc_copy.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int64, u8p]
        lib.pancov_fasta_gc_free.restype = None
        lib.pancov_fasta_gc_free.argtypes = [ctypes.c_void_p]
        lib.pancov_itf8_decode_all.restype = ctypes.c_int64
        lib.pancov_itf8_decode_all.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i32p, i64p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.pancov_rans_decode.restype = ctypes.c_int
        lib.pancov_rans_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                           ctypes.c_int64]
        lib.pancov_paf_load.restype = ctypes.c_void_p
        lib.pancov_paf_load.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, ctypes.c_char_p, ctypes.c_int]
        lib.pancov_sam_load.restype = ctypes.c_void_p
        lib.pancov_sam_load.argtypes = lib.pancov_paf_load.argtypes
        lib.pancov_paf_contigs.restype = ctypes.c_void_p
        lib.pancov_paf_contigs.argtypes = [ctypes.c_char_p,
                                           ctypes.c_char_p,
                                           ctypes.c_int]
        lib.pancov_paf_contigs_count.restype = ctypes.c_int64
        lib.pancov_paf_contigs_count.argtypes = [ctypes.c_void_p]
        lib.pancov_paf_contigs_blob_len.restype = ctypes.c_int64
        lib.pancov_paf_contigs_blob_len.argtypes = [ctypes.c_void_p]
        lib.pancov_paf_contigs_blob.restype = None
        lib.pancov_paf_contigs_blob.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
        lib.pancov_paf_contigs_lens.restype = None
        lib.pancov_paf_contigs_lens.argtypes = [ctypes.c_void_p, i64p]
        lib.pancov_paf_contigs_free.restype = None
        lib.pancov_paf_contigs_free.argtypes = [ctypes.c_void_p]
        lib.pancov_targets_load.restype = ctypes.c_void_p
        lib.pancov_targets_load.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p,
            ctypes.c_char_p, ctypes.c_int]
        lib.pancov_targets_n.restype = ctypes.c_int64
        lib.pancov_targets_n.argtypes = [ctypes.c_void_p]
        lib.pancov_targets_ids_len.restype = ctypes.c_int64
        lib.pancov_targets_ids_len.argtypes = [ctypes.c_void_p]
        lib.pancov_targets_max_id_len.restype = ctypes.c_int64
        lib.pancov_targets_max_id_len.argtypes = [ctypes.c_void_p]
        lib.pancov_targets_fill_ids_fixed.restype = None
        lib.pancov_targets_fill_ids_fixed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        lib.pancov_targets_fill.restype = None
        lib.pancov_targets_fill.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        lib.pancov_targets_close.restype = None
        lib.pancov_targets_close.argtypes = [ctypes.c_void_p]
        lib.pancov_paf_n_events.restype = ctypes.c_int64
        lib.pancov_paf_n_events.argtypes = [ctypes.c_void_p]
        lib.pancov_paf_n_lines.restype = ctypes.c_int64
        lib.pancov_paf_n_lines.argtypes = [ctypes.c_void_p]
        lib.pancov_paf_events32.restype = None
        lib.pancov_paf_events32.argtypes = [ctypes.c_void_p, i32p, i32p,
                                            ctypes.c_int64,
                                            ctypes.c_int32]
        lib.pancov_paf_events64.restype = None
        lib.pancov_paf_events64.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.pancov_paf_close.restype = None
        lib.pancov_paf_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    return _build_error


def itf8_decode_all(buf: bytes):
    """(values int32, token_offsets int64) for a whole ITF8 stream, or
    None when the native library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    n = len(buf)
    arr = np.frombuffer(buf, np.uint8)
    cap = max(n, 1)
    vals = np.empty(cap, np.int32)
    offs = np.empty(cap, np.int64)
    used = ctypes.c_int64(0)
    k = lib.pancov_itf8_decode_all(arr, n, cap, vals, offs,
                                   ctypes.byref(used))
    return vals[:k], offs[:k]


def host_finalize(chunks, sentinel32: int, extra_pos, extra_delta,
                  qlo, qhi, min_dep: int, wrap18: bool,
                  keep_state: bool, nthreads: Optional[int] = None):
    """Native host event-sweep finalize (C++ twin of the device
    sort+sweep+eval; see pancov_io.cpp pancov_host_finalize).

    ``chunks``: list of equal-length (starts, ends) uint32-viewable
    arrays (sentinel-slot padded); ``extra_pos/extra_delta``: optional
    pre-built (u32 pos, int32 delta) events. Returns (cover int64,
    dsum int64, state) where state is (pos_s int64, depth int32) when
    ``keep_state`` else None; or None when the native library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    # 32-bit position tier only: viewing an int64 array as uint32
    # would split every position into two bogus events and corrupt
    # results silently — callers on the int64 tier (> 4 Gb padded
    # genomes) get None and take the 2 Gb slabs of
    # device/hosteval._finalize_events_slabbed
    for s, e in chunks:
        if s.dtype.itemsize != 4 or e.dtype.itemsize != 4:
            return None
    if extra_pos is not None and \
            np.asarray(extra_pos).dtype.itemsize != 4:
        return None
    n_c = len(chunks)
    sv = (ctypes.c_void_p * max(n_c, 1))()
    ev_ = (ctypes.c_void_p * max(n_c, 1))()
    pn = np.zeros(max(n_c, 1), np.int64)
    total_pairs = 0
    for i, (s, e) in enumerate(chunks):
        s = np.ascontiguousarray(s).view(np.uint32)
        e = np.ascontiguousarray(e).view(np.uint32)
        chunks[i] = (s, e)  # keep the views alive through the call
        assert s.shape[0] == e.shape[0]
        sv[i] = s.ctypes.data
        ev_[i] = e.ctypes.data
        pn[i] = s.shape[0]
        total_pairs += s.shape[0]
    if extra_pos is None:
        extra_pos = np.zeros(0, np.uint32)
        extra_delta = np.zeros(0, np.int32)
    xp = np.ascontiguousarray(extra_pos).view(np.uint32)
    xd = np.ascontiguousarray(extra_delta, np.int32)
    qlo = np.ascontiguousarray(qlo, np.int64)
    qhi = np.ascontiguousarray(qhi, np.int64)
    nq = qlo.shape[0]
    cover = np.empty(max(nq, 1), np.int64)
    dsum = np.empty(max(nq, 1), np.int64)
    cap = 2 * total_pairs + xp.shape[0]
    if keep_state:
        out_pos = np.empty(max(cap, 1), np.int64)
        out_depth = np.empty(max(cap, 1), np.int32)
        op, od = out_pos.ctypes.data, out_depth.ctypes.data
    else:
        out_pos = out_depth = None
        op = od = None
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, 8)
    rc = lib.pancov_host_finalize(
        n_c, sv, ev_, pn, ctypes.c_uint32(sentinel32 & 0xFFFFFFFF),
        xp.ctypes.data, xd.ctypes.data, xp.shape[0],
        qlo, qhi, nq, min_dep, 1 if wrap18 else 0,
        cover, dsum, 1 if keep_state else 0, op, od, nthreads)
    if rc < 0:
        raise ValueError(f"pancov_host_finalize failed ({rc})")
    state = (out_pos[:rc], out_depth[:rc]) if keep_state else None
    return cover[:nq], dsum[:nq], state


def rans_decode_native(data: bytes, out_size: int) -> Optional[bytes]:
    lib = load_library()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(out_size, 1), np.uint8)
    rc = lib.pancov_rans_decode(src, len(data), out, out_size)
    if rc != 0:
        raise ValueError(f"rANS decode failed ({rc})")
    return out[:out_size].tobytes()


class NativePafLoad:
    """One-shot PAF(.gz) (or SAM with kind='sam') parse to clamped
    global depth intervals."""

    def __init__(self, path: str, flags_mask: int, min_mapq: int,
                 names, offsets: np.ndarray, limits: np.ndarray,
                 kind: str = "paf"):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                f"libpancov_io unavailable: {build_error()}")
        self._lib = lib
        blob = b"\x00".join(n.encode() for n in names) + b"\x00"
        off = np.ascontiguousarray(offsets, np.int64)
        lim = np.ascontiguousarray(limits, np.int64)
        self._keep = (off, lim)
        err = ctypes.create_string_buffer(256)
        fn = lib.pancov_sam_load if kind == "sam" else \
            lib.pancov_paf_load
        self._h = fn(path.encode(), flags_mask, min_mapq, blob,
                     len(blob), len(names), off, lim, err, len(err))
        if not self._h:
            raise ValueError(
                f"pancov_{kind}_load({path}): {err.value.decode()}")
        self.n_events = int(lib.pancov_paf_n_events(self._h))
        self.n_lines = int(lib.pancov_paf_n_lines(self._h))

    def events32_padded(self, cap: int, sentinel: int):
        cap = max(cap, self.n_events, 1)
        s = np.empty(cap, np.int32)
        e = np.empty(cap, np.int32)
        self._lib.pancov_paf_events32(self._h, s, e, cap, sentinel)
        return s, e

    def events64(self):
        m = self.n_events
        s = np.empty(max(m, 1), np.int64)
        e = np.empty(max(m, 1), np.int64)
        if m:
            self._lib.pancov_paf_events64(self._h, s, e)
        return s[:m], e[:m]

    def close(self) -> None:
        if self._h:
            self._lib.pancov_paf_close(self._h)
            self._h = None


class NativeTargetsLoad:
    """One-shot GFF/GTF/BED(.gz) target-row tokenize to columnar
    (tid, start1, end1, gene-id) arrays; merge semantics stay in
    targets/model.py (GeneAccumulator.add_bulk). ``mode`` uses the
    config.MODE_* codes (1 GFF, 2 GTF, 3 BED3, 4 BED4)."""

    def __init__(self, path: str, feature: str, mode: int,
                 chr2tid: dict):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                f"libpancov_io unavailable: {build_error()}")
        self._lib = lib
        names = list(chr2tid.keys())
        blob = b"\x00".join(n.encode() for n in names) + b"\x00"
        tids = np.ascontiguousarray(
            [chr2tid[n] for n in names], np.int64)
        err = ctypes.create_string_buffer(256)
        self._h = lib.pancov_targets_load(
            path.encode(), feature.encode(), mode, blob, len(blob),
            len(names), tids, err, len(err))
        if not self._h:
            raise ValueError(
                f"pancov_targets_load({path}): {err.value.decode()}")
        self.n = int(lib.pancov_targets_n(self._h))

    def columns(self):
        """(tid, start1, end1, ids) numpy arrays; ids is a fixed-width
        'S<w>' array (zero-padded by the native fill)."""
        n = self.n
        tid = np.empty(max(n, 1), np.int64)
        s = np.empty(max(n, 1), np.int64)
        e = np.empty(max(n, 1), np.int64)
        off = np.zeros(n + 1, np.int64)
        ids_len = int(self._lib.pancov_targets_ids_len(self._h))
        ids = np.empty(max(ids_len, 1), np.uint8)
        self._lib.pancov_targets_fill(self._h, tid, s, e, off, ids)
        w = max(int(self._lib.pancov_targets_max_id_len(self._h)), 1)
        fixed = np.zeros(max(n, 1) * w, np.uint8)
        self._lib.pancov_targets_fill_ids_fixed(self._h, w, fixed)
        ids_s = fixed.view(f"S{w}")
        return tid[:n], s[:n], e[:n], ids_s[:n]

    def close(self) -> None:
        if self._h:
            self._lib.pancov_targets_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBamStream:
    """Bounded-memory streaming load: the producer thread reads,
    inflates (parallel) and walks one compressed window at a time;
    the consumer pulls each window's coverage events while the next
    window inflates. Peak RSS is O(window), so files many times host
    RAM stream fine (the reference's htslib-streaming + 10 Mb window
    memory model, src/PanDepth.cpp:676-723, re-done TPU-side).

    ``vranges``: the index's (v0, v1) ranges for a mode-1 region
    filter; the stream reads only them, each from its first block to the
    end of its end block. ``cuts``: record-start virtual offsets from the
    index: for a whole-file stream (no ``regions``, no ``vranges``) its
    record starts (``bamindex.record_starts``), for a ranged one its
    chunks' starts (``bamindex.window_chunks``), which cut a range longer
    than a split. Either way a BGZF BAM is walked in splits on every
    thread (runs of ranges, or the spans between cuts), handed out in
    file order; a split that does not end where the index says (an index
    that does not match the file) hands the rest of the stream to the
    serial walk. ``serial`` walks the whole stream serially, as with no
    index. :meth:`split_share` says how much went through splits."""

    def __init__(self, path: str, flags_mask: int, min_mapq: int,
                 pad: int = 512, threads: int = 0,
                 ext_offsets: Optional[np.ndarray] = None,
                 ext_limits: Optional[np.ndarray] = None,
                 regions=None, vranges: Optional[np.ndarray] = None,
                 window_bytes: int = 0,
                 cuts: Optional[np.ndarray] = None,
                 serial: bool = False):
        from pandepth_tpu_torch.io.bam import BamHeader

        lib = load_library()
        if lib is None:
            raise RuntimeError(
                f"libpancov_io unavailable: {build_error()}")
        self._lib = lib
        if threads <= 0:
            threads = min(os.cpu_count() or 1, 16)
        if window_bytes <= 0:
            # 8 MB compressed windows: small enough that the encoded
            # device uploads pipeline behind the producer (several
            # windows in flight per second), large enough that the
            # parallel inflate has hundreds of BGZF blocks per cycle
            window_bytes = int(os.environ.get(
                "PANDEPTH_STREAM_WINDOW", 8 << 20))
        err = ctypes.create_string_buffer(256)
        keep = []
        if ext_offsets is not None:
            eo = np.ascontiguousarray(ext_offsets, np.int64)
            el = np.ascontiguousarray(ext_limits, np.int64)
            keep += [eo, el]
            op, lp, ne = eo.ctypes.data, el.ctypes.data, eo.shape[0]
        else:
            op = lp = None
            ne = 0
        if regions is not None:
            ro = np.ascontiguousarray(regions[0], np.int64)
            rs = np.ascontiguousarray(regions[1], np.int64)
            re_ = np.ascontiguousarray(regions[2], np.int64)
            rmode = int(regions[3])
            keep += [ro, rs, re_]
            rop, rsp, rep, nr = (ro.ctypes.data, rs.ctypes.data,
                                 re_.ctypes.data, rs.shape[0])
        else:
            rop = rsp = rep = None
            nr = 0
            rmode = 0
        if vranges is not None and len(vranges):
            vrr = np.ascontiguousarray(vranges, np.int64).reshape(-1)
            keep.append(vrr)
            vrp, nvr = vrr.ctypes.data, vrr.shape[0] // 2
        else:
            vrp, nvr = None, 0
        if cuts is not None and len(cuts):
            cta = np.ascontiguousarray(cuts, np.int64)
            keep.append(cta)
            ctp, nct = cta.ctypes.data, cta.shape[0]
        else:
            ctp, nct = None, 0
        self._h = lib.pancov_stream_open(
            path.encode(), threads, flags_mask, min_mapq, pad, op, lp,
            ne, rop, rsp, rep, nr, rmode, vrp, nvr, ctp, nct,
            int(serial), window_bytes, err, len(err))
        del keep  # the C side copies region/layout/cut arrays
        if not self._h:
            raise ValueError(
                f"pancov_stream_open({path}): {err.value.decode()}")
        self._size = os.path.getsize(path)
        n = lib.pancov_stream_n_targets(self._h)
        names = []
        lengths = np.zeros(n, np.int64)
        for i in range(n):
            ln = lib.pancov_stream_name_len(self._h, i)
            buf = ctypes.create_string_buffer(max(ln, 1))
            lib.pancov_stream_name(self._h, i, buf)
            names.append(buf.raw[:ln].decode())
            lengths[i] = lib.pancov_stream_target_len(self._h, i)
        tl = lib.pancov_stream_text_len(self._h)
        tbuf = ctypes.create_string_buffer(max(tl, 1))
        if tl:
            lib.pancov_stream_text(self._h, tbuf)
        self.header = BamHeader(text=tbuf.raw[:tl].decode("utf-8",
                                                          "replace"),
                                names=names, lengths=lengths)

    def wait(self) -> int:
        """Block for the next window; its event count, or -1 at EOF."""
        n = int(self._lib.pancov_stream_wait(self._h))
        if n == -2:
            err = ctypes.create_string_buffer(256)
            self._lib.pancov_stream_error(self._h, err, len(err))
            raise ValueError(
                f"pancov stream: {err.value.decode() or 'error'}")
        return n

    def take32(self, cap: int, sentinel: int):
        s = np.empty(cap, np.int32)
        e = np.empty(cap, np.int32)
        self._lib.pancov_stream_take32(self._h, s, e, cap, sentinel)
        return s, e

    def take64(self, n: int):
        # always call through: the C side also RELEASES the window
        # (an empty window must still be consumed or wait() spins)
        s = np.empty(max(n, 1), np.int64)
        e = np.empty(max(n, 1), np.int64)
        self._lib.pancov_stream_take64(self._h, s, e)
        return s[:n], e[:n]

    def _take_acc(self, fn, dtype, cap: int, exc_cap: int):
        dd = np.empty(cap, dtype)
        ll = np.empty(cap, dtype)
        excd = np.empty(exc_cap, np.int64)
        excl = np.empty(exc_cap, np.int64)
        base = ctypes.c_int64(0)
        nd = ctypes.c_int64(0)
        nl = ctypes.c_int64(0)
        n = int(fn(self._h, dd, ll, excd, excl, cap, exc_cap,
                   ctypes.byref(base), ctypes.byref(nd),
                   ctypes.byref(nl)))
        if n == -2:
            err = ctypes.create_string_buffer(256)
            self._lib.pancov_stream_error(self._h, err, len(err))
            raise ValueError(
                f"pancov stream: {err.value.decode() or 'error'}")
        # exc saturation signal: the caller upgrades to the 16-bit
        # tier when a short buffer maxed an escape list
        self.last_nd, self.last_nl = int(nd.value), int(nl.value)
        if n == 0:
            return None
        return n, dd, ll, excd, excl, int(base.value)

    def take_enc_acc(self, cap: int, exc_cap: int):
        """Compact-encode (start, end) pairs (~2 B/pair over the device
        link vs 8), filling the whole cap-size buffer ACROSS windows
        (blocking on the producer), so device buffers stay full and sort
        padding stays O(1/K). Returns (n, d8, l8, excd, excl, base) with
        fixed-shape zero-tailed buffers, or None at clean EOF;
        escape-heavy inputs yield partial buffers. Positions are full
        int64."""
        return self._take_acc(self._lib.pancov_stream_take_enc_acc,
                              np.uint8, cap, exc_cap)

    def take_enc_acc16(self, cap: int, exc_cap: int):
        """16-bit-code variant (4 B/pair): zigzag deltas to +-32766
        and lengths to 65534 inline — the sparse-coverage tier where
        typical start gaps overflow the 8-bit codes."""
        return self._take_acc(self._lib.pancov_stream_take_enc_acc16,
                              np.uint16, cap, exc_cap)

    @property
    def n_records(self) -> int:
        return int(self._lib.pancov_stream_n_records(self._h))

    def split_share(self) -> float:
        """The share of the records handed out so far that were walked
        in splits (index-cut or ranged): 1.0 when every split ended where
        the index says, 0.0 for a serial stream (or one without
        records)."""
        split = int(self._lib.pancov_stream_split_records(self._h))
        n = self.n_records  # read second: never below ``split``
        return split / n if n else 0.0

    def kept_share(self) -> float:
        """The share of the records handed out so far that the ``-x``/``-q``
        and region filters kept (0.0 for a stream without records)."""
        kept = int(self._lib.pancov_stream_kept_records(self._h))
        n = self.n_records  # read second: never below ``kept``
        return kept / n if n else 0.0

    def read_share(self) -> float:
        """The compressed bytes the walk has read so far over the file's
        size: the header's blocks and every block walked, a ranged walk's
        from each range's first block to the end of its end block (1.0
        once a whole-file walk has ended)."""
        return int(self._lib.pancov_stream_read_bytes(self._h)) / \
            self._size if self._size else 0.0

    def wait_seconds(self) -> float:
        """Seconds the consumer blocked on the producer's queue (in
        :meth:`wait` and the ``take_enc_acc`` pulls) since the last call;
        the count starts anew."""
        return int(self._lib.pancov_stream_wait_ns(self._h)) * 1e-9

    def progress(self):
        """(fraction consumed, event pairs produced) of the PRODUCER
        walk — both producer-side so their ratio projects the final
        pair total consistently (consumer-side window counts lag the
        read-ahead and under-project). The fraction is an estimate:
        a ranged walk counts each range up to its end block's start.
        Fraction is 0.0 when the total is unknown."""
        done = ctypes.c_int64(0)
        total = ctypes.c_int64(0)
        pairs = ctypes.c_int64(0)
        self._lib.pancov_stream_progress(self._h, ctypes.byref(done),
                                         ctypes.byref(total),
                                         ctypes.byref(pairs))
        frac = min(done.value / total.value, 1.0) \
            if total.value > 0 else 0.0
        return frac, int(pairs.value)

    def close(self) -> None:
        if self._h:
            self._lib.pancov_stream_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

