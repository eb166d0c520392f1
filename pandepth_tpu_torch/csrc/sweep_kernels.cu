// Hand-written Hopper (sm_90a) kernels for the coverage sweep, the
// CIGAR-extraction feed and the encoded-window decode.
//
// Plain C interface, built with nvcc and loaded with ctypes by
// pandepth_tpu_torch/device/kernels.py. Every entry point launches on
// the caller's stream, allocates nothing (the wrapper passes outputs
// and scratch), never synchronises, and returns cudaGetLastError()
// (0 = launched).
//
// Position tiers (pandepth_tpu/device/hosteval.py:pos_dtype_for):
//   TIER_I32  int32 positions, sentinel INT32_MAX
//   TIER_U32  uint32 positions carried on the device as zero-extended
//             int64 (PyTorch has no uint32 arithmetic), sentinel and
//             "tier max" 0xFFFFFFFF
//   TIER_I64  int64 positions, sentinel INT64_MAX
// Positions are non-negative and a difference is only ever taken of a
// position and one at or above it, so no tier's subtraction wraps and
// int64 differences equal the JAX functions' differences in their
// position dtype: every output is array-equal to the JAX package's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TIER_I32 = 0;
constexpr int TIER_U32 = 1;
constexpr int TIER_I64 = 2;

constexpr int THREADS = 256;            // threads per block in the scans
constexpr int ITEMS = 8;                // consecutive elements per thread
constexpr int TILE = THREADS * ITEMS;   // elements per scan block
constexpr int TOTALS_THREADS = 1024;    // the one-block scan of totals
constexpr int POINT_THREADS = 256;      // pack_events / eval_pair
constexpr int32_t WRAP18_MASK = 0x3FFFF;

typedef unsigned long long u64;

// ---------------------------------------------------------------------
// block-wide scan helpers (warp shuffles, one shared slot per warp)

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// Exclusive scan of one value per thread across the block; unsigned T
// so that sums wrap like the JAX int32/int64 cumsums. blockDim.x must be
// a multiple of 32. All threads must call it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* warp_tot, T* block_total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    T x = warp_inclusive_scan(v);
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T w = lane < nwarps ? warp_tot[lane] : T(0);
        w = warp_inclusive_scan(w);
        if (lane < nwarps) warp_tot[lane] = w;
    }
    __syncthreads();
    T excl = (warp > 0 ? warp_tot[warp - 1] : T(0)) + x - v;
    *block_total = warp_tot[nwarps - 1];
    __syncthreads();  // warp_tot is reused by the next call
    return excl;
}

// ---------------------------------------------------------------------
// K1 pack_events — replaces pandepth_tpu/device/engine.py:_pack_events.
// Bound on the H100: memory. It reads 2M raw position words (4 or 8 B)
// and writes 2M positions (4 or 8 B) plus 2M int32 deltas, with no
// reuse: 12-20 B per event. One thread per output slot, consecutive
// threads on consecutive addresses, so every load and store coalesces;
// the JAX concat becomes index arithmetic (slot i < m reads starts,
// else ends), and the uint32 tier's zero-extension to int64 rides the
// same pass instead of a separate cast.
template <typename In, typename Out>
__global__ void pack_events_kernel(const In* __restrict__ starts,
                                   const In* __restrict__ ends, int64_t m,
                                   Out sentinel, Out* __restrict__ pos,
                                   int32_t* __restrict__ delta) {
    const int64_t n = 2 * m;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const bool is_end = i >= m;
        const Out p = (Out)(is_end ? ends[i - m] : starts[i]);
        pos[i] = p;
        const int32_t live = p < sentinel ? 1 : 0;
        delta[i] = is_end ? -live : live;
    }
}

// ---------------------------------------------------------------------
// K2 sweep_scan — replaces the arithmetic of
// pandepth_tpu/device/sweep.py:sort_events (the sort itself stays a
// library sort, as it was an XLA primitive).
// Bound on the H100: memory. Per event it reads delta (4 B) twice and
// pos (4-8 B) once, and writes depth (4 B), c_cov and c_sum (8 B each)
// and then re-reads and re-writes c_cov/c_sum for the carry: ~60 B per
// event, ~1 GB at 16.8M events. The design is a multi-pass block scan:
//   1. per-block delta totals            (delta_block_totals_kernel)
//   2. one-block exclusive scan of them  (exclusive_scan_one_block)
//   3. per-block depth with its carry, then plen and plen*depth and
//      their in-block inclusive prefixes + block totals
//                                         (scan_depth_kernel)
//   4. one-block exclusive scans of the two total arrays
//   5. carry add                          (add_carry_kernel)
// Decoupled look-back would fold this into one pass; that is later work.

__global__ void delta_block_totals_kernel(const int32_t* __restrict__ delta,
                                          int64_t n,
                                          uint32_t* __restrict__ tot) {
    __shared__ uint32_t warp_tot[32];
    const int64_t base = (int64_t)blockIdx.x * TILE;
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + (int64_t)k * THREADS + threadIdx.x;
        if (i < n) s += (uint32_t)delta[i];
    }
    uint32_t block_total;
    block_exclusive_scan<uint32_t>(s, warp_tot, &block_total);
    if (threadIdx.x == 0) tot[blockIdx.x] = block_total;
}

// In-place exclusive scan of n values by ONE block of TOTALS_THREADS.
template <typename T>
__global__ void exclusive_scan_one_block(T* __restrict__ a, int64_t n) {
    __shared__ T warp_tot[32];
    T carry = 0;
    for (int64_t b = 0; b < n; b += blockDim.x) {
        const int64_t i = b + threadIdx.x;
        const T v = i < n ? a[i] : T(0);
        T chunk_total;
        const T ex = block_exclusive_scan<T>(v, warp_tot, &chunk_total);
        if (i < n) a[i] = carry + ex;
        carry += chunk_total;
    }
}

template <typename P>
__global__ void scan_depth_kernel(const P* __restrict__ pos,
                                  const int32_t* __restrict__ delta,
                                  int64_t n,
                                  const uint32_t* __restrict__ delta_carry,
                                  int32_t min_dep, int wrap18, P pmax,
                                  int32_t* __restrict__ depth,
                                  u64* __restrict__ c_cov,
                                  u64* __restrict__ c_sum,
                                  u64* __restrict__ cov_tot,
                                  u64* __restrict__ sum_tot) {
    __shared__ uint32_t warp32[32];
    __shared__ u64 warp64[32];
    const int64_t base = (int64_t)blockIdx.x * TILE
                         + (int64_t)threadIdx.x * ITEMS;
    uint32_t d[ITEMS];
    uint32_t thread_dsum = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k;
        d[k] = i < n ? (uint32_t)delta[i] : 0u;
        thread_dsum += d[k];
    }
    uint32_t block_dsum;
    uint32_t run = block_exclusive_scan<uint32_t>(thread_dsum, warp32,
                                                  &block_dsum)
                   + delta_carry[blockIdx.x];

    u64 plen[ITEMS];
    u64 pdep[ITEMS];
    u64 thread_cov = 0;
    u64 thread_sum = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k;
        run += d[k];
        int32_t dep = (int32_t)run;  // jnp.cumsum(..., dtype=int32)
        if (wrap18) dep &= WRAP18_MASK;
        u64 len = 0;
        if (i < n) {
            depth[i] = dep;
            if (dep >= min_dep) {
                const P nxt = i + 1 < n ? pos[i + 1] : pmax;
                len = (u64)((int64_t)nxt - (int64_t)pos[i]);
            }
        }
        plen[k] = len;
        pdep[k] = len * (u64)(int64_t)dep;
        thread_cov += plen[k];
        thread_sum += pdep[k];
    }
    u64 block_cov, block_sum;
    u64 cov = block_exclusive_scan<u64>(thread_cov, warp64, &block_cov);
    u64 sum = block_exclusive_scan<u64>(thread_sum, warp64, &block_sum);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k;
        cov += plen[k];
        sum += pdep[k];
        if (i < n) {
            c_cov[i] = cov;
            c_sum[i] = sum;
        }
    }
    if (threadIdx.x == 0) {
        cov_tot[blockIdx.x] = block_cov;
        sum_tot[blockIdx.x] = block_sum;
    }
}

__global__ void add_carry_kernel(int64_t n, const u64* __restrict__ cov_tot,
                                 const u64* __restrict__ sum_tot,
                                 u64* __restrict__ c_cov,
                                 u64* __restrict__ c_sum) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t blk = i / TILE;
    c_cov[i] += cov_tot[blk];
    c_sum[i] += sum_tot[blk];
}

// ---------------------------------------------------------------------
// K3 eval_pair — replaces pandepth_tpu/device/sweep.py:eval_pair.
// Bound on the H100: memory latency, not bandwidth. Each segment does
// two lower-bound binary searches over pos_s (log2(E) ~ 24 dependent
// loads each at 16.8M events) and four gathers; with ~300 segments the
// work is tiny and the launch plus the dependent-load chain set the
// time. One thread per segment, lo and hi in the same thread, so the
// whole batch is one launch and the searches of different segments
// overlap across warps; the upper levels of the search tree stay in L2.

template <typename P>
__device__ __forceinline__ void q_eval(const P* __restrict__ pos,
                                       const int32_t* __restrict__ depth,
                                       const int64_t* __restrict__ c_cov,
                                       const int64_t* __restrict__ c_sum,
                                       int64_t e, int32_t min_dep, P x,
                                       u64* q_cov, u64* q_sum) {
    int64_t lo = 0, hi = e;  // r = first index with pos[r] >= x
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (pos[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    const int64_t r = lo;
    u64 cov = r >= 2 ? (u64)c_cov[r - 2] : 0;
    u64 sum = r >= 2 ? (u64)c_sum[r - 2] : 0;
    if (r >= 1) {
        const int32_t dep = depth[r - 1];
        const u64 part = dep >= min_dep
                             ? (u64)((int64_t)x - (int64_t)pos[r - 1]) : 0;
        cov += part;
        sum += part * (u64)(int64_t)dep;
    }
    *q_cov = cov;
    *q_sum = sum;
}

template <typename P>
__global__ void eval_pair_kernel(const P* __restrict__ pos,
                                 const int32_t* __restrict__ depth,
                                 const int64_t* __restrict__ c_cov,
                                 const int64_t* __restrict__ c_sum,
                                 int64_t e, int32_t min_dep,
                                 const P* __restrict__ lo,
                                 const P* __restrict__ hi, int64_t b,
                                 int64_t* __restrict__ cover,
                                 int64_t* __restrict__ dsum) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    u64 cov_lo, sum_lo, cov_hi, sum_hi;
    q_eval<P>(pos, depth, c_cov, c_sum, e, min_dep, lo[i], &cov_lo, &sum_lo);
    q_eval<P>(pos, depth, c_cov, c_sum, e, min_dep, hi[i], &cov_hi, &sum_hi);
    cover[i] = (int64_t)(cov_hi - cov_lo);
    dsum[i] = (int64_t)(sum_hi - sum_lo);
}

// ---------------------------------------------------------------------
// K5 eval_boundaries — replaces pandepth_tpu/device/sweep.py:
// eval_boundaries. The one-sided half of K3: (Q_cov(x), Q_sum(x)) per
// boundary, through the same q_eval search and integral. Bound by the
// same dependent-load chain as K3; one thread per boundary.

template <typename P>
__global__ void eval_boundaries_kernel(const P* __restrict__ pos,
                                       const int32_t* __restrict__ depth,
                                       const int64_t* __restrict__ c_cov,
                                       const int64_t* __restrict__ c_sum,
                                       int64_t e, int32_t min_dep,
                                       const P* __restrict__ x, int64_t b,
                                       int64_t* __restrict__ q_cov,
                                       int64_t* __restrict__ q_sum) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    u64 cov, sum;
    q_eval<P>(pos, depth, c_cov, c_sum, e, min_dep, x[i], &cov, &sum);
    q_cov[i] = (int64_t)cov;
    q_sum[i] = (int64_t)sum;
}

// ---------------------------------------------------------------------
// K6 extract_events — replaces pandepth_tpu/device/events.py:
// extract_events (and, with the engine's tier sentinel and position
// dtype, the clamp-and-cast of pandepth_tpu/device/engine.py:add_batch).
// Bound on the H100: memory. Per CIGAR op it reads op_code/op_len/
// op_read (12 B) twice, the op's read row (tid/pos/flag/mapq, 16 B, but
// neighbouring ops share a read, so mostly cache hits), writes and
// re-reads its int64 ref offset, and writes two positions and two
// deltas (16-24 B): ~60 B per op, ~63 MB for a 2^20-op batch.
// JAX rebases a global exclusive cumsum of ref-consumed lengths per read
// with segment_min over op_read. A thread per read walking its op range
// would serialise on the one read that owns a JAX-padded tail (half the
// ops) or a long CIGAR, so the design is per op:
//   1. per-block totals of the ref-consumed lengths (ref_len_totals_kernel)
//   2. one-block exclusive scan of them            (exclusive_scan_one_block)
//   3. each op's global exclusive prefix; the first op of each read
//      stores its prefix as the read's base       (ref_offset_kernel)
//   4. one thread per op: offset = prefix - its read's base, the read's
//      filters, the clip, two events             (emit_events_kernel)
// op_read must be non-decreasing and op_len non-negative (a BAM length is
// 28-bit unsigned), as JAX's sorted segment_min also assumes: the
// minimum of a read's non-decreasing prefixes is its first op's.

constexpr int32_t REF_CONSUME_MASK = 0x18D;  // M D N = X
constexpr int32_t DEPTH_MASK = 0x181;        // M = X
constexpr int64_t DEAD_POS = 1LL << 62;      // JAX's dead-slot SENTINEL

// bit `code` of `mask`; 0 for a code outside [0, 32), as XLA's shift
__device__ __forceinline__ int32_t op_bit(int32_t mask, int32_t code) {
    return (uint32_t)code < 32u ? (mask >> code) & 1 : 0;
}

// the op's ref-consumed length, int32 product sign-extended as in JAX
__device__ __forceinline__ u64 ref_len(int32_t code, int32_t len) {
    return (u64)(int64_t)(len * op_bit(REF_CONSUME_MASK, code));
}

// jnp.clip: min(max(x, lo), hi)
__device__ __forceinline__ int64_t clip64(int64_t x, int64_t lo,
                                          int64_t hi) {
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
}

__global__ void ref_len_totals_kernel(const int32_t* __restrict__ op_code,
                                      const int32_t* __restrict__ op_len,
                                      int64_t m, u64* __restrict__ tot) {
    __shared__ u64 warp_tot[32];
    const int64_t base = (int64_t)blockIdx.x * TILE;
    u64 s = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + (int64_t)k * THREADS + threadIdx.x;
        if (i < m) s += ref_len(op_code[i], op_len[i]);
    }
    u64 block_total;
    block_exclusive_scan<u64>(s, warp_tot, &block_total);
    if (threadIdx.x == 0) tot[blockIdx.x] = block_total;
}

__global__ void ref_offset_kernel(const int32_t* __restrict__ op_code,
                                  const int32_t* __restrict__ op_len,
                                  const int32_t* __restrict__ op_read,
                                  int64_t m, int64_t n,
                                  const u64* __restrict__ carry,
                                  u64* __restrict__ excl,
                                  u64* __restrict__ read_base) {
    __shared__ u64 warp_tot[32];
    const int64_t base = (int64_t)blockIdx.x * TILE
                         + (int64_t)threadIdx.x * ITEMS;
    u64 c[ITEMS];
    u64 thread_sum = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k;
        c[k] = i < m ? ref_len(op_code[i], op_len[i]) : 0;
        thread_sum += c[k];
    }
    u64 block_total;
    u64 run = block_exclusive_scan<u64>(thread_sum, warp_tot, &block_total)
              + carry[blockIdx.x];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k;
        if (i < m) {
            excl[i] = run;
            const int32_t r = op_read[i];
            if ((i == 0 || op_read[i - 1] != r) && (uint32_t)r < n)
                read_base[r] = run;
        }
        run += c[k];
    }
}

template <typename Out>
__global__ void emit_events_kernel(const int32_t* __restrict__ tid,
                                   const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ flag,
                                   const int32_t* __restrict__ mapq,
                                   const int32_t* __restrict__ op_code,
                                   const int32_t* __restrict__ op_len,
                                   const int32_t* __restrict__ op_read,
                                   int64_t m, int64_t n,
                                   const int64_t* __restrict__ offsets,
                                   const int64_t* __restrict__ limits,
                                   int64_t n_targets, int32_t flags_mask,
                                   int32_t min_mapq,
                                   const u64* __restrict__ excl,
                                   const u64* __restrict__ read_base,
                                   int64_t sentinel,
                                   Out* __restrict__ ev_pos,
                                   int32_t* __restrict__ ev_delta) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += stride) {
        // an op_read outside [0, n) reads a clamped row (memory safety;
        // the decoders never produce one)
        const int32_t r_raw = op_read[i];
        const int64_t r = r_raw < 0 ? 0 : (r_raw < n ? r_raw : n - 1);
        const int32_t t = tid[r];
        bool keep = (flag[r] & flags_mask) == 0 && t >= 0;
        if (min_mapq >= 1) keep = keep && mapq[r] >= min_mapq;
        // JAX gathers at max(tid, 0) and clamps past the last target
        const int64_t ts = t < 0 ? 0 : (t < n_targets ? t : n_targets - 1);
        const int64_t lo = offsets[ts];
        const int64_t hi = limits[ts];
        const int32_t len = op_len[i];
        // int64 sums wrap as in JAX
        const u64 off = excl[i] - read_base[r];
        int64_t start = (int64_t)((u64)lo + (u64)(int64_t)pos[r] + off);
        int64_t end = (int64_t)((u64)start + (u64)(int64_t)len);
        start = clip64(start, lo, hi);
        end = clip64(end, lo, hi);
        const bool live = op_bit(DEPTH_MASK, op_code[i]) && keep && len > 0
                          && end > start;
        // JAX's where(live, x, SENTINEL), then add_batch's min(., sentinel)
        const int64_t s = live ? start : DEAD_POS;
        const int64_t e = live ? end : DEAD_POS;
        ev_pos[i] = (Out)(s < sentinel ? s : sentinel);
        ev_pos[m + i] = (Out)(e < sentinel ? e : sentinel);
        ev_delta[i] = live ? 1 : 0;
        ev_delta[m + i] = live ? -1 : 0;
    }
}

// ---------------------------------------------------------------------
// K8 decode_enc — replaces the decode half of
// pandepth_tpu/device/sweep.py:finalize_encoded (:205), that is
// _decode_enc_group (:133, the mixed format) and _decode_const_group
// (:175, the const-length format); the sort and the scans after it are
// K2 + K3, as in JAX.
// A window row r of CAP slots decodes to start[r, j] = base[r] +
// sum_{k <= j} delta[r, k] and end = start + len, where delta is the
// zigzag decode of a u8/u16 code and each escape slot (code = the code
// type's max) takes its true value from an int64 side list: JAX adds
// (exc - zig(esc)) at the slot, and so does this kernel. The mixed
// format carries a length plane with escapes of its own; the const
// format one length per row for its first ns[r] slots, 0 after them.
// Bound on the H100: memory. Per slot it reads 1-2 B of codes per plane
// and writes the start and end words and their +-1 deltas, then re-reads
// and re-writes the two words: ~40 B per slot in the int32 tier, ~58 B
// in the others. The sums are row scans of 2^19 slots, so one block per
// row would leave most of the 132 SMs idle at 8-32 rows; the design is
// sweep_scan's multi-pass one, per row, over a (tiles, rows) grid:
//   1. decoded deltas and lengths into the output words, the +-1
//      deltas, per-tile delta totals                 (dec_init_kernel)
//   2. one thread per escape entry: its correction added to the slot
//      and to the slot's tile total (atomics; slots are distinct within
//      a row, so they never contend)                (dec_escape_kernel)
//   3. per row, an exclusive scan of the tile totals from the row's
//      base                                          (dec_row_scan_kernel)
//   4. per tile, the in-tile scan from its carry: starts, then ends =
//      start + len, in place                        (dec_scan_kernel)
// Tier arithmetic (A): JAX computes in the position dtype, and int32 and
// uint32 wrap there, so the two 32-bit tiers sum in uint32 (the uint32
// tier's words are then zero-extended to int64) and the int64 tier in
// uint64. The output words (W) are int32 in the int32 tier, int64 else.
// Zero tail slots and zero rows decode to zero-length events at the
// previous position: depth-neutral, and kept, as in JAX.

template <typename C, typename W, typename A, bool CONST>
__global__ void dec_init_kernel(const C* __restrict__ codes,
                                const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ ns, int64_t cap,
                                int64_t ntiles, W* __restrict__ starts,
                                W* __restrict__ ends,
                                int32_t* __restrict__ ds,
                                int32_t* __restrict__ de,
                                u64* __restrict__ tot) {
    __shared__ A warp_tot[32];
    const int64_t r = blockIdx.y;
    const int64_t tile = blockIdx.x;
    const C* cd = codes + r * (CONST ? 1 : 2) * cap;
    A s = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t j = tile * TILE + (int64_t)k * THREADS + threadIdx.x;
        if (j < cap) {
            const A z = (A)cd[j];
            const A delta = (z >> 1) ^ ((A)0 - (z & (A)1));
            A len;
            if (CONST) len = j < ns[r] ? (A)(int64_t)lens[r] : (A)0;
            else len = (A)cd[cap + j];
            const int64_t i = r * cap + j;
            starts[i] = (W)delta;
            ends[i] = (W)len;
            ds[i] = 1;
            de[i] = -1;
            s += delta;
        }
    }
    A block_total;
    block_exclusive_scan<A>(s, warp_tot, &block_total);
    if (threadIdx.x == 0) tot[r * ntiles + tile] = (u64)block_total;
}

template <typename W>
__device__ __forceinline__ void word_add(W* p, u64 v);
template <>
__device__ __forceinline__ void word_add<int32_t>(int32_t* p, u64 v) {
    atomicAdd(reinterpret_cast<unsigned int*>(p), (unsigned int)v);
}
template <>
__device__ __forceinline__ void word_add<int64_t>(int64_t* p, u64 v) {
    atomicAdd(reinterpret_cast<u64*>(p), v);
}

template <typename W, typename A, bool CONST>
__global__ void dec_escape_kernel(const int64_t* __restrict__ excs,
                                  const int32_t* __restrict__ slots,
                                  int64_t cap, int64_t ce, int64_t ntiles,
                                  int64_t esc, W* __restrict__ starts,
                                  W* __restrict__ ends,
                                  u64* __restrict__ tot) {
    const int64_t r = blockIdx.y;
    const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= ce) return;
    // zig(esc): what the plain zigzag decode gave the escape slot
    const int64_t zig_esc = (esc >> 1) ^ -(esc & 1);
    const int64_t row = r * (CONST ? 1 : 2) * ce;
    // unused entries hold CAP; anything outside [0, CAP) is dropped, as
    // JAX's scatter drops it
    const int32_t sd = slots[row + k];
    if (sd >= 0 && sd < cap) {
        const A corr = (A)(excs[row + k] - zig_esc);
        word_add<W>(starts + r * cap + sd, (u64)corr);
        atomicAdd(tot + r * ntiles + sd / TILE, (u64)corr);
    }
    if (!CONST) {
        const int32_t sl = slots[row + ce + k];
        if (sl >= 0 && sl < cap)
            word_add<W>(ends + r * cap + sl,
                        (u64)(A)(excs[row + ce + k] - esc));
    }
}

// Per row: tile totals -> exclusive prefixes starting at the row's base.
// One block of TOTALS_THREADS per row.
template <typename W, typename A>
__global__ void dec_row_scan_kernel(const W* __restrict__ bases,
                                    int64_t ntiles, u64* __restrict__ tot) {
    __shared__ A warp_tot[32];
    u64* t = tot + (int64_t)blockIdx.x * ntiles;
    A carry = (A)bases[blockIdx.x];
    for (int64_t b = 0; b < ntiles; b += blockDim.x) {
        const int64_t i = b + threadIdx.x;
        const A v = i < ntiles ? (A)t[i] : (A)0;
        A chunk_total;
        const A ex = block_exclusive_scan<A>(v, warp_tot, &chunk_total);
        if (i < ntiles) t[i] = (u64)(carry + ex);
        carry += chunk_total;
    }
}

template <typename W, typename A>
__global__ void dec_scan_kernel(int64_t cap, int64_t ntiles,
                                const u64* __restrict__ tot,
                                W* __restrict__ starts,
                                W* __restrict__ ends) {
    __shared__ A warp_tot[32];
    const int64_t r = blockIdx.y;
    const int64_t j0 = (int64_t)blockIdx.x * TILE
                       + (int64_t)threadIdx.x * ITEMS;
    W* st = starts + r * cap;
    W* en = ends + r * cap;
    A d[ITEMS];
    A s = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        d[k] = j0 + k < cap ? (A)st[j0 + k] : (A)0;
        s += d[k];
    }
    A block_total;
    A run = block_exclusive_scan<A>(s, warp_tot, &block_total)
            + (A)tot[r * ntiles + blockIdx.x];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int64_t j = j0 + k;
        run += d[k];
        if (j < cap) {
            st[j] = (W)run;
            en[j] = (W)(run + (A)en[j]);
        }
    }
}

template <typename C, typename W, typename A, bool CONST>
int decode_enc_typed(const C* codes, const int64_t* excs,
                     const int32_t* slots, const W* bases,
                     const int32_t* lens, const int32_t* ns, int64_t rows,
                     int64_t cap, int64_t ce, W* starts, W* ends,
                     int32_t* ds, int32_t* de, int64_t* scratch,
                     cudaStream_t st) {
    const int64_t ntiles = (cap + TILE - 1) / TILE;
    u64* tot = reinterpret_cast<u64*>(scratch);
    const dim3 tiles((unsigned int)ntiles, (unsigned int)rows);
    dec_init_kernel<C, W, A, CONST><<<tiles, THREADS, 0, st>>>(
        codes, lens, ns, cap, ntiles, starts, ends, ds, de, tot);
    if (ce > 0) {
        const dim3 entries((unsigned int)((ce + POINT_THREADS - 1)
                                          / POINT_THREADS),
                           (unsigned int)rows);
        dec_escape_kernel<W, A, CONST><<<entries, POINT_THREADS, 0, st>>>(
            excs, slots, cap, ce, ntiles, (int64_t)(C)~(C)0, starts, ends,
            tot);
    }
    dec_row_scan_kernel<W, A><<<(unsigned int)rows, TOTALS_THREADS, 0, st>>>(
        bases, ntiles, tot);
    dec_scan_kernel<W, A><<<tiles, THREADS, 0, st>>>(cap, ntiles, tot,
                                                     starts, ends);
    return (int)cudaGetLastError();
}

template <typename C, bool CONST>
int decode_enc_tier(int tier, const void* codes, const int64_t* excs,
                    const int32_t* slots, const void* bases,
                    const int32_t* lens, const int32_t* ns, int64_t rows,
                    int64_t cap, int64_t ce, void* starts, void* ends,
                    int32_t* ds, int32_t* de, int64_t* scratch,
                    cudaStream_t st) {
    const C* c = (const C*)codes;
    if (tier == TIER_I32)
        return decode_enc_typed<C, int32_t, uint32_t, CONST>(
            c, excs, slots, (const int32_t*)bases, lens, ns, rows, cap, ce,
            (int32_t*)starts, (int32_t*)ends, ds, de, scratch, st);
    if (tier == TIER_U32)
        return decode_enc_typed<C, int64_t, uint32_t, CONST>(
            c, excs, slots, (const int64_t*)bases, lens, ns, rows, cap, ce,
            (int64_t*)starts, (int64_t*)ends, ds, de, scratch, st);
    if (tier == TIER_I64)
        return decode_enc_typed<C, int64_t, u64, CONST>(
            c, excs, slots, (const int64_t*)bases, lens, ns, rows, cap, ce,
            (int64_t*)starts, (int64_t*)ends, ds, de, scratch, st);
    return (int)cudaErrorInvalidValue;
}

inline unsigned int point_blocks(int64_t n) {
    const int64_t b = (n + POINT_THREADS - 1) / POINT_THREADS;
    return (unsigned int)(b < (1 << 20) ? b : (1 << 20));
}

template <typename P>
int sweep_scan_typed(const P* pos, const int32_t* delta, int64_t n,
                     int32_t min_dep, int wrap18, P pmax,
                     int32_t* depth, int64_t* c_cov, int64_t* c_sum,
                     int64_t* scratch, cudaStream_t st) {
    const int64_t nblk = (n + TILE - 1) / TILE;
    u64* cov_tot = reinterpret_cast<u64*>(scratch);
    u64* sum_tot = cov_tot + nblk;
    uint32_t* dtot = reinterpret_cast<uint32_t*>(sum_tot + nblk);
    delta_block_totals_kernel<<<(unsigned int)nblk, THREADS, 0, st>>>(
        delta, n, dtot);
    exclusive_scan_one_block<uint32_t><<<1, TOTALS_THREADS, 0, st>>>(
        dtot, nblk);
    scan_depth_kernel<P><<<(unsigned int)nblk, THREADS, 0, st>>>(
        pos, delta, n, dtot, min_dep, wrap18, pmax, depth,
        reinterpret_cast<u64*>(c_cov), reinterpret_cast<u64*>(c_sum),
        cov_tot, sum_tot);
    exclusive_scan_one_block<u64><<<1, TOTALS_THREADS, 0, st>>>(cov_tot,
                                                                nblk);
    exclusive_scan_one_block<u64><<<1, TOTALS_THREADS, 0, st>>>(sum_tot,
                                                                nblk);
    add_carry_kernel<<<(unsigned int)((n + THREADS - 1) / THREADS),
                       THREADS, 0, st>>>(
        n, cov_tot, sum_tot, reinterpret_cast<u64*>(c_cov),
        reinterpret_cast<u64*>(c_sum));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per scan block; the wrapper sizes sweep_scan's scratch as
// 3 * ceil(n / pdt_sweep_scan_tile()) int64 words.
int64_t pdt_sweep_scan_tile(void) { return TILE; }

int pdt_pack_events(int device, int tier, const void* starts,
                    const void* ends, int64_t m, void* pos,
                    int32_t* delta, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (m <= 0) return (int)cudaGetLastError();  // nothing to launch
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int blocks = point_blocks(2 * m);
    if (tier == TIER_I32) {
        pack_events_kernel<int32_t, int32_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int32_t*)starts, (const int32_t*)ends, m, INT32_MAX,
            (int32_t*)pos, delta);
    } else if (tier == TIER_U32) {
        pack_events_kernel<uint32_t, int64_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const uint32_t*)starts, (const uint32_t*)ends, m,
            (int64_t)0xFFFFFFFFu, (int64_t*)pos, delta);
    } else if (tier == TIER_I64) {
        pack_events_kernel<int64_t, int64_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int64_t*)starts, (const int64_t*)ends, m, INT64_MAX,
            (int64_t*)pos, delta);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int pdt_sweep_scan(int device, int pos64, const void* pos,
                   const int32_t* delta, int64_t n, int32_t min_dep,
                   int wrap18, int64_t pmax, int32_t* depth, int64_t* c_cov,
                   int64_t* c_sum, int64_t* scratch, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (pos64)
        return sweep_scan_typed<int64_t>((const int64_t*)pos, delta, n,
                                         min_dep, wrap18, pmax, depth, c_cov,
                                         c_sum, scratch, st);
    return sweep_scan_typed<int32_t>((const int32_t*)pos, delta, n, min_dep,
                                     wrap18, (int32_t)pmax, depth, c_cov,
                                     c_sum, scratch, st);
}

int pdt_eval_pair(int device, int pos64, const void* pos,
                  const int32_t* depth, const int64_t* c_cov,
                  const int64_t* c_sum, int64_t e, int32_t min_dep,
                  const void* lo, const void* hi, int64_t b, int64_t* cover,
                  int64_t* dsum, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (b <= 0 || e <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int blocks =
        (unsigned int)((b + POINT_THREADS - 1) / POINT_THREADS);
    if (pos64) {
        eval_pair_kernel<int64_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int64_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int64_t*)lo, (const int64_t*)hi, b, cover, dsum);
    } else {
        eval_pair_kernel<int32_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int32_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int32_t*)lo, (const int32_t*)hi, b, cover, dsum);
    }
    return (int)cudaGetLastError();
}

int pdt_eval_boundaries(int device, int pos64, const void* pos,
                        const int32_t* depth, const int64_t* c_cov,
                        const int64_t* c_sum, int64_t e, int32_t min_dep,
                        const void* x, int64_t b, int64_t* q_cov,
                        int64_t* q_sum, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (b <= 0 || e <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int blocks =
        (unsigned int)((b + POINT_THREADS - 1) / POINT_THREADS);
    if (pos64) {
        eval_boundaries_kernel<int64_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int64_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int64_t*)x, b, q_cov, q_sum);
    } else {
        eval_boundaries_kernel<int32_t><<<blocks, POINT_THREADS, 0, st>>>(
            (const int32_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int32_t*)x, b, q_cov, q_sum);
    }
    return (int)cudaGetLastError();
}

// scratch: m + n + ceil(m / pdt_sweep_scan_tile()) int64 words (each op's
// prefix, each read's base, the block totals). ev_pos is int64 when pos64
// is set, else int32. Dead slots hold 1 << 62, and every position is then
// clamped to at most `sentinel` (1 << 62 gives JAX's extract_events).
int pdt_extract_events(int device, const int32_t* tid, const int32_t* pos,
                       const int32_t* flag, const int32_t* mapq, int64_t n,
                       const int32_t* op_code, const int32_t* op_len,
                       const int32_t* op_read, int64_t m,
                       const int64_t* offsets, const int64_t* limits,
                       int64_t n_targets, int32_t flags_mask,
                       int32_t min_mapq, int pos64, int64_t sentinel,
                       void* ev_pos, int32_t* ev_delta, int64_t* scratch,
                       void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (m <= 0) return (int)cudaGetLastError();
    if (n <= 0 || n_targets <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nblk = (m + TILE - 1) / TILE;
    u64* excl = reinterpret_cast<u64*>(scratch);
    u64* read_base = excl + m;
    u64* tot = read_base + n;
    ref_len_totals_kernel<<<(unsigned int)nblk, THREADS, 0, st>>>(
        op_code, op_len, m, tot);
    exclusive_scan_one_block<u64><<<1, TOTALS_THREADS, 0, st>>>(tot, nblk);
    ref_offset_kernel<<<(unsigned int)nblk, THREADS, 0, st>>>(
        op_code, op_len, op_read, m, n, tot, excl, read_base);
    const unsigned int blocks = point_blocks(m);
    if (pos64) {
        emit_events_kernel<int64_t><<<blocks, POINT_THREADS, 0, st>>>(
            tid, pos, flag, mapq, op_code, op_len, op_read, m, n, offsets,
            limits, n_targets, flags_mask, min_mapq, excl, read_base,
            sentinel, (int64_t*)ev_pos, ev_delta);
    } else {
        emit_events_kernel<int32_t><<<blocks, POINT_THREADS, 0, st>>>(
            tid, pos, flag, mapq, op_code, op_len, op_read, m, n, offsets,
            limits, n_targets, flags_mask, min_mapq, excl, read_base,
            sentinel, (int32_t*)ev_pos, ev_delta);
    }
    return (int)cudaGetLastError();
}

// K8 on one stacked block of `rows` windows of `cap` slots: codes are
// (rows, 2, cap) in the mixed format (plane 0 the zigzag start deltas,
// plane 1 the lengths) or (rows, cap) with `lens` and `ns` per row in
// the const format; uint8 or, with code16, uint16. excs/slots are
// (rows, 2, ce) or (rows, ce). bases and the outputs are the tier's
// words. Row r's starts go to starts[r * cap ...], its ends to
// ends[r * cap ...], +1 to ds and -1 to de at the same slots. scratch:
// rows * ceil(cap / pdt_sweep_scan_tile()) int64 words.
int pdt_decode_enc(int device, int tier, int code16, int is_const,
                   const void* codes, const int64_t* excs,
                   const int32_t* slots, const void* bases,
                   const int32_t* lens, const int32_t* ns, int64_t rows,
                   int64_t cap, int64_t ce, void* starts, void* ends,
                   int32_t* ds, int32_t* de, int64_t* scratch,
                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || cap <= 0) return (int)cudaGetLastError();
    if (rows > 65535) return (int)cudaErrorInvalidValue;  // grid.y
    cudaStream_t st = (cudaStream_t)stream;
    if (code16)
        return is_const
            ? decode_enc_tier<uint16_t, true>(tier, codes, excs, slots, bases,
                                              lens, ns, rows, cap, ce, starts,
                                              ends, ds, de, scratch, st)
            : decode_enc_tier<uint16_t, false>(tier, codes, excs, slots,
                                               bases, lens, ns, rows, cap, ce,
                                               starts, ends, ds, de, scratch,
                                               st);
    return is_const
        ? decode_enc_tier<uint8_t, true>(tier, codes, excs, slots, bases,
                                         lens, ns, rows, cap, ce, starts,
                                         ends, ds, de, scratch, st)
        : decode_enc_tier<uint8_t, false>(tier, codes, excs, slots, bases,
                                          lens, ns, rows, cap, ce, starts,
                                          ends, ds, de, scratch, st);
}

}  // extern "C"
