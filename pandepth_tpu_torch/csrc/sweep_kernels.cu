// Hand-written Hopper (sm_90a) kernels for the coverage sweep, the
// CIGAR-extraction feed, the encoded-window decode and the
// genome-range-sharded engine.
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

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TIER_I32 = 0;
constexpr int TIER_U32 = 1;
constexpr int TIER_I64 = 2;

constexpr int POINT_THREADS = 256;      // pack_events
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
// Single-pass scans by decoupled look-back (Merrill and Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
// A block takes its tile from an atomic counter, not from blockIdx, so
// every tile of a lower index is held by a block that already runs: no
// block ever waits on one that has not been scheduled. A tile publishes
// its aggregate as soon as it has it; one warp then reads the status of
// 32 predecessors at a time, one a lane, sums their aggregates back to
// the nearest inclusive prefix, and the tile publishes its own inclusive
// prefix.
// Values go to L2 (st.cg) before a status word stored with release
// semantics; a reader loads the status relaxed, fences (acq_rel), then
// loads the values from L2 (ld.cg). A tile's aggregate and its inclusive
// prefix have separate slots, so a reader that saw "aggregate" never
// reads a prefix being written. The status words are zeroed on the
// call's stream before the launch (the caching allocator hands out dirty
// scratch), with the tile counter beside them: one memset.

constexpr unsigned ST_NONE = 0;   // not published yet
constexpr unsigned ST_AGG = 1;    // the tile's aggregate
constexpr unsigned ST_INC = 2;    // its inclusive prefix

// one status array: a flag per tile, NV u64 words per value
struct Lookback {
    unsigned* flag;
    u64* agg;
    u64* inc;
};

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

template <int NV>
__device__ __forceinline__ void publish(Lookback s, int64_t tile,
                                        const u64 (&v)[NV], unsigned what) {
    u64* dst = (what == ST_INC ? s.inc : s.agg) + tile * NV;
#pragma unroll
    for (int k = 0; k < NV; ++k) __stcg(dst + k, v[k]);
    st_release(s.flag + tile, what);
}

// Nanoseconds a polling warp sleeps before it reads its predecessors'
// status again: the waiting warps' polls otherwise crowd the L2 lines of
// the status words.
constexpr int LOOKBACK_SLEEP_NS = 100;

// the acquire half of the status protocol, after a relaxed load
__device__ __forceinline__ void fence_acquire() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// *p += v at GPU scope with acquire and release semantics; returns the
// old value
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(p), "r"(v)
                 : "memory");
    return old;
}

// Called by the 32 lanes of one warp: on every lane, the sum of the
// values of tiles [first, tile), where tile `first` publishes an
// inclusive prefix (its own value, or a base plus it). Lane l reads the
// predecessor at distance l + 1, then 32 further back each pass, until
// some lane finds an inclusive prefix.
template <int NV>
__device__ void look_back(Lookback s, int64_t first, int64_t tile,
                          u64 (&excl)[NV]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < NV; ++k) excl[k] = 0;
    for (int64_t p = tile - 1 - lane;; p -= 32) {
        unsigned f;   // a tile before `first` reads as an inclusive zero
        while (true) {
            f = p >= first ? ld_relaxed(s.flag + p) : ST_INC;
            if (!__any_sync(0xffffffffu, f == ST_NONE)) break;
            __nanosleep(LOOKBACK_SLEEP_NS);
        }
        fence_acquire();
        // lanes up to the first with an inclusive prefix add their values
        const unsigned inc = __ballot_sync(0xffffffffu, f == ST_INC);
        const int stop = inc ? __ffs(inc) - 1 : 31;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            u64 v = lane <= stop && p >= first
                        ? __ldcg((f == ST_INC ? s.inc : s.agg) + p * NV + k)
                        : 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            excl[k] += v;
        }
        if (inc) return;
    }
}

// The tile's exclusive prefix, on every thread of the block (through
// `shared`): published from `tot`, resolved by warp 0. Tile `first`'s
// exclusive prefix is `base`. All threads must call it.
template <int NV>
__device__ void tile_prefix(Lookback s, int64_t first, int64_t tile,
                            const u64 (&base)[NV], const u64 (&tot)[NV],
                            u64* shared, u64 (&excl)[NV]) {
    if (threadIdx.x < 32) {
        if (tile == first) {
            if (threadIdx.x == 0) {
                u64 inc[NV];
#pragma unroll
                for (int k = 0; k < NV; ++k) {
                    inc[k] = base[k] + tot[k];
                    shared[k] = base[k];
                }
                publish<NV>(s, tile, inc, ST_INC);
            }
        } else {
            if (threadIdx.x == 0) publish<NV>(s, tile, tot, ST_AGG);
            u64 ex[NV];
            look_back<NV>(s, first, tile, ex);
            if (threadIdx.x == 0) {
                u64 inc[NV];
#pragma unroll
                for (int k = 0; k < NV; ++k) {
                    inc[k] = ex[k] + tot[k];
                    shared[k] = ex[k];
                }
                publish<NV>(s, tile, inc, ST_INC);
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) excl[k] = shared[k];
}

// Scratch of a look-back kernel, in int64 words: the tile counter and
// `nstages` flag arrays (zeroed by one memset of the first `zeroed`
// words), then each stage's aggregate and inclusive slots. With
// scratch == nullptr it only counts.
inline int64_t carve_lookback(int64_t* scratch, int64_t ntiles, int nstages,
                              const int* nv, unsigned** counter,
                              Lookback* stages, int64_t* zeroed) {
    const int64_t flag_words = (1 + nstages * ntiles + 1) / 2;
    int64_t words = flag_words;
    unsigned* flags = scratch ? reinterpret_cast<unsigned*>(scratch) : nullptr;
    if (scratch) *counter = flags;
    for (int k = 0; k < nstages; ++k) {
        if (scratch) {
            stages[k].flag = flags + 1 + k * ntiles;
            stages[k].agg = reinterpret_cast<u64*>(scratch + words);
            stages[k].inc = stages[k].agg + nv[k] * ntiles;
        }
        words += 2 * nv[k] * ntiles;
    }
    if (zeroed) *zeroed = flag_words;
    return words;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute belongs to each device's copy of the kernel, so
// it is set once per device (bit d of `done`, one per kernel instance),
// not on every call, where it would add host time to each launch.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, std::atomic<u64>& done) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const u64 bit = dev < 64 ? 1ull << dev : 0;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
}

// shared-memory slots with one pad word every 32 four-byte words or every
// 16 eight-byte words: both a striped access (thread t at t + k * THREADS)
// and a blocked one (thread t at t * ITEMS + k) hit distinct banks
template <typename T>
__device__ __forceinline__ int padded(int i) {
    return sizeof(T) == 8 ? i + (i >> 4) : i + (i >> 5);
}

template <typename T>
__host__ __device__ constexpr int padded_size(int n) {
    return sizeof(T) == 8 ? n + n / 16 : n + n / 32;
}

// ---------------------------------------------------------------------
// K2 sweep_scan — replaces the arithmetic of
// pandepth_tpu/device/sweep.py:sort_events (the sort itself stays a
// library sort, as it was an XLA primitive).
// Bound on the H100: memory. Per event it must read delta (4 B) and pos
// (4-8 B) and write depth (4 B), c_cov and c_sum (8 B each): 32 B per
// event in the uint32 tier, 486 MB at the chr path's 15.2M events. The
// design is one pass, one launch: each tile is read once and written
// once, through shared memory, so every warp-wide load and store covers
// contiguous bytes whatever the alignment of the row it is given (the
// sharded engine passes rows of odd widths); the arithmetic runs on the
// blocked layout (SWEEP_ITEMS consecutive events a thread, their piece
// lengths kept in registers). The depth of
// an event needs the tile's incoming delta carry, and c_cov/c_sum need
// that depth (covered = depth >= min_dep after the wrap18 mask), so a
// tile resolves two look-backs in turn: the u32 delta sum, published at
// once, then the (cov, sum) pair, published as soon as the delta prefix
// is known. The second never waits on a chain: a predecessor's pair
// aggregate is ready as soon as its own delta prefix is. Deltas sum in
// u32 and the prefix is cast to int32 (jnp.cumsum(..., dtype=int32));
// the wrap18 mask applies to the whole prefix; the pair wraps mod 2^64 as
// JAX's int64 cumsums do.

// Tiles of 8,192 events: the inclusive prefix crosses each tile in turn,
// so fewer, larger tiles shorten that chain; one 512-thread block (122
// registers a thread, 103 KB of shared memory) fills an SM. The tile
// sizes here and of decode_enc are also pandepth_tpu_torch/synth.py's
// SWEEP_TILE and DEC_TILE, which chip_smoke.py holds to the library's.
constexpr int SWEEP_THREADS = 512;
constexpr int SWEEP_ITEMS = 16;
constexpr int SWEEP_TILE = SWEEP_THREADS * SWEEP_ITEMS;
// dynamic shared memory: the positions' slots (u64), then the deltas'
constexpr int SWEEP_SMEM = padded_size<u64>(SWEEP_TILE) * 8
                           + padded_size<uint32_t>(SWEEP_TILE) * 4;

template <typename P>
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_scan_kernel(const P* __restrict__ pos,
                  const int32_t* __restrict__ delta, int64_t n,
                  int32_t min_dep, int wrap18, P pmax,
                  int32_t* __restrict__ depth, u64* __restrict__ c_cov,
                  u64* __restrict__ c_sum, unsigned* counter, Lookback dsc,
                  Lookback csc) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* sp = reinterpret_cast<u64*>(smem);   // positions, c_cov, c_sum
    uint32_t* sd = reinterpret_cast<uint32_t*>(
        sp + padded_size<u64>(SWEEP_TILE));    // deltas, depths
    __shared__ u64 warp64[32];
    __shared__ uint32_t warp32[32];
    __shared__ u64 prefix[2];
    __shared__ unsigned s_tile;
    const int tid = threadIdx.x;
    if (tid == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t base = tile * SWEEP_TILE;

#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {   // striped, coalesced
        const int j = k * SWEEP_THREADS + tid;
        const int64_t i = base + j;
        sd[padded<uint32_t>(j)] = i < n ? (uint32_t)delta[i] : 0u;
        sp[padded<u64>(j)] = i < n ? (u64)(int64_t)pos[i] : 0;
    }
    __syncthreads();

    const int j0 = tid * SWEEP_ITEMS;   // blocked from here
    uint32_t d[SWEEP_ITEMS];
    uint32_t dsum = 0;
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        d[k] = sd[padded<uint32_t>(j0 + k)];
        dsum += d[k];
    }
    uint32_t dtot;
    const uint32_t dex = block_exclusive_scan<uint32_t>(dsum, warp32, &dtot);
    u64 dpre[1];
    {
        const u64 zero[1] = {0}, tot[1] = {dtot};
        tile_prefix<1>(dsc, 0, tile, zero, tot, prefix, dpre);
    }

    uint32_t run = (uint32_t)dpre[0] + dex;
    u64 plen[SWEEP_ITEMS];
    u64 tcov = 0, tsum = 0;
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        run += d[k];
        int32_t dep = (int32_t)run;   // jnp.cumsum(..., dtype=int32)
        if (wrap18) dep &= WRAP18_MASK;
        d[k] = (uint32_t)dep;
        const int64_t i = base + j0 + k;
        u64 len = 0;
        if (i < n && dep >= min_dep) {
            int64_t nxt = (int64_t)pmax;
            if (i + 1 < n)
                nxt = j0 + k + 1 < SWEEP_TILE
                          ? (int64_t)sp[padded<u64>(j0 + k + 1)]
                          : (int64_t)pos[i + 1];   // the next tile's first
            len = (u64)(nxt - (int64_t)sp[padded<u64>(j0 + k)]);
        }
        plen[k] = len;
        tcov += len;
        tsum += len * (u64)(int64_t)dep;
        sd[padded<uint32_t>(j0 + k)] = (uint32_t)dep;
    }
    u64 ctot, stot;   // the scans' barriers also publish sd's depths
    const u64 ex_cov = block_exclusive_scan<u64>(tcov, warp64, &ctot);
    const u64 ex_sum = block_exclusive_scan<u64>(tsum, warp64, &stot);
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        const int j = k * SWEEP_THREADS + tid;
        if (base + j < n) depth[base + j] = (int32_t)sd[padded<uint32_t>(j)];
    }
    u64 cpre[2];
    {
        const u64 zero[2] = {0, 0}, tot[2] = {ctot, stot};
        tile_prefix<2>(csc, 0, tile, zero, tot, prefix, cpre);
    }

    u64 cov = cpre[0] + ex_cov;
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        cov += plen[k];
        sp[padded<u64>(j0 + k)] = cov;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        const int j = k * SWEEP_THREADS + tid;
        if (base + j < n) c_cov[base + j] = sp[padded<u64>(j)];
    }
    __syncthreads();
    u64 sum = cpre[1] + ex_sum;
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        sum += plen[k] * (u64)(int64_t)(int32_t)d[k];
        sp[padded<u64>(j0 + k)] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SWEEP_ITEMS; ++k) {
        const int j = k * SWEEP_THREADS + tid;
        if (base + j < n) c_sum[base + j] = sp[padded<u64>(j)];
    }
}

// ---------------------------------------------------------------------
// Q(x), the integrals of the covered indicator and of covered depth over
// [0, x), from r = the first index with pos[r] >= x (lower bound) and the
// piece before it: c_cov/c_sum up to piece r - 2 and the part of piece
// r - 1 below x. K3, K5 and eval_pair_rows search with a group of lanes
// (group_lower_bound) and gather the four words in one round (group_q),
// or K3 and K5 search events staged in shared memory (window_q). All of
// the arithmetic is u64, which wraps as the JAX int64 sums do.

// The lower bound of x in pos[lo, hi) (hi if every word is below x),
// searched by a group of g lanes (g a power of two up to 32; the group is
// lanes [first, first + g) of the warp, gl the lane's place in it). Each
// round lane j loads the splitter s_j = lo + len * (j + 1) / (g + 1); the
// splitters are non-decreasing in j and pos is sorted, so the c splitters
// below x are the first c, and the answer lies in (s_{c-1}, s_c] (lo when
// c = 0, hi when c = g): a (g + 1)-way cut, ceil(log_{g+1}(len)) rounds
// of g independent loads (g = 1 is the binary search). Runs of equal
// words need nothing: a splitter on one is below x or not. Every lane of
// the warp calls it, each group with its own interval (an empty one for
// a group with no query), and the warp runs until its last group is done,
// so every ballot is the full warp's.
template <typename P>
__device__ __forceinline__ int64_t group_lower_bound(const P* __restrict__ pos,
                                                     int64_t lo, int64_t hi,
                                                     P x, int g, int gl,
                                                     int first) {
    const unsigned own = (g == 32 ? 0xffffffffu : (1u << g) - 1u) << first;
    while (__any_sync(0xffffffffu, lo < hi)) {
        const int64_t len = hi - lo;
        const bool live = lo < hi;
        const bool below = live && pos[lo + len * (gl + 1) / (g + 1)] < x;
        const int c = __popc(__ballot_sync(0xffffffffu, below) & own);
        if (live) {
            const int64_t base = lo;
            if (c > 0) lo = base + len * c / (g + 1) + 1;
            if (c < g) hi = base + len * (c + 1) / (g + 1);
        }
    }
    return lo;
}

// Q(x) from a group's lower bound r: the four words (pos[r-1],
// depth[r-1], c_cov[r-2], c_sum[r-2]) loaded in one round, word i by the
// group's lane i mod g, then shared through the group. Every lane of the
// warp calls it and every lane of a group gets its Q.
template <typename P>
__device__ __forceinline__ void group_q(const P* __restrict__ pos,
                                        const int32_t* __restrict__ depth,
                                        const int64_t* __restrict__ c_cov,
                                        const int64_t* __restrict__ c_sum,
                                        int32_t min_dep, int64_t r, P x,
                                        int g, int gl, int first, u64* q_cov,
                                        u64* q_sum) {
    u64 v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if ((i & (g - 1)) != gl) continue;
        if (i == 0 && r >= 1) v[0] = (u64)(int64_t)pos[r - 1];
        if (i == 1 && r >= 1) v[1] = (u64)(int64_t)depth[r - 1];
        if (i == 2 && r >= 2) v[2] = (u64)c_cov[r - 2];
        if (i == 3 && r >= 2) v[3] = (u64)c_sum[r - 2];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        v[i] = __shfl_sync(0xffffffffu, v[i], first + (i & (g - 1)));
    u64 cov = v[2], sum = v[3];
    if (r >= 1) {
        const int32_t dep = (int32_t)v[1];
        const u64 part = dep >= min_dep
                             ? (u64)((int64_t)x - (int64_t)v[0]) : 0;
        cov += part;
        sum += part * (u64)(int64_t)dep;
    }
    *q_cov = cov;
    *q_sum = sum;
}

// The group size for n queries over `lanes` lanes: the largest power of
// two up to 16 that gives every query its own group.
__device__ __forceinline__ int group_size(int64_t n, int lanes) {
    int g = 16;
    while (g > 1 && (int64_t)g * n > lanes) g >>= 1;
    return g;
}

// ---------------------------------------------------------------------
// K3 eval_pair — replaces pandepth_tpu/device/sweep.py:eval_pair — and
// K5 eval_boundaries — replaces pandepth_tpu/device/sweep.py:
// eval_boundaries. K5 is the one-sided half of K3, so one kernel body
// serves both (search_eval_kernel). Its items are pairs of boundaries,
// lo[s] and hi[s]: K3's segments, of which it writes Q(hi) - Q(lo); and
// for K5 the first and the second half of its n boundaries x, lo = x[0,
// h) and hi = x[h, n) (h = ceil(n / 2)), of which it writes both Q, at s
// and at h + s (PAIRED false). K5's callers pass the lo and then the hi
// boundaries of segments (coverage_step), so its items are K3's segments
// and its tiles span what K3's do; a tile of consecutive boundaries would
// hold the last lo and the first hi, whose span is the whole axis. Bound
// on the H100: the dependent loads of the search where the queries are
// few (the chr path's 300 segments over 15.2M events; the step path's
// 600 boundaries over 2^21), the bytes where they are many (a -w 150
// grid's 1M-window chunks; the exome's 200,000 regions). A thread a
// boundary running a binary search would chain log2 E + 1 loads.
// Instead a block takes a tile of EP_TILE_MIN or more consecutive items
// (the launcher sizes the grid to one resident wave, or to EP_TILE_MIN
// items a block where that is fewer blocks), and decides per tile at run
// time:
//   dense  (more than EP_TILE_MIN items): find the lower bounds rmin and
//          rmax of the tile's least and greatest boundary; every boundary
//          of the tile has its r in [rmin, rmax]. If rmax - rmin <=
//          EP_WIN, stage pos[rmin, rmax) in shared memory and finish each
//          search there, a thread's lo and hi at once (staged_eval). If
//          not, do the same for each sub-tile of EP_THREADS items, inside
//          [rmin, rmax].
//   sparse (a small tile, or a sub-tile whose span does not fit): a pair
//          of g-lane groups an item (16 lanes for up to EP_TILE_MIN items,
//          fewer for more), inside the span when it is known
//          (sparse_eval).
// At 15.2M events a 16-lane search takes ceil(log17 E) = 6 rounds, plus
// the gather: 7 dependent loads for a boundary, against 25. Registers are
// capped for EP_MIN_BLOCKS blocks an SM: a larger wave of smaller dense
// tiles was faster on a 1M-window chunk of a -w 150 grid (0.0318 against
// 0.0353 ms, H100 80GB HBM3 at 700 W, tools/kernel_ab.py); four segments
// a thread in flight was 7x slower there. Fixed tiles of EP_THREADS
// segments, one block each, took 6x the wave's time on the chr path's
// 300 segments and 1.28x on the -w 150 chunk; tiles of b / 1024
// segments, 8 to 256, 1.28x on the chunk (same card, tools/kernel_ab.py).
// A K5 tile of consecutive boundaries, one search a thread, took 0.0200
// ms on the exome's 400,000 boundaries (lo, then hi) against K3's 0.0093
// on their 200,000 segments (same card, tools/kernel_ab.py).
constexpr int EP_THREADS = 256;        // threads per block, K3, K5, rows
constexpr int EP_WARPS = EP_THREADS / 32;
constexpr int EP_TILE_MIN = 8;         // items: 16 lanes a boundary
constexpr int EP_WIN = 3072;           // event words a dense tile stages
constexpr int EP_MIN_BLOCKS = 8;       // blocks an SM (registers capped)

// The lower bounds, in pos[a, z), of the least (mn) and greatest (mx)
// of the block's boundaries, into *r0 and *r1 of every thread: a block
// reduction, then two 16-lane groups of warp 0. Every thread calls it.
template <typename P>
__device__ __forceinline__ void block_span(const P* __restrict__ pos,
                                           int64_t a, int64_t z, P mn, P mx,
                                           P (*red)[EP_WARPS],
                                           int64_t* span, int64_t* r0,
                                           int64_t* r1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const P u = __shfl_xor_sync(0xffffffffu, mn, o);
        const P v = __shfl_xor_sync(0xffffffffu, mx, o);
        mn = u < mn ? u : mn;
        mx = v > mx ? v : mx;
    }
    if (lane == 0) {
        red[0][warp] = mn;
        red[1][warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
        mn = red[0][0];
        mx = red[1][0];
        for (int w = 1; w < EP_WARPS; ++w) {
            mn = red[0][w] < mn ? red[0][w] : mn;
            mx = red[1][w] > mx ? red[1][w] : mx;
        }
        const int64_t r = group_lower_bound<P>(pos, a, z, lane < 16 ? mn : mx,
                                               16, lane & 15, lane & 16);
        if ((lane & 15) == 0) span[lane >> 4] = r;
    }
    __syncthreads();
    *r0 = span[0];
    *r1 = span[1];
}

// Q(x) of a boundary whose lower bound lies in [a, a + cnt], with
// pos[a, a + cnt) staged in win: a binary search in shared memory, then
// the gathers.
template <typename P>
__device__ __forceinline__ void window_q(const P* win, int cnt, int64_t a,
                                         const P* __restrict__ pos,
                                         const int32_t* __restrict__ depth,
                                         const int64_t* __restrict__ c_cov,
                                         const int64_t* __restrict__ c_sum,
                                         int32_t min_dep, P x, u64* q_cov,
                                         u64* q_sum) {
    int i = 0, j = cnt;
    while (i < j) {
        const int m = (i + j) >> 1;
        if (win[m] < x) i = m + 1;
        else j = m;
    }
    const int64_t r = a + i;
    u64 cov = r >= 2 ? (u64)c_cov[r - 2] : 0;
    u64 sum = r >= 2 ? (u64)c_sum[r - 2] : 0;
    if (r >= 1) {
        const P p = i >= 1 ? win[i - 1] : pos[r - 1];
        const int32_t dep = depth[r - 1];
        const u64 part = dep >= min_dep ? (u64)((int64_t)x - (int64_t)p) : 0;
        cov += part;
        sum += part * (u64)(int64_t)dep;
    }
    *q_cov = cov;
    *q_sum = sum;
}

// Item s's result from the Q of its lo (ca, sa) and of its hi (cb, sb):
// K3's Q(hi) - Q(lo) into out0[s], out1[s]; K5's Q(lo) there and, where
// the item has a hi (s < nhi), Q(hi) into out0[n + s], out1[n + s].
template <bool PAIRED>
__device__ __forceinline__ void put_item(int64_t s, int64_t n, int64_t nhi,
                                         u64 ca, u64 sa, u64 cb, u64 sb,
                                         int64_t* __restrict__ out0,
                                         int64_t* __restrict__ out1) {
    if constexpr (PAIRED) {
        out0[s] = (int64_t)(cb - ca);
        out1[s] = (int64_t)(sb - sa);
    } else {
        out0[s] = (int64_t)ca;
        out1[s] = (int64_t)sa;
        if (s < nhi) {   // K5's odd last boundary has no hi
            out0[n + s] = (int64_t)cb;
            out1[n + s] = (int64_t)sb;
        }
    }
}

// The items [s0, s1) of a block in shared memory, if the lower bounds of
// their boundaries, searched in pos[*a, *z), span at most EP_WIN events:
// the least and greatest boundary by a block reduction (min and max, so
// any query order is right), their lower bounds (block_span, into *a and
// *z whether they fit or not), pos[*a, *z) staged with coalesced loads,
// then each boundary's window_q, an item's two at once; the gathers of
// sorted queries fall on neighbouring rows. Items from nhi on have no hi
// (K5's odd last boundary). Returns whether they fitted. Every thread
// calls it.
template <typename P, bool PAIRED>
__device__ __forceinline__ bool staged_eval(const P* __restrict__ pos,
                                            const int32_t* __restrict__ depth,
                                            const int64_t* __restrict__ c_cov,
                                            const int64_t* __restrict__ c_sum,
                                            int32_t min_dep,
                                            const P* __restrict__ lo,
                                            const P* __restrict__ hi,
                                            int64_t n, int64_t nhi,
                                            int64_t s0, int64_t s1, P* win,
                                            P (*red)[EP_WARPS],
                                            int64_t* span, int64_t* a,
                                            int64_t* z,
                                            int64_t* __restrict__ out0,
                                            int64_t* __restrict__ out1) {
    const int tid = threadIdx.x;
    P mn = lo[s0], mx = mn;
#pragma unroll 4
    for (int64_t s = s0 + tid; s < s1; s += EP_THREADS) {
        const P x0 = lo[s], x1 = PAIRED || s < nhi ? hi[s] : x0;
        mn = x0 < mn ? x0 : mn;
        mn = x1 < mn ? x1 : mn;
        mx = x0 > mx ? x0 : mx;
        mx = x1 > mx ? x1 : mx;
    }
    block_span<P>(pos, *a, *z, mn, mx, red, span, a, z);
    if (*z - *a > EP_WIN) return false;
    const int cnt = (int)(*z - *a);
#pragma unroll 4
    for (int j = tid; j < cnt; j += EP_THREADS) win[j] = pos[*a + j];
    __syncthreads();
    for (int64_t s = s0 + tid; s < s1; s += EP_THREADS) {
        u64 ca, sa, cb, sb;
        window_q<P>(win, cnt, *a, pos, depth, c_cov, c_sum, min_dep, lo[s],
                    &ca, &sa);
        window_q<P>(win, cnt, *a, pos, depth, c_cov, c_sum, min_dep,
                    PAIRED || s < nhi ? hi[s] : lo[s], &cb, &sb);
        put_item<PAIRED>(s, n, nhi, ca, sa, cb, sb, out0, out1);
    }
    return true;
}

// The m <= EP_THREADS items from s0 with lane groups, their lower bounds
// searched in pos[a, z): a pair of g-lane groups an item, one on lo and
// one on hi, block-uniform rounds; then the gather round, and the hi
// group's Q goes to the lo group's first lane by one shuffle.
template <typename P, bool PAIRED>
__device__ __forceinline__ void sparse_eval(const P* __restrict__ pos,
                                            const int32_t* __restrict__ depth,
                                            const int64_t* __restrict__ c_cov,
                                            const int64_t* __restrict__ c_sum,
                                            int32_t min_dep,
                                            const P* __restrict__ lo,
                                            const P* __restrict__ hi,
                                            int64_t n, int64_t nhi,
                                            int64_t s0, int m, int64_t a,
                                            int64_t z,
                                            int64_t* __restrict__ out0,
                                            int64_t* __restrict__ out1) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int g = group_size(2 * m, EP_THREADS);
    const int pairs = EP_THREADS / (2 * g);
    const int pair = tid / (2 * g), side = (tid / g) & 1;
    const int gl = tid & (g - 1), first = lane & ~(g - 1);
    for (int j0 = 0; j0 < m; j0 += pairs) {
        const int64_t s = s0 + j0 + pair;
        const bool has = j0 + pair < m && (PAIRED || side == 0 || s < nhi);
        const P x = has ? (side ? hi[s] : lo[s]) : P(0);
        const int64_t r = group_lower_bound<P>(pos, has ? a : 0, has ? z : 0,
                                               x, g, gl, first);
        u64 cov, sum;
        group_q<P>(pos, depth, c_cov, c_sum, min_dep, r, x, g, gl, first,
                   &cov, &sum);
        const u64 cov_hi = __shfl_down_sync(0xffffffffu, cov, g);
        const u64 sum_hi = __shfl_down_sync(0xffffffffu, sum, g);
        if (has && side == 0 && gl == 0)
            put_item<PAIRED>(s, n, nhi, cov, sum, cov_hi, sum_hi, out0, out1);
    }
}

// n items (K3: segments lo/hi, nhi = n; K5: lo = x, hi = x + n, nhi the
// boundaries past the first n).
template <typename P, bool PAIRED>
__global__ void __launch_bounds__(EP_THREADS, EP_MIN_BLOCKS)
search_eval_kernel(const P* __restrict__ pos,
                   const int32_t* __restrict__ depth,
                   const int64_t* __restrict__ c_cov,
                   const int64_t* __restrict__ c_sum, int64_t e,
                   int32_t min_dep, const P* __restrict__ lo,
                   const P* __restrict__ hi, int64_t n, int64_t nhi,
                   int64_t tile, int64_t* __restrict__ out0,
                   int64_t* __restrict__ out1) {
    __shared__ int64_t win_words[EP_WIN];
    __shared__ P red[2][EP_WARPS];
    __shared__ int64_t span[2];
    P* win = reinterpret_cast<P*>(win_words);
    const int64_t s0 = (int64_t)blockIdx.x * tile;
    const int64_t s1 = s0 + tile < n ? s0 + tile : n;
    int64_t a = 0, z = e;   // where the tile's lower bounds lie
    if (s1 - s0 > EP_TILE_MIN
        && staged_eval<P, PAIRED>(pos, depth, c_cov, c_sum, min_dep, lo, hi,
                                  n, nhi, s0, s1, win, red, span, &a, &z,
                                  out0, out1))
        return;
    // by sub-tiles of EP_THREADS items inside the tile's span
    for (int64_t base = s0; base < s1; base += EP_THREADS) {
        const int m = (int)(s1 - base < EP_THREADS ? s1 - base : EP_THREADS);
        int64_t sa = a, sz = z;
        if (s1 - s0 > EP_THREADS && m > EP_TILE_MIN
            && staged_eval<P, PAIRED>(pos, depth, c_cov, c_sum, min_dep, lo,
                                      hi, n, nhi, base, base + m, win, red,
                                      span, &sa, &sz, out0, out1))
            continue;
        sparse_eval<P, PAIRED>(pos, depth, c_cov, c_sum, min_dep, lo, hi, n,
                               nhi, base, m, sa, sz, out0, out1);
    }
}

// ---------------------------------------------------------------------
// K6 extract_events — replaces pandepth_tpu/device/events.py:
// extract_events (and, with the engine's tier sentinel and position
// dtype, the clamp-and-cast of pandepth_tpu/device/engine.py:add_batch).
// Bound on the H100: memory. Per CIGAR op it must read op_code/op_len/
// op_read (12 B) and its read's row (tid/pos/flag/mapq, 16 B a read) and
// write two positions and two deltas (16-24 B).
// JAX rebases a global exclusive cumsum of ref-consumed lengths per read
// with segment_min over op_read: with op_read non-decreasing and op_len
// non-negative (a BAM length is 28-bit unsigned), as JAX's sorted
// segment_min also assumes, the minimum of a read's prefixes is its first
// op's, so an op's offset is the sum of the ref-consumed lengths of the
// earlier ops of its read: a segmented exclusive scan whose heads are the
// ops with i == 0 or op_read[i - 1] != op_read[i], equal to JAX's modulo
// 2^64. The design is one pass, one launch: a tile of EXT_TILE ops (an
// atomic counter hands out the tile ids) loads its three op columns
// striped (coalesced) into shared memory, scans them on the blocked
// layout (EXT_ITEMS consecutive ops a thread), and writes each op's
// offset back to shared memory; then each op, striped again, gathers its
// read's row, filters, clips and writes its two events, so the stores
// coalesce. Only a read that runs into a tile from an earlier one needs a
// carry: a tile that holds a head publishes its sum since its last head
// at once as an inclusive prefix (ST_INC), which ends every chain through
// it, and reads back for its first ops only if they continue a read; a
// tile without a head publishes its sum as an aggregate (ST_AGG) and
// looks back. Only a read of more than a tile of ops makes a chain.

constexpr int32_t REF_CONSUME_MASK = 0x18D;  // M D N = X
constexpr int32_t DEPTH_MASK = 0x181;        // M = X
constexpr int64_t DEAD_POS = 1LL << 62;      // JAX's dead-slot SENTINEL

// Tiles of 1,024 ops: a 2^20-op batch is 1,024 tiles, about eight for
// each of the 132 SMs; the fastest of 512, 1,024 and 2,048 on an H100
// (PERF.md). The tile size is also pandepth_tpu_torch/synth.py's
// EXTRACT_TILE, which chip_smoke.py holds to the library's.
constexpr int EXT_THREADS = 256;
constexpr int EXT_ITEMS = 4;
constexpr int EXT_TILE = EXT_THREADS * EXT_ITEMS;

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

// A segmented sum over a span of ops: `head` when a read starts in it,
// `sum` the sum since its last head (all of it without one). Combining
// an earlier span a with a later b gives (a.head || b.head,
// b.head ? b.sum : a.sum + b.sum).
__device__ __forceinline__ void warp_seg_inclusive_scan(int& head, u64& sum) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int h = __shfl_up_sync(0xffffffffu, head, o);
        const u64 s = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) {
            if (!head) sum += s;
            head |= h;
        }
    }
}

// Exclusive segmented scan of one (head, sum) per thread across the
// block, in place ((0, 0) for thread 0), with the block's whole span in
// (*tot_head, *tot_sum). All threads must call it.
__device__ void block_seg_exclusive_scan(int& head, u64& sum, int* warp_head,
                                         u64* warp_sum, int* tot_head,
                                         u64* tot_sum) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int h = head;
    u64 s = sum;
    warp_seg_inclusive_scan(h, s);
    if (lane == 31) {
        warp_head[warp] = h;
        warp_sum[warp] = s;
    }
    int eh = __shfl_up_sync(0xffffffffu, h, 1);
    u64 es = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) {
        eh = 0;
        es = 0;
    }
    __syncthreads();
    if (warp == 0) {
        int wh = lane < nwarps ? warp_head[lane] : 0;
        u64 ws = lane < nwarps ? warp_sum[lane] : 0;
        warp_seg_inclusive_scan(wh, ws);
        if (lane < nwarps) {
            warp_head[lane] = wh;
            warp_sum[lane] = ws;
        }
    }
    __syncthreads();
    const int ph = warp > 0 ? warp_head[warp - 1] : 0;
    const u64 ps = warp > 0 ? warp_sum[warp - 1] : 0;
    head = ph | eh;
    sum = eh ? es : ps + es;
    *tot_head = warp_head[nwarps - 1];
    *tot_sum = warp_sum[nwarps - 1];
    __syncthreads();  // warp_head / warp_sum are free again
}

template <typename Out>
__global__ void __launch_bounds__(EXT_THREADS)
extract_events_kernel(const int32_t* __restrict__ tid,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ flag,
                      const int32_t* __restrict__ mapq,
                      const int32_t* __restrict__ op_code,
                      const int32_t* __restrict__ op_len,
                      const int32_t* __restrict__ op_read, int64_t m,
                      int64_t n, const int64_t* __restrict__ offsets,
                      const int64_t* __restrict__ limits, int64_t n_targets,
                      int32_t flags_mask, int32_t min_mapq, int64_t sentinel,
                      Out* __restrict__ ev_pos, int32_t* __restrict__ ev_delta,
                      unsigned* counter, Lookback scan) {
    __shared__ int32_t s_code[padded_size<int32_t>(EXT_TILE)];
    __shared__ int32_t s_len[padded_size<int32_t>(EXT_TILE)];
    __shared__ int32_t s_read[padded_size<int32_t>(EXT_TILE)];
    __shared__ u64 s_off[padded_size<u64>(EXT_TILE)];
    __shared__ int warp_head[32];
    __shared__ u64 warp_sum[32];
    __shared__ u64 prefix[1];
    __shared__ int32_t s_prev;   // op_read of the op before the tile
    __shared__ unsigned s_tile;
    const int t = threadIdx.x;
    if (t == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t base = tile * EXT_TILE;
    if (t == 0) s_prev = base > 0 ? op_read[base - 1] : 0;
#pragma unroll
    for (int k = 0; k < EXT_ITEMS; ++k) {   // striped, coalesced
        const int j = k * EXT_THREADS + t;
        const int64_t i = base + j;
        const bool in = i < m;
        s_code[padded<int32_t>(j)] = in ? op_code[i] : 0;
        s_len[padded<int32_t>(j)] = in ? op_len[i] : 0;
        s_read[padded<int32_t>(j)] = in ? op_read[i] : 0;
    }
    __syncthreads();

    const int j0 = t * EXT_ITEMS;   // blocked from here
    u64 clen[EXT_ITEMS];
    unsigned heads = 0;             // bit k: op j0 + k starts a read
    int head = 0;
    u64 sum = 0;
    int32_t prev = j0 ? s_read[padded<int32_t>(j0 - 1)] : s_prev;
#pragma unroll
    for (int k = 0; k < EXT_ITEMS; ++k) {
        const int j = j0 + k;
        const int64_t i = base + j;
        const int32_t r = s_read[padded<int32_t>(j)];
        const bool in = i < m;
        clen[k] = in ? ref_len(s_code[padded<int32_t>(j)],
                               s_len[padded<int32_t>(j)]) : 0;
        if (in && (i == 0 || r != prev)) {
            heads |= 1u << k;
            head = 1;
            sum = 0;
        }
        sum += clen[k];
        prev = r;
    }
    int tile_head;
    u64 tile_sum;
    block_seg_exclusive_scan(head, sum, warp_head, warp_sum, &tile_head,
                             &tile_sum);
    // the carry into the tile's first ops, from the tiles before it
    const bool first_head = base == 0 || s_read[0] != s_prev;
    u64 carry = 0;
    if (tile_head) {
        if (t == 0) {
            const u64 inc[1] = {tile_sum};
            publish<1>(scan, tile, inc, ST_INC);
        }
        if (!first_head) {
            if (t < 32) {
                u64 ex[1];
                look_back<1>(scan, 0, tile, ex);
                if (t == 0) prefix[0] = ex[0];
            }
            __syncthreads();
            carry = prefix[0];
        }
    } else {
        const u64 zero[1] = {0}, tot[1] = {tile_sum};
        u64 pre[1];
        tile_prefix<1>(scan, 0, tile, zero, tot, prefix, pre);
        carry = pre[0];
    }
    u64 run = head ? sum : carry + sum;
#pragma unroll
    for (int k = 0; k < EXT_ITEMS; ++k) {
        if (heads >> k & 1u) run = 0;
        s_off[padded<u64>(j0 + k)] = run;
        run += clen[k];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < EXT_ITEMS; ++k) {   // striped again
        const int j = k * EXT_THREADS + t;
        const int64_t i = base + j;
        if (i >= m) break;
        // an op_read outside [0, n) reads a clamped row (memory safety;
        // the decoders never produce one)
        const int32_t r_raw = s_read[padded<int32_t>(j)];
        const int64_t r = r_raw < 0 ? 0 : (r_raw < n ? r_raw : n - 1);
        const int32_t tr = tid[r];
        bool keep = (flag[r] & flags_mask) == 0 && tr >= 0;
        if (min_mapq >= 1) keep = keep && mapq[r] >= min_mapq;
        // JAX gathers at max(tid, 0) and clamps past the last target
        const int64_t ts = tr < 0 ? 0 : (tr < n_targets ? tr : n_targets - 1);
        const int64_t lo = offsets[ts];
        const int64_t hi = limits[ts];
        const int32_t len = s_len[padded<int32_t>(j)];
        // int64 sums wrap as in JAX
        int64_t start = (int64_t)((u64)lo + (u64)(int64_t)pos[r]
                                  + s_off[padded<u64>(j)]);
        int64_t end = (int64_t)((u64)start + (u64)(int64_t)len);
        start = clip64(start, lo, hi);
        end = clip64(end, lo, hi);
        const bool live = op_bit(DEPTH_MASK, s_code[padded<int32_t>(j)])
                          && keep && len > 0 && end > start;
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
// format carries a length plane with escapes of its own, corrected by
// (exc - esc); the const format one length per row for its first ns[r]
// slots, 0 after them.
// Bound on the H100: memory. Per slot it must read 1-2 B of codes per
// plane and write the start and end words and their +-1 deltas: 12 B
// per slot in the int32 tier, 24 B in the others, plus the codes. The
// design is one pass, one launch per group of up to DEC_MAX_BLOCKS blocks
// (their planes' pointers ride in the launch's parameters): rows are
// independent, and within a row the tiles chain from the row's base
// through a decoupled look-back on the start-delta sum (tile ids from one
// counter, mapped row-major over the group's rows, so a tile's
// predecessors hold lower ids). A tile decodes
// its codes into shared memory (striped loads, coalesced), adds every
// escape entry of its row that lands in it, then scans, publishes, and
// writes each output once (striped stores). Escapes follow JAX's
// scatter-add, not the engine's ascending lists: each tile reads its
// row's whole list (CE int32 slots per plane, from L2), entries may come
// in any order, duplicates add (shared-memory atomics), and entries
// outside [0, CAP) -- unused ones hold CAP -- are dropped.
// Tier arithmetic (A): JAX computes in the position dtype, and int32 and
// uint32 wrap there, so the two 32-bit tiers sum in uint32 (the uint32
// tier's words are then zero-extended to int64) and the int64 tier in
// uint64. The output words (W) are int32 in the int32 tier, int64 else.
// Zero tail slots and zero rows decode to zero-length events at the
// previous position: depth-neutral, and kept, as in JAX.

// Tiles of 4,096 slots: each tile reads its row's whole escape list, so
// larger tiles read it fewer times.
constexpr int DEC_THREADS = 256;
constexpr int DEC_ITEMS = 16;
constexpr int DEC_TILE = DEC_THREADS * DEC_ITEMS;
constexpr int DEC_MAX_BLOCKS = 16;

// The blocks of one group: each block's codes, escapes and slots, and the
// group row its first row is.
template <typename C>
struct DecBlocks {
    const C* codes[DEC_MAX_BLOCKS];
    const int64_t* excs[DEC_MAX_BLOCKS];
    const int32_t* slots[DEC_MAX_BLOCKS];
    int64_t row0[DEC_MAX_BLOCKS];
    int n;
};

template <typename C, typename W, typename A, bool CONST>
__global__ void __launch_bounds__(DEC_THREADS)
decode_enc_kernel(const DecBlocks<C> blk, const W* __restrict__ bases,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ ns, int64_t cap, int64_t ce,
                  int64_t ntiles, int64_t esc, W* __restrict__ starts,
                  W* __restrict__ ends, int32_t* __restrict__ ds,
                  int32_t* __restrict__ de, unsigned* counter,
                  Lookback scan) {
    extern __shared__ __align__(16) unsigned char smem[];
    A* sv = reinterpret_cast<A*>(smem);   // deltas, then starts
    A* sl = sv + padded_size<A>(DEC_TILE);  // lengths, then ends (mixed)
    __shared__ A warp_tot[32];
    __shared__ u64 prefix[1];
    __shared__ unsigned s_tile;
    const int tid = threadIdx.x;
    if (tid == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t g = tile / ntiles;   // the group's row
    int b = 0;                         // its block, and its row there
    while (b + 1 < blk.n && blk.row0[b + 1] <= g) ++b;
    const int64_t r = g - blk.row0[b];
    const int64_t j_lo = (tile - g * ntiles) * DEC_TILE;   // first slot
    const int64_t j_hi = j_lo + DEC_TILE < cap ? j_lo + DEC_TILE : cap;
    const C* cd = blk.codes[b] + r * (CONST ? 1 : 2) * cap;
    const int64_t* excs = blk.excs[b];
    const int32_t* slots = blk.slots[b];
    const int64_t out0 = g * cap;

#pragma unroll
    for (int k = 0; k < DEC_ITEMS; ++k) {   // striped, coalesced
        const int j = k * DEC_THREADS + tid;
        const int64_t s = j_lo + j;
        A delta = 0, len = 0;
        if (s < j_hi) {
            const A z = (A)cd[s];
            delta = (z >> 1) ^ ((A)0 - (z & (A)1));
            if (!CONST) len = (A)cd[cap + s];
            ds[out0 + s] = 1;
            de[out0 + s] = -1;
        }
        sv[padded<A>(j)] = delta;
        if (!CONST) sl[padded<A>(j)] = len;
    }
    __syncthreads();
    // zig(esc): what the plain zigzag decode gave an escape slot
    const int64_t zig_esc = (esc >> 1) ^ -(esc & 1);
    const int64_t row = r * (CONST ? 1 : 2) * ce;
    for (int64_t e = tid; e < ce; e += DEC_THREADS) {
        const int32_t sd = slots[row + e];
        if (sd >= j_lo && sd < j_hi)
            atomicAdd(&sv[padded<A>((int)(sd - j_lo))],
                      (A)(excs[row + e] - zig_esc));
        if (!CONST) {
            const int32_t sn = slots[row + ce + e];
            if (sn >= j_lo && sn < j_hi)
                atomicAdd(&sl[padded<A>((int)(sn - j_lo))],
                          (A)(excs[row + ce + e] - esc));
        }
    }
    __syncthreads();

    const int j0 = tid * DEC_ITEMS;   // blocked from here
    A v[DEC_ITEMS];
    A tsum = 0;
#pragma unroll
    for (int k = 0; k < DEC_ITEMS; ++k) {
        v[k] = sv[padded<A>(j0 + k)];
        tsum += v[k];
    }
    A tot;
    const A ex = block_exclusive_scan<A>(tsum, warp_tot, &tot);
    u64 pre[1];
    {
        const u64 base[1] = {(u64)(A)bases[g]}, t[1] = {(u64)tot};
        tile_prefix<1>(scan, g * ntiles, tile, base, t, prefix, pre);
    }
    A run = (A)pre[0] + ex;
#pragma unroll
    for (int k = 0; k < DEC_ITEMS; ++k) {
        run += v[k];
        sv[padded<A>(j0 + k)] = run;
        if (!CONST) sl[padded<A>(j0 + k)] += run;   // end = start + len
    }
    __syncthreads();
    const A ulen = CONST ? (A)(int64_t)lens[g] : (A)0;
    const int64_t live = CONST ? (int64_t)ns[g] : 0;
#pragma unroll
    for (int k = 0; k < DEC_ITEMS; ++k) {
        const int j = k * DEC_THREADS + tid;
        const int64_t s = j_lo + j;
        if (s < j_hi) {
            const A start = sv[padded<A>(j)];
            starts[out0 + s] = (W)start;
            ends[out0 + s] = (W)(CONST ? start + (s < live ? ulen : (A)0)
                                       : sl[padded<A>(j)]);
        }
    }
}

template <typename C, typename W, typename A, bool CONST>
int decode_enc_typed(const DecBlocks<C>& blk, const W* bases,
                     const int32_t* lens, const int32_t* ns, int64_t rows,
                     int64_t cap, int64_t ce, W* starts, W* ends,
                     int32_t* ds, int32_t* de, int64_t* scratch,
                     cudaStream_t st) {
    const int64_t ntiles = (cap + DEC_TILE - 1) / DEC_TILE;
    const int nv[1] = {1};
    unsigned* counter;
    Lookback scan;
    int64_t zeroed;
    carve_lookback(scratch, rows * ntiles, 1, nv, &counter, &scan, &zeroed);
    const int bytes = padded_size<A>(DEC_TILE) * (int)sizeof(A)
                      * (CONST ? 1 : 2);
    static std::atomic<u64> smem_set{0};
    cudaError_t err = allow_smem(decode_enc_kernel<C, W, A, CONST>, bytes,
                                 smem_set);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(scratch, 0, 8 * zeroed, st);
    if (err != cudaSuccess) return (int)err;
    decode_enc_kernel<C, W, A, CONST>
        <<<(unsigned int)(rows * ntiles), DEC_THREADS, bytes, st>>>(
            blk, bases, lens, ns, cap, ce, ntiles, (int64_t)(C)~(C)0,
            starts, ends, ds, de, counter, scan);
    return (int)cudaGetLastError();
}

template <typename C, bool CONST>
int decode_enc_tier(int tier, int nblocks, const void* const* codes,
                    const int64_t* const* excs, const int32_t* const* slots,
                    const int64_t* block_rows, const void* bases,
                    const int32_t* lens, const int32_t* ns, int64_t cap,
                    int64_t ce, void* starts, void* ends, int32_t* ds,
                    int32_t* de, int64_t* scratch, cudaStream_t st) {
    DecBlocks<C> blk;
    int64_t rows = 0;
    for (int b = 0; b < nblocks; ++b) {
        blk.codes[b] = (const C*)codes[b];
        blk.excs[b] = excs[b];
        blk.slots[b] = slots[b];
        blk.row0[b] = rows;
        rows += block_rows[b];
    }
    blk.n = nblocks;
    if (tier == TIER_I32)
        return decode_enc_typed<C, int32_t, uint32_t, CONST>(
            blk, (const int32_t*)bases, lens, ns, rows, cap, ce,
            (int32_t*)starts, (int32_t*)ends, ds, de, scratch, st);
    if (tier == TIER_U32)
        return decode_enc_typed<C, int64_t, uint32_t, CONST>(
            blk, (const int64_t*)bases, lens, ns, rows, cap, ce,
            (int64_t*)starts, (int64_t*)ends, ds, de, scratch, st);
    if (tier == TIER_I64)
        return decode_enc_typed<C, int64_t, u64, CONST>(
            blk, (const int64_t*)bases, lens, ns, rows, cap, ce,
            (int64_t*)starts, (int64_t*)ends, ds, de, scratch, st);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// K9 _sharded_steps — replaces pandepth_tpu/sharding/engine.py:
// _sharded_steps (finalize :81, eval_only :101, local_eval :73). The
// genome axis is cut into ranges, one per row of a (rows, width) event
// block (slot 0 of each row reserved for the carry event, the rest the
// range's events, sentinel-padded with delta 0). Each row is sorted (the
// library sort) and scanned (K2, row by row); shard_carry_kernel and
// eval_pair_rows_kernel are the rest of it.
//
// shard_carry: the depth carried into each range from the ranges to its
// left, injected as the row's first event (JAX: all_gather of the
// per-device delta totals, an exclusive prefix, concatenated in front).
// Bound on the H100: memory. It reads the int32 delta block once (4 B
// per slot) and writes three words per row. One launch, after one memset
// of its ticket and row sums, of one resident wave of blocks:
//   1. the block, flattened (rows x width slots), is cut into runs of
//      CARRY_RUN slots, and each block takes the same number of
//      consecutive runs; for each row its slots meet (past the row's slot
//      0) it sums them in 16-byte loads, CARRY_LOADS a thread in flight,
//      from the aligned address at or below the first (a row starts at
//      slot r * width, an odd one in the engine's blocks), the words
//      outside the slots masked in the first and the last vector (an
//      aligned 16-byte vector never crosses a page, so those are mapped),
//      reduces the sums in u64 (warp shuffles, then one shared word a
//      warp) and adds the block's sum to the row's with an atomic in L2.
//   2. each block takes a ticket, an atomic with release semantics; the
//      first warp of the last block to arrive (acquire) does the carries:
//      one exclusive scan of `left` (the totals of the rows on earlier
//      devices) and then the row sums (read past L1, ld.cg), whose value
//      at row r is its carry, into each row's total, its carry cast to
//      int32 (wrapping as JAX's astype(int32)) in the delta row's slot 0,
//      and bounds[r] in the position row's slot 0.
// Slot 0 sorts first among equal positions under the stable sort, as
// JAX's concatenation [carry, row] does. A block pays its ticket once.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py, 8 rows of
// 2^21 + 1 slots, the kernel's device ms): a block a run, each writing
// its partial for the last block to scan, 0.0309 with runs of 8,192
// slots (2,056 blocks), 0.0434 with 2,048; a block a run adding to its
// row's sum, 0.0295, 0.0347 and 0.0475 with runs of 4,096, 2,048 and
// 1,024; one wave of equal shares, 0.0258 (4 blocks an SM, 8 loads in
// flight; 8 blocks and 4 loads 0.0274), of which 0.0238 is the stream
// alone. The run is also pandepth_tpu_torch/synth.py's CARRY_RUN, which
// chip_smoke.py holds to the library's.
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_MIN_BLOCKS = 4;   // blocks an SM: the wave
constexpr int CARRY_LOADS = 8;        // 16-byte loads a thread in flight
constexpr int CARRY_RUN = 1024;       // slots: the unit of a block's share

__device__ __forceinline__ int64_t sum4(int4 v) {
    return (int64_t)v.x + (int64_t)v.y + (int64_t)v.z + (int64_t)v.w;
}

template <typename P>
__global__ void __launch_bounds__(CARRY_THREADS, CARRY_MIN_BLOCKS)
shard_carry_kernel(int32_t* delta, int64_t width, int64_t rows,
                   int64_t share, const int64_t* __restrict__ bounds,
                   const int64_t* __restrict__ left, int64_t n_left,
                   P* __restrict__ pos, int64_t* __restrict__ totals,
                   unsigned* __restrict__ ticket, u64* __restrict__ row_sum) {
    __shared__ u64 warp_tot[32];
    __shared__ bool last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t slots = rows * width;
    const int64_t a0 = (int64_t)blockIdx.x * share;
    const int64_t a = a0 < slots ? a0 : slots;
    const int64_t z = a + share < slots ? a + share : slots;
    // delta's distance in words below a 16-byte boundary: vector q holds
    // slots 4q - mis .. 4q - mis + 3
    const int mis = (int)((reinterpret_cast<uintptr_t>(delta) >> 2) & 3);
    const int4* vec = reinterpret_cast<const int4*>(delta - mis);
    for (int64_t r = a / width; r < rows && r * width < z; ++r) {
        const int64_t g0 = a > r * width ? a : r * width + 1;
        const int64_t g1 = z < (r + 1) * width ? z : (r + 1) * width;
        int64_t acc = 0;
        if (g0 < g1) {
            // vectors qa..qb hold [g0, g1); those between them lie inside
            const int64_t qa = (g0 + mis) >> 2, qb = (g1 - 1 + mis) >> 2;
            constexpr int T = CARRY_THREADS, L = CARRY_LOADS;
            int64_t q = qa + 1 + tid;
            for (; q + (L - 1) * T < qb; q += L * T) {
                int4 v[L];
#pragma unroll
                for (int k = 0; k < L; ++k) v[k] = vec[q + k * T];
#pragma unroll
                for (int k = 0; k < L; ++k) acc += sum4(v[k]);
            }
            for (; q < qb; q += T) acc += sum4(vec[q]);
            if (tid < (qb > qa ? 2 : 1)) {   // the first and the last vector
                const int64_t qe = tid ? qb : qa, e = 4 * qe - mis;
                const int4 v = vec[qe];
                acc += (e >= g0 && e < g1 ? (int64_t)v.x : 0)
                     + (e + 1 >= g0 && e + 1 < g1 ? (int64_t)v.y : 0)
                     + (e + 2 >= g0 && e + 2 < g1 ? (int64_t)v.z : 0)
                     + (e + 3 >= g0 && e + 3 < g1 ? (int64_t)v.w : 0);
            }
        }
        u64 x = (u64)acc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == 0) warp_tot[warp] = x;
        __syncthreads();
        if (tid == 0 && g0 < g1) {
            u64 t = 0;
            for (int w = 0; w < CARRY_THREADS / 32; ++w) t += warp_tot[w];
            atomicAdd(row_sum + r, t);
        }
        __syncthreads();   // warp_tot is read before the next row's sums
    }
    // the ticket releases the block's row sums; the last block's acquires
    // every block's
    if (tid == 0) last = atom_add_acq_rel(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last || warp) return;
    fence_acquire();
    // the last block's first warp: the exclusive scan of left's totals
    // and then the row sums, 32 a round; at row r it is the row's carry
    const int64_t m = n_left + rows;
    u64 run = 0;
    for (int64_t base = 0; base < m; base += 32) {
        const int64_t i = base + lane, r = i - n_left;
        const u64 v = i < n_left ? (u64)left[i]
                    : i < m ? __ldcg(row_sum + r) : 0;
        const u64 inc = warp_inclusive_scan(v);
        if (r >= 0 && i < m) {
            totals[r] = (int64_t)v;
            delta[r * width] = (int32_t)(uint32_t)(run + inc - v);
            pos[r * width] = (P)bounds[r];
        }
        run += __shfl_sync(0xffffffffu, inc, 31);
    }
}

// eval_pair_rows: K3 over a stack of rows, each segment clipped to each
// row's range [bounds[r], bounds[r+1]] (JAX's jnp.clip in local_eval)
// and Q(hi) - Q(lo) summed over the rows in int64 (JAX's psum over the
// devices, here over the rows of one device). Bound on the H100: the
// dependent loads of the searches. A segment's clip is empty (l == h,
// Q(l) - Q(h) = 0 exactly) in every row but those its span crosses, and
// with the cuts non-decreasing (the engine's range cuts) those are the
// rows [R0, R1) with bounds[r] < max(lo, hi) and bounds[r + 1] >
// min(lo, hi): a warp takes a segment, finds R0 and R1 by binary
// searches of the cuts (staged in shared memory when there are at most
// EP_BOUNDS of them, else read where they are), and runs the 2 (R1 - R0)
// searches of its (row, lo) and (row, hi) clips at once, in groups of
// as many lanes as go round (16 for a segment inside one range), each
// group_lower_bound's (g + 1)-way search of its row; then the warp sums
// the signed Q in u64, which wraps as JAX's int64 sum does and does not
// depend on the order, and lane 0 writes it.
constexpr int EP_BOUNDS = 4096;   // range cuts staged in shared memory

// the first i in [0, n) with a[i] >= x (strict: a[i] > x), n if none
template <bool STRICT>
__device__ __forceinline__ int64_t first_at(const int64_t* a, int64_t n,
                                            int64_t x) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t m = (lo + hi) >> 1;
        if (STRICT ? a[m] <= x : a[m] < x) lo = m + 1;
        else hi = m;
    }
    return lo;
}

template <typename P>
__global__ void __launch_bounds__(EP_THREADS)
eval_pair_rows_kernel(const P* __restrict__ pos,
                      const int32_t* __restrict__ depth,
                      const int64_t* __restrict__ c_cov,
                      const int64_t* __restrict__ c_sum, int64_t rows,
                      int64_t width, const int64_t* __restrict__ bounds,
                      int32_t min_dep, const int64_t* __restrict__ lo,
                      const int64_t* __restrict__ hi, int64_t b,
                      int64_t* __restrict__ cover,
                      int64_t* __restrict__ dsum) {
    __shared__ int64_t staged[EP_BOUNDS];
    const int lane = threadIdx.x & 31;
    const int64_t* bd = bounds;
    if (rows + 1 <= EP_BOUNDS) {
        for (int j = threadIdx.x; j <= rows; j += EP_THREADS)
            staged[j] = bounds[j];
        __syncthreads();
        bd = staged;
    }
    const int64_t s = (int64_t)blockIdx.x * EP_WARPS + (threadIdx.x >> 5);
    if (s >= b) return;   // a whole warp
    const int64_t x0 = lo[s], x1 = hi[s];
    const int64_t u = x0 < x1 ? x0 : x1, v = x0 < x1 ? x1 : x0;
    // the first row with bounds[r] >= v, and the first with bounds[r+1] > u
    const int64_t r1 = first_at<false>(bd, rows, v);
    const int64_t r0 = first_at<true>(bd + 1, rows, u);
    const int64_t items = r1 > r0 ? 2 * (r1 - r0) : 0;
    const int g = group_size(items, 32);
    const int gl = lane & (g - 1), first = lane & ~(g - 1);
    u64 cov = 0, sum = 0;
    for (int64_t base = 0; base < items; base += 32 / g) {
        const int64_t item = base + lane / g;
        const bool has = item < items;
        const int64_t r = r0 + (has ? item >> 1 : 0);
        const int64_t a = has ? bd[r] : 0, z = has ? bd[r + 1] : 0;
        const P x = (P)clip64(item & 1 ? x1 : x0, a, z);
        const int64_t off = r * width;
        const int64_t idx = group_lower_bound<P>(pos + off, 0,
                                                 has ? width : 0, x, g, gl,
                                                 first);
        u64 qc, qs;
        group_q<P>(pos + off, depth + off, c_cov + off, c_sum + off,
                   min_dep, idx, x, g, gl, first, &qc, &qs);
        if (has && gl == 0) {
            if (item & 1) {
                cov += qc;
                sum += qs;
            } else {
                cov -= qc;
                sum -= qs;
            }
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        cov += __shfl_xor_sync(0xffffffffu, cov, o);
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) {
        cover[s] = (int64_t)cov;
        dsum[s] = (int64_t)sum;
    }
}

// ---------------------------------------------------------------------
// K10 bucket_events — replaces the bucketing of
// pandepth_tpu/sharding/mesh.py:_bucket_exchange: its searchsorted of
// bounds[1:-1], its segment_sum of the deltas by destination, and its
// sort_key_val by destination with the scatter into the send rows.
// A stable counting sort of the live events (delta != 0) by destination
// range: the r with bounds[r] <= pos < bounds[r + 1], found by a binary
// search of the world - 1 inner cuts held in shared memory (positions
// compared as int64, the uint32 tier's words zero-extended) and so
// clipped to world - 1. Dead events go nowhere. Bound on the H100:
// memory; the bound counts one read of each event's position word and
// delta and one write (16 B an event in the 32-bit tiers). No pass can
// know where a destination's run starts before every tile is counted, so
// the design, Onesweep's (Adinets and Merrill, NVIDIA 2022) for a single
// digit, reads the events twice and writes them once (24 B an event):
// two launches after one memset of the scratch, over tiles of BUCKET_TILE
// events.
//   1. bucket_hist_kernel: each destination's live count and delta sum
//      through a shared-memory histogram (a thread's run of one
//      destination added at once, a warp's runs of one destination
//      summed first), then global atomics into the scratch.
//   2. bucket_scatter_kernel, one chained-scan pass, tile ids from an
//      atomic counter, taken from the input's end (where pass 1 left the
//      L2 cache) back to its start: each warp ranks the 32 lanes of each
//      round of its contiguous sub-chunk by destination (up to 32 ranges
//      by ballots of the destination's bits, with a register count of
//      one destination a lane, and one warp then scans the warps' counts;
//      past 32 with __match_any_sync and shared-memory counts and
//      block-wide scans); the tile publishes each destination's count at
//      once in a (tile x destination) status array, one 64-bit word each
//      (the flag in the high bits, the count in the low 32, so there is
//      no value/flag pair and no fence), and resolves each destination's
//      count in the later chunks by a decoupled look-back, the block's
//      lanes shared among the destinations; with pass 1's counts, scanned
//      in each block for every destination's first output slot, that
//      places the tile's run of each destination; the tile stages its
//      live events in shared memory in destination order and writes each
//      run contiguously, so the stores coalesce.
// The output is ordered by destination, then chunk of the input, warp,
// round and lane: input order within a destination, the stable order of
// JAX's sort_key_val that array-equal sweep state needs.

// Tiles of 4,096 events (256 threads, 16 rounds of a warp each; 2,048 and
// 8,192 were slower on an H100, PERF.md). The tile size is also
// pandepth_tpu_torch/synth.py's BUCKET_TILE, which chip_smoke.py holds to
// the library's.
constexpr int BUCKET_THREADS = 256;
constexpr int BUCKET_WARPS = BUCKET_THREADS / 32;
constexpr int BUCKET_ROUNDS = 16;                       // per warp
constexpr int BUCKET_SUB = 32 * BUCKET_ROUNDS;          // events per warp
constexpr int BUCKET_TILE = BUCKET_WARPS * BUCKET_SUB;  // events per block
constexpr int BUCKET_MAX_WORLD = 1024;

// a packed status word: the flag above bit 32, the count below
constexpr u64 PK_AGG = 1ull << 32;   // the tile's own count
constexpr u64 PK_INC = 2ull << 32;   // its inclusive prefix

__device__ __forceinline__ void st_relaxed64(u64* p, u64 v) {
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ u64 ld_relaxed64(const u64* p) {
    u64 v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

// searchsorted(cuts, x, side="right"): the number of cuts <= x
__device__ __forceinline__ int find_dest(const int64_t* cuts, int ncuts,
                                         int64_t x) {
    int lo = 0, hi = ncuts;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cuts[mid] <= x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// In-place exclusive scan of a[0, len) in shared memory by the block,
// each thread a run of consecutive entries; returns the total. All
// threads must call it.
__device__ uint32_t block_scan_in_place(uint32_t* a, int len,
                                        uint32_t* warp_tot) {
    const int per = (len + blockDim.x - 1) / blockDim.x;
    const int lo = threadIdx.x * per;
    const int hi = lo + per < len ? lo + per : len;
    uint32_t s = 0;
    for (int k = lo; k < hi; ++k) s += a[k];
    uint32_t tot;
    uint32_t run = block_exclusive_scan<uint32_t>(s, warp_tot, &tot);
    for (int k = lo; k < hi; ++k) {
        const uint32_t v = a[k];
        a[k] = run;
        run += v;
    }
    __syncthreads();
    return tot;
}

template <typename W>
__global__ void __launch_bounds__(BUCKET_THREADS)
bucket_hist_kernel(const W* __restrict__ pos,
                   const int32_t* __restrict__ delta, int64_t n,
                   const int64_t* __restrict__ bounds, int world,
                   uint32_t* __restrict__ hcount, u64* __restrict__ hsum) {
    __shared__ int64_t cuts[BUCKET_MAX_WORLD];
    __shared__ uint32_t hist[BUCKET_MAX_WORLD];
    __shared__ u64 hs[BUCKET_MAX_WORLD];
    for (int d = threadIdx.x; d < world; d += BUCKET_THREADS) {
        if (d < world - 1) cuts[d] = bounds[d + 1];
        hist[d] = 0;
        hs[d] = 0;
    }
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * BUCKET_TILE;
    W p[BUCKET_ROUNDS];
    int32_t dl[BUCKET_ROUNDS];
#pragma unroll
    for (int k = 0; k < BUCKET_ROUNDS; ++k) {   // striped, coalesced
        const int64_t i = base + (int64_t)k * BUCKET_THREADS + threadIdx.x;
        dl[k] = i < n ? delta[i] : 0;
        p[k] = i < n ? pos[i] : W(0);
    }
    int cur = -1;
    uint32_t run = 0;
    u64 run_sum = 0;
#pragma unroll
    for (int k = 0; k < BUCKET_ROUNDS; ++k) {
        if (dl[k] == 0) continue;
        const int d = find_dest(cuts, world - 1, (int64_t)p[k]);
        if (d != cur) {
            if (run) {
                atomicAdd(&hist[cur], run);
                atomicAdd(&hs[cur], run_sum);
            }
            cur = d;
            run = 0;
            run_sum = 0;
        }
        ++run;
        run_sum += (u64)(int64_t)dl[k];
    }
    // a warp whose runs all hold one destination adds them once
    const unsigned held = __ballot_sync(0xffffffffu, run != 0);
    if (held) {
        const int d0 = __shfl_sync(0xffffffffu, cur, __ffs(held) - 1);
        if (__all_sync(0xffffffffu, run == 0 || cur == d0)) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                run += __shfl_xor_sync(0xffffffffu, run, o);
                run_sum += __shfl_xor_sync(0xffffffffu, run_sum, o);
            }
            if ((threadIdx.x & 31) == 0) {
                atomicAdd(&hist[d0], run);
                atomicAdd(&hs[d0], run_sum);
            }
        } else if (run) {
            atomicAdd(&hist[cur], run);
            atomicAdd(&hs[cur], run_sum);
        }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < world; d += BUCKET_THREADS) {
        if (hist[d]) {
            atomicAdd(&hcount[d], hist[d]);
            atomicAdd(&hsum[d], hs[d]);
        }
    }
}

// For each destination d of the tile, the sum of its counts in the tiles
// before `tile`, into excl[d], from the packed status words
// status[p * world + d]; the tile's inclusive prefix (that plus tcnt[d])
// is then published. A group of L lanes (a power of two, L * world <=
// BUCKET_THREADS where it can be) takes one destination at a time: lane j
// reads the predecessor at distance j + 1, then L further back each pass,
// until one lane of the group finds an inclusive prefix. All threads must
// call it.
__device__ void bucket_look_back(u64* status, int world, int64_t tile,
                                 const uint32_t* tcnt, uint32_t* excl) {
    int L = 32;
    while (L > 1 && L * world > BUCKET_THREADS) L >>= 1;
    const int lane = threadIdx.x & 31;
    const int j = lane & (L - 1);
    const int first = lane - j;   // the group's first lane
    const unsigned mask =
        (L == 32 ? 0xffffffffu : (1u << L) - 1u) << first;
    const int groups = BUCKET_THREADS / L;
    for (int d0 = 0; d0 < world; d0 += groups) {
        const int d = d0 + (int)threadIdx.x / L;
        bool todo = d < world;
        uint32_t sum = 0;
        for (int64_t p = tile - 1 - j; __any_sync(0xffffffffu, todo);
             p -= L) {
            u64 w;   // a tile before the first reads as an inclusive zero
            while (true) {
                w = todo && p >= 0 ? ld_relaxed64(status + p * world + d)
                                   : PK_INC;
                if (!__any_sync(0xffffffffu, w == 0)) break;
                __nanosleep(LOOKBACK_SLEEP_NS);
            }
            // lanes up to the group's first inclusive prefix add theirs
            const unsigned inc =
                __ballot_sync(0xffffffffu, todo && w >= PK_INC) & mask;
            const int stop = inc ? __ffs(inc) - 1 : first + L - 1;
            uint32_t v = todo && lane <= stop ? (uint32_t)w : 0u;
            for (int o = L >> 1; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            sum += v;
            if (inc) todo = false;
        }
        if (d < world && j == 0) {
            excl[d] = sum;
            st_relaxed64(status + tile * world + d,
                         PK_INC | (u64)(sum + tcnt[d]));
        }
    }
}

// the scatter's dynamic shared memory for `world` destinations: the
// staged positions, the cuts, then the staged deltas, each warp's count
// of each destination, and each destination's tile count, tile offset,
// first output slot and tile prefix (uint32), then each staged event's
// destination (uint16)
template <typename W>
__host__ __device__ constexpr int bucket_smem(int world) {
    return BUCKET_TILE * (int)sizeof(W) + 8 * world
           + 4 * (BUCKET_TILE + BUCKET_WARPS * world + 4 * world)
           + 2 * BUCKET_TILE;
}

template <typename W, bool SMALL>
__global__ void __launch_bounds__(BUCKET_THREADS)
bucket_scatter_kernel(const W* __restrict__ pos,
                      const int32_t* __restrict__ delta, int64_t n,
                      const int64_t* __restrict__ bounds, int world,
                      const uint32_t* __restrict__ hcount,
                      const u64* __restrict__ hsum, W* __restrict__ out_pos,
                      int32_t* __restrict__ out_delta,
                      uint32_t* __restrict__ counts, u64* __restrict__ sums,
                      unsigned* counter, u64* status) {
    extern __shared__ __align__(16) unsigned char smem[];
    W* s_pos = reinterpret_cast<W*>(smem);
    int64_t* cuts = reinterpret_cast<int64_t*>(s_pos + BUCKET_TILE);
    int32_t* s_delta = reinterpret_cast<int32_t*>(cuts + world);
    uint32_t* slot = reinterpret_cast<uint32_t*>(s_delta + BUCKET_TILE);
    uint32_t* tcnt = slot + BUCKET_WARPS * world;
    uint32_t* toff = tcnt + world;
    uint32_t* first = toff + world;
    uint32_t* excl = first + world;
    uint16_t* s_dst = reinterpret_cast<uint16_t*>(excl + world);
    __shared__ uint32_t warp_tot[32];
    __shared__ unsigned s_tile;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    if (t == 0) s_tile = atomicAdd(counter, 1u);
    for (int d = t; d < world; d += BUCKET_THREADS) {
        if (d < world - 1) cuts[d] = bounds[d + 1];
        first[d] = hcount[d];
    }
    for (int k = t; k < BUCKET_WARPS * world; k += BUCKET_THREADS)
        slot[k] = 0;
    __syncthreads();
    const int64_t tile = s_tile;
    if (tile == 0) {   // pass 1's totals are the call's counts and sums
        for (int d = t; d < world; d += BUCKET_THREADS) {
            counts[d] = hcount[d];
            sums[d] = hsum[d];
        }
    }
    // tile ids run from the input's end, where pass 1 left the L2 cache
    const int64_t chunk = (n + BUCKET_TILE - 1) / BUCKET_TILE - 1 - tile;
    const int64_t sub = chunk * BUCKET_TILE + (int64_t)warp * BUCKET_SUB;
    uint32_t* mine = slot + warp * world;
    W p[BUCKET_ROUNDS];
    int32_t dl[BUCKET_ROUNDS];
#pragma unroll
    for (int r = 0; r < BUCKET_ROUNDS; ++r) {   // each round coalesced
        const int64_t i = sub + r * 32 + lane;
        dl[r] = i < n ? delta[i] : 0;
        p[r] = i < n ? pos[i] : W(0);
    }
    // each event's destination d and its place among its warp's events of
    // d, as d << 16 | place (d = world: dead or past the end)
    const unsigned below = (1u << lane) - 1u;
    uint32_t dat[BUCKET_ROUNDS];
    uint32_t live;
    if constexpr (SMALL) {
        // world <= 32: lane e counts destination e in a register; a lane's
        // peers are the lanes that agree with it on every bit of d
        const int bits = world > 1 ? 32 - __clz(world - 1) : 0;
        uint32_t c = 0;
#pragma unroll
        for (int r = 0; r < BUCKET_ROUNDS; ++r) {
            const int d = dl[r] != 0
                              ? find_dest(cuts, world - 1, (int64_t)p[r])
                              : world;
            unsigned peers = __ballot_sync(0xffffffffu, d < world);
            unsigned mine_e = peers;   // the lanes whose d is this lane
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                if (k < bits) {
                    const unsigned b = __ballot_sync(0xffffffffu, d >> k & 1);
                    peers &= d >> k & 1 ? b : ~b;
                    mine_e &= lane >> k & 1 ? b : ~b;
                }
            }
            const uint32_t before = __shfl_sync(0xffffffffu, c, d & 31);
            dat[r] = (uint32_t)d << 16
                     | (d < world ? before + __popc(peers & below) : 0u);
            c += __popc(mine_e);
        }
        if (lane < world) slot[warp * world + lane] = c;
        __syncthreads();
        // warp 0, lane d: each warp's first place, the tile's count and
        // offset, the destination's first output slot
        if (warp == 0) {
            uint32_t n_d = 0;
            if (lane < world) {
                for (int w = 0; w < BUCKET_WARPS; ++w) {
                    const uint32_t x = slot[w * world + lane];
                    slot[w * world + lane] = n_d;
                    n_d += x;
                }
            }
            const uint32_t f = lane < world ? first[lane] : 0u;
            uint32_t inc_n = warp_inclusive_scan(n_d);
            uint32_t inc_f = warp_inclusive_scan(f);
            if (lane < world) {
                tcnt[lane] = n_d;
                toff[lane] = inc_n - n_d;
                first[lane] = inc_f - f;
                st_relaxed64(status + tile * world + lane,
                             (tile == 0 ? PK_INC : PK_AGG) | n_d);
            }
            if (lane == 31) warp_tot[0] = inc_n;
        }
        __syncthreads();
        live = warp_tot[0];
    } else {
#pragma unroll
        for (int r = 0; r < BUCKET_ROUNDS; ++r) {
            const int d = dl[r] != 0
                              ? find_dest(cuts, world - 1, (int64_t)p[r])
                              : world;
            const unsigned peers = __match_any_sync(0xffffffffu, d);
            dat[r] = (uint32_t)d << 16
                     | (d < world ? mine[d] + __popc(peers & below) : 0u);
            __syncwarp();
            if (d < world && lane == __ffs(peers) - 1)
                mine[d] += __popc(peers);
            __syncwarp();
        }
        __syncthreads();
        // each warp's first place per destination, the tile's counts
        for (int d = t; d < world; d += BUCKET_THREADS) {
            uint32_t c = 0;
            for (int w = 0; w < BUCKET_WARPS; ++w) {
                const uint32_t x = slot[w * world + d];
                slot[w * world + d] = c;
                c += x;
            }
            tcnt[d] = c;
            toff[d] = c;
        }
        __syncthreads();
        live = block_scan_in_place(toff, world, warp_tot);
        block_scan_in_place(first, world, warp_tot);
        for (int d = t; d < world; d += BUCKET_THREADS)
            st_relaxed64(status + tile * world + d,
                         (tile == 0 ? PK_INC : PK_AGG) | tcnt[d]);
    }
    // staged in destination order while the predecessors finish
#pragma unroll
    for (int r = 0; r < BUCKET_ROUNDS; ++r) {
        const int d = (int)(dat[r] >> 16);
        if (d < world) {
            const uint32_t j = toff[d] + mine[d] + (dat[r] & 0xFFFFu);
            s_pos[j] = p[r];
            s_delta[j] = dl[r];
            s_dst[j] = (uint16_t)d;
        }
    }
    if (tile == 0) {
        for (int d = t; d < world; d += BUCKET_THREADS) excl[d] = 0;
    } else {
        bucket_look_back(status, world, tile, tcnt, excl);
    }
    __syncthreads();
    // where the tile's run of each destination starts, less its offset:
    // the look-back counted the later chunks (lower tile ids), so the
    // earlier ones hold the rest of pass 1's count
    for (int d = t; d < world; d += BUCKET_THREADS)
        excl[d] = first[d] + (hcount[d] - excl[d] - tcnt[d]) - toff[d];
    __syncthreads();
    for (int j = t; j < (int)live; j += BUCKET_THREADS) {   // coalesced
        const uint32_t to = excl[s_dst[j]] + j;
        out_pos[to] = s_pos[j];
        out_delta[to] = s_delta[j];
    }
}

// The int64 words of bucket_events' scratch: the tile counter, pass 1's
// delta sums (u64) and counts (u32) per destination, then the (tile x
// destination) status words; one memset zeroes all of it.
inline int64_t bucket_scratch_words(int64_t n, int world) {
    return 1 + world + (world + 1) / 2
           + (n + BUCKET_TILE - 1) / BUCKET_TILE * world;
}

template <typename W>
int bucket_events_typed(const W* pos, const int32_t* delta, int64_t n,
                        const int64_t* bounds, int world, W* out_pos,
                        int32_t* out_delta, uint32_t* counts, u64* sums,
                        int64_t* scratch, cudaStream_t st) {
    cudaError_t err;
    if (n <= 0) {
        err = cudaMemsetAsync(counts, 0, sizeof(uint32_t) * world, st);
        if (err == cudaSuccess)
            err = cudaMemsetAsync(sums, 0, sizeof(u64) * world, st);
        return (int)err;
    }
    const int64_t ntiles = (n + BUCKET_TILE - 1) / BUCKET_TILE;
    unsigned* counter = reinterpret_cast<unsigned*>(scratch);
    u64* hsum = reinterpret_cast<u64*>(scratch + 1);
    uint32_t* hcount = reinterpret_cast<uint32_t*>(scratch + 1 + world);
    u64* status = reinterpret_cast<u64*>(scratch + 1 + world
                                         + (world + 1) / 2);
    static std::atomic<u64> small_set{0}, large_set{0};
    err = world <= 32
        ? allow_smem(bucket_scatter_kernel<W, true>, bucket_smem<W>(32),
                     small_set)
        : allow_smem(bucket_scatter_kernel<W, false>,
                     bucket_smem<W>(BUCKET_MAX_WORLD), large_set);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(scratch, 0, 8 * bucket_scratch_words(n, world), st);
    if (err != cudaSuccess) return (int)err;
    bucket_hist_kernel<W><<<(unsigned int)ntiles, BUCKET_THREADS, 0, st>>>(
        pos, delta, n, bounds, world, hcount, hsum);
    if (world <= 32)
        bucket_scatter_kernel<W, true>
            <<<(unsigned int)ntiles, BUCKET_THREADS, bucket_smem<W>(world),
               st>>>(pos, delta, n, bounds, world, hcount, hsum, out_pos,
                     out_delta, counts, sums, counter, status);
    else
        bucket_scatter_kernel<W, false>
            <<<(unsigned int)ntiles, BUCKET_THREADS, bucket_smem<W>(world),
               st>>>(pos, delta, n, bounds, world, hcount, hsum, out_pos,
                     out_delta, counts, sums, counter, status);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// A measurement helper, not the counterpart of a JAX function: one
// thread follows k links of a chain (i = next[i], from i = 0), each
// load's address the value of the one before, read past L1 (ld.cg), and
// writes where it ends. Its time at two values of k gives the card's
// time a dependent load, on which the search kernels' bounds stand
// (chip_smoke.py).
__global__ void chase_kernel(const int64_t* __restrict__ next, int64_t k,
                             int64_t* __restrict__ out) {
    int64_t i = 0;
    for (int64_t j = 0; j < k; ++j)
        i = (int64_t)__ldcg(reinterpret_cast<const long long*>(next + i));
    *out = i;
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
    const int64_t ntiles = (n + SWEEP_TILE - 1) / SWEEP_TILE;
    const int nv[2] = {1, 2};   // the delta sum, the (cov, sum) pair
    unsigned* counter;
    Lookback stages[2];
    int64_t zeroed;
    carve_lookback(scratch, ntiles, 2, nv, &counter, stages, &zeroed);
    static std::atomic<u64> smem_set{0};
    cudaError_t err = allow_smem(sweep_scan_kernel<P>, SWEEP_SMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(scratch, 0, 8 * zeroed, st);
    if (err != cudaSuccess) return (int)err;
    sweep_scan_kernel<P>
        <<<(unsigned int)ntiles, SWEEP_THREADS, SWEEP_SMEM, st>>>(
        pos, delta, n, min_dep, wrap18, pmax, depth,
        reinterpret_cast<u64*>(c_cov), reinterpret_cast<u64*>(c_sum),
        counter, stages[0], stages[1]);
    return (int)cudaGetLastError();
}

// K3 (PAIRED: b segments lo/hi) or K5 (b boundaries lo; hi unused: its
// items are the pairs (lo[s], lo[h + s]), h = ceil(b / 2)). The grid is
// one resident wave (SMs x EP_MIN_BLOCKS: the block's 256 threads, its
// registers and its 24 KB of shared memory let 8 share an SM), or fewer
// where a block would get fewer than EP_TILE_MIN items; each block takes
// `tile` consecutive items and chooses its own path.
template <bool PAIRED>
int search_eval(int device, int pos64, const void* pos, const int32_t* depth,
                const int64_t* c_cov, const int64_t* c_sum, int64_t e,
                int32_t min_dep, const void* lo, const void* hi, int64_t b,
                int64_t* out0, int64_t* out1, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (b <= 0 || e <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int64_t n = PAIRED ? b : (b + 1) / 2, nhi = PAIRED ? b : b - n;
    const int word = pos64 ? 8 : 4;
    if (!PAIRED) hi = (const char*)lo + n * word;
    int64_t blocks = (n + EP_TILE_MIN - 1) / EP_TILE_MIN;
    if (blocks > (int64_t)sms * EP_MIN_BLOCKS)
        blocks = (int64_t)sms * EP_MIN_BLOCKS;   // one resident wave
    const int64_t tile = (n + blocks - 1) / blocks;
    blocks = (n + tile - 1) / tile;
    if (pos64)
        search_eval_kernel<int64_t, PAIRED>
            <<<(unsigned int)blocks, EP_THREADS, 0, st>>>(
            (const int64_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int64_t*)lo, (const int64_t*)hi, n, nhi, tile, out0,
            out1);
    else
        search_eval_kernel<int32_t, PAIRED>
            <<<(unsigned int)blocks, EP_THREADS, 0, st>>>(
            (const int32_t*)pos, depth, c_cov, c_sum, e, min_dep,
            (const int32_t*)lo, (const int32_t*)hi, n, nhi, tile, out0,
            out1);
    return (int)cudaGetLastError();
}

template <typename Out>
int extract_events_typed(const int32_t* tid, const int32_t* pos,
                         const int32_t* flag, const int32_t* mapq, int64_t n,
                         const int32_t* op_code, const int32_t* op_len,
                         const int32_t* op_read, int64_t m,
                         const int64_t* offsets, const int64_t* limits,
                         int64_t n_targets, int32_t flags_mask,
                         int32_t min_mapq, int64_t sentinel, Out* ev_pos,
                         int32_t* ev_delta, int64_t* scratch,
                         cudaStream_t st) {
    const int64_t ntiles = (m + EXT_TILE - 1) / EXT_TILE;
    const int nv[1] = {1};
    unsigned* counter;
    Lookback scan;
    int64_t zeroed;
    carve_lookback(scratch, ntiles, 1, nv, &counter, &scan, &zeroed);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * zeroed, st);
    if (err != cudaSuccess) return (int)err;
    extract_events_kernel<Out><<<(unsigned int)ntiles, EXT_THREADS, 0, st>>>(
        tid, pos, flag, mapq, op_code, op_len, op_read, m, n, offsets, limits,
        n_targets, flags_mask, min_mapq, sentinel, ev_pos, ev_delta, counter,
        scan);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The slots of shard_carry's runs, the unit of a block's share.
int64_t pdt_carry_run(void) { return CARRY_RUN; }

// Events per tile of sweep_scan, slots per tile of decode_enc, ops per
// tile of extract_events.
int64_t pdt_sweep_scan_tile(void) { return SWEEP_TILE; }
int64_t pdt_decode_enc_tile(void) { return DEC_TILE; }
int64_t pdt_extract_events_tile(void) { return EXT_TILE; }

// Event words a dense tile of eval_pair stages in shared memory.
int64_t pdt_eval_pair_win(void) { return EP_WIN; }

// The int64 words of scratch that sweep_scan takes for n events,
// decode_enc for a block of rows x cap slots and extract_events for m
// ops: tile counter, status words and look-back slots.
int64_t pdt_sweep_scan_scratch(int64_t n) {
    const int nv[2] = {1, 2};
    return carve_lookback(nullptr, (n + SWEEP_TILE - 1) / SWEEP_TILE, 2, nv,
                          nullptr, nullptr, nullptr);
}

int64_t pdt_decode_enc_scratch(int64_t rows, int64_t cap) {
    const int nv[1] = {1};
    return carve_lookback(nullptr, rows * ((cap + DEC_TILE - 1) / DEC_TILE),
                          1, nv, nullptr, nullptr, nullptr);
}

int64_t pdt_extract_events_scratch(int64_t m) {
    const int nv[1] = {1};
    return carve_lookback(nullptr, (m + EXT_TILE - 1) / EXT_TILE, 1, nv,
                          nullptr, nullptr, nullptr);
}

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

// K3 on b segments (lo, hi): (cover, dsum) into (out0, out1); pos/lo/hi
// int64 when pos64 is set, else int32.
int pdt_eval_pair(int device, int pos64, const void* pos,
                  const int32_t* depth, const int64_t* c_cov,
                  const int64_t* c_sum, int64_t e, int32_t min_dep,
                  const void* lo, const void* hi, int64_t b, int64_t* out0,
                  int64_t* out1, void* stream) {
    return search_eval<true>(device, pos64, pos, depth, c_cov, c_sum, e,
                             min_dep, lo, hi, b, out0, out1, stream);
}

// K5 on b boundaries x: (Q_cov, Q_sum) into (out0, out1); pos/x int64
// when pos64 is set, else int32.
int pdt_eval_boundaries(int device, int pos64, const void* pos,
                        const int32_t* depth, const int64_t* c_cov,
                        const int64_t* c_sum, int64_t e, int32_t min_dep,
                        const void* x, int64_t b, int64_t* out0,
                        int64_t* out1, void* stream) {
    return search_eval<false>(device, pos64, pos, depth, c_cov, c_sum, e,
                              min_dep, x, nullptr, b, out0, out1, stream);
}

// scratch: pdt_extract_events_scratch(m) int64 words. ev_pos is int64
// when pos64 is set, else int32. Dead slots hold 1 << 62, and every
// position is then clamped to at most `sentinel` (1 << 62 gives JAX's
// extract_events). op_read must be non-decreasing and op_len
// non-negative.
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
    if (n <= 0 || n_targets <= 0 || (m + EXT_TILE - 1) / EXT_TILE > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (pos64)
        return extract_events_typed<int64_t>(
            tid, pos, flag, mapq, n, op_code, op_len, op_read, m, offsets,
            limits, n_targets, flags_mask, min_mapq, sentinel,
            (int64_t*)ev_pos, ev_delta, scratch, st);
    return extract_events_typed<int32_t>(
        tid, pos, flag, mapq, n, op_code, op_len, op_read, m, offsets, limits,
        n_targets, flags_mask, min_mapq, sentinel, (int32_t*)ev_pos, ev_delta,
        scratch, st);
}

// K8 on a group of `nblocks` (1..pdt_decode_enc_max_blocks()) stacked
// blocks of windows of `cap` slots, block b of block_rows[b] windows:
// codes[b] are (rows, 2, cap) in the mixed format (plane 0 the zigzag
// start deltas, plane 1 the lengths) or (rows, cap) with `lens` and `ns`
// per group row in the const format; uint8 or, with code16, uint16.
// excs[b]/slots[b] are (rows, 2, ce) or (rows, ce). bases and the outputs
// are the tier's words. The group's row g (counted through the blocks in
// order) has its starts at starts[g * cap ...] and its ends at
// ends[g * cap ...], +1 in ds and -1 in de at the same slots. scratch:
// pdt_decode_enc_scratch(sum of block_rows, cap) int64 words.
int64_t pdt_decode_enc_max_blocks(void) { return DEC_MAX_BLOCKS; }

int pdt_decode_enc(int device, int tier, int code16, int is_const,
                   int nblocks, const void* const* codes,
                   const int64_t* const* excs, const int32_t* const* slots,
                   const int64_t* block_rows, const void* bases,
                   const int32_t* lens, const int32_t* ns, int64_t cap,
                   int64_t ce, void* starts, void* ends, int32_t* ds,
                   int32_t* de, int64_t* scratch, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks < 1 || nblocks > DEC_MAX_BLOCKS)
        return (int)cudaErrorInvalidValue;
    int64_t rows = 0;
    for (int b = 0; b < nblocks; ++b) rows += block_rows[b];
    if (rows <= 0 || cap <= 0) return (int)cudaGetLastError();
    if (rows * ((cap + DEC_TILE - 1) / DEC_TILE) > UINT32_MAX)
        return (int)cudaErrorInvalidValue;   // tile ids are 32-bit
    cudaStream_t st = (cudaStream_t)stream;
    if (code16)
        return is_const
            ? decode_enc_tier<uint16_t, true>(tier, nblocks, codes, excs,
                                              slots, block_rows, bases, lens,
                                              ns, cap, ce, starts, ends, ds,
                                              de, scratch, st)
            : decode_enc_tier<uint16_t, false>(tier, nblocks, codes, excs,
                                               slots, block_rows, bases, lens,
                                               ns, cap, ce, starts, ends, ds,
                                               de, scratch, st);
    return is_const
        ? decode_enc_tier<uint8_t, true>(tier, nblocks, codes, excs, slots,
                                         block_rows, bases, lens, ns, cap, ce,
                                         starts, ends, ds, de, scratch, st)
        : decode_enc_tier<uint8_t, false>(tier, nblocks, codes, excs, slots,
                                          block_rows, bases, lens, ns, cap,
                                          ce, starts, ends, ds, de, scratch,
                                          st);
}

// K9's carry on one device's (rows, width) block: pos is int64 when pos64
// is set, else int32; bounds holds at least `rows` range starts; left the
// n_left int64 totals of the rows on earlier devices (none: 0). Writes
// totals[rows] and slot 0 of every row. scratch: 1 + rows int64 words
// (its ticket and the row sums).
int pdt_shard_carry(int device, int pos64, void* pos, int32_t* delta,
                    int64_t rows, int64_t width, const int64_t* bounds,
                    const int64_t* left, int64_t n_left, int64_t* totals,
                    int64_t* scratch, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0) return (int)cudaGetLastError();
    if (width < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    // each of at most one wave of blocks takes the same number of runs
    const int64_t runs = (rows * width + CARRY_RUN - 1) / CARRY_RUN;
    const int64_t wave = (int64_t)sms * CARRY_MIN_BLOCKS;
    const int64_t per = (runs + wave - 1) / wave;
    const int64_t blocks = (runs + per - 1) / per;
    err = cudaMemsetAsync(scratch, 0, 8 * (1 + rows), st);
    if (err != cudaSuccess) return (int)err;
    unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
    u64* row_sum = reinterpret_cast<u64*>(scratch + 1);
    if (pos64)
        shard_carry_kernel<int64_t>
            <<<(unsigned int)blocks, CARRY_THREADS, 0, st>>>(
            delta, width, rows, per * CARRY_RUN, bounds, left, n_left,
            (int64_t*)pos, totals, ticket, row_sum);
    else
        shard_carry_kernel<int32_t>
            <<<(unsigned int)blocks, CARRY_THREADS, 0, st>>>(
            delta, width, rows, per * CARRY_RUN, bounds, left, n_left,
            (int32_t*)pos, totals, ticket, row_sum);
    return (int)cudaGetLastError();
}

// The chain walk of chase_kernel: k links of next from 0, the end into
// out[0].
int pdt_chase(int device, const int64_t* next, int64_t k, int64_t* out,
              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, k, out);
    return (int)cudaGetLastError();
}

// K9's clipped eval over `rows` sorted rows of `width` (the sweep state
// of each, row-major): bounds[rows + 1] int64, non-decreasing; lo/hi
// (b,) int64 global segment bounds; (cover, dsum) summed over the rows.
// A warp a segment.
int pdt_eval_pair_rows(int device, int pos64, const void* pos,
                       const int32_t* depth, const int64_t* c_cov,
                       const int64_t* c_sum, int64_t rows, int64_t width,
                       const int64_t* bounds, int32_t min_dep,
                       const int64_t* lo, const int64_t* hi, int64_t b,
                       int64_t* cover, int64_t* dsum, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (b <= 0) return (int)cudaGetLastError();
    if (rows <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned int blocks =
        (unsigned int)((b + EP_WARPS - 1) / EP_WARPS);
    if (pos64)
        eval_pair_rows_kernel<int64_t><<<blocks, EP_THREADS, 0, st>>>(
            (const int64_t*)pos, depth, c_cov, c_sum, rows, width, bounds,
            min_dep, lo, hi, b, cover, dsum);
    else
        eval_pair_rows_kernel<int32_t><<<blocks, EP_THREADS, 0, st>>>(
            (const int32_t*)pos, depth, c_cov, c_sum, rows, width, bounds,
            min_dep, lo, hi, b, cover, dsum);
    return (int)cudaGetLastError();
}

// Events per tile of bucket_events, the most ranges it takes, and the
// int64 words of scratch it takes for n events over `world` ranges.
int64_t pdt_bucket_tile(void) { return BUCKET_TILE; }
int64_t pdt_bucket_max_world(void) { return BUCKET_MAX_WORLD; }
int64_t pdt_bucket_events_scratch(int64_t n, int world) {
    return bucket_scratch_words(n, world);
}

// K10's bucketing of n events: pos in the tier's words (int32, uint32
// bit patterns, or int64), int32 deltas, bounds the world + 1 int64
// range cuts. Writes the live events ordered by destination range,
// stable, to the first sum(counts) slots of out_pos / out_delta, and
// each destination's live count (int32) and delta sum (int64).
int pdt_bucket_events(int device, int tier, const void* pos,
                      const int32_t* delta, int64_t n,
                      const int64_t* bounds, int world, void* out_pos,
                      int32_t* out_delta, int32_t* counts, int64_t* sums,
                      int64_t* scratch, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (world < 1 || world > BUCKET_MAX_WORLD || n < 0 || n > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t* c = reinterpret_cast<uint32_t*>(counts);
    u64* s = reinterpret_cast<u64*>(sums);
    if (tier == TIER_I32)
        return bucket_events_typed<int32_t>(
            (const int32_t*)pos, delta, n, bounds, world, (int32_t*)out_pos,
            out_delta, c, s, scratch, st);
    if (tier == TIER_U32)
        return bucket_events_typed<uint32_t>(
            (const uint32_t*)pos, delta, n, bounds, world,
            (uint32_t*)out_pos, out_delta, c, s, scratch, st);
    if (tier == TIER_I64)
        return bucket_events_typed<int64_t>(
            (const int64_t*)pos, delta, n, bounds, world, (int64_t*)out_pos,
            out_delta, c, s, scratch, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
