#!/usr/bin/env python3
"""Where a tile of K10's chained-scan scatter (``bucket_scatter_kernel``
of ``pandepth_tpu_torch/csrc/sweep_kernels.cu``) spends its time, on one
NVIDIA GPU:

    python3 tools/scatter_phases.py [--world N] [--out DIR]

It copies the kernel source into ``--out`` (default
``chiprun_out/scatter_phases``), adds a read of the GPU's %globaltimer
by each block's thread 0 at the scatter's phase boundaries (after the
tile id, after the loads, after the ranking, scans and publishing, after
the staging, after the look-back, after the writes), and builds it with
``nvcc`` for sm_90a together with a small harness that calls
``pdt_bucket_events`` on 15,199,506 uint32-tier events (the chr path's
count: 7,599,753 sorted reads' starts on the 3 Gb genome axis, then
their ends 150 bp on) over ``--world`` equal ranges: five calls to warm
up, then one timed. It prints each phase's mean time per tile, the
scatter's span and the mean number of blocks resident at once. The
package's own kernels are not changed. A phase's mean includes its
waits: a block's thread 0 reads the clock when its own work is done.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "pandepth_tpu_torch", "csrc",
                      "sweep_kernels.cu")
PHASES = ("tile id", "loads", "rank+scans+publish", "stage", "look-back",
          "write")

PROBE = r'''__device__ unsigned long long* g_phase;
__device__ __forceinline__ unsigned long long phase_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}
#define PHASE(k) do { if (threadIdx.x == 0 && g_phase) \
    g_phase[blockIdx.x * 8 + (k)] = phase_clock(); } while (0)
'''

# (text in the scatter kernel, the same text with the probe placed)
MARKS = (
    ("    if (t == 0) s_tile = atomicAdd(counter, 1u);",
     "    PHASE(0);\n    if (t == 0) s_tile = atomicAdd(counter, 1u);"),
    ("    const int64_t tile = s_tile;\n",
     "    const int64_t tile = s_tile;\n    PHASE(1);\n"),
    ("    // each event's destination d and its place",
     "    if (dl[BUCKET_ROUNDS - 1] == 12345 && p[0] == W(7)) PHASE(7);\n"
     "    PHASE(2);\n    // each event's destination d and its place"),
    ("    // staged in destination order",
     "    PHASE(3);\n    // staged in destination order"),
    ("    if (tile == 0) {\n        for (int d = t; d < world; "
     "d += BUCKET_THREADS) excl[d] = 0;",
     "    PHASE(4);\n    if (tile == 0) {\n        for (int d = t; "
     "d < world; d += BUCKET_THREADS) excl[d] = 0;"),
    ("    __syncthreads();\n    // where the tile's run",
     "    __syncthreads();\n    PHASE(5);\n    // where the tile's run"),
    ("        out_delta[to] = s_delta[j];\n    }\n}",
     "        out_delta[to] = s_delta[j];\n    }\n    PHASE(6);\n}"),
)

HARNESS = r'''#include "kernels.cu"
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

int main(int argc, char** argv) {
    const int world = atoi(argv[1]);
    const int64_t n = 15199506, half = n / 2;
    const int64_t total = 12 * (250000000LL + 512);   // the genome axis
    std::vector<uint32_t> pos(n);
    std::vector<int32_t> dl(n);
    std::vector<uint64_t> st(half);
    std::mt19937_64 rng(3);
    for (auto& x : st) x = rng() % (uint64_t)(total - 200);
    std::sort(st.begin(), st.end());
    for (int64_t i = 0; i < half; ++i) {
        pos[i] = (uint32_t)st[i];
        dl[i] = 1;
        pos[half + i] = (uint32_t)(st[i] + 150);
        dl[half + i] = -1;
    }
    std::vector<int64_t> bounds(world + 1);
    const int64_t step = (total + world - 1) / world;
    for (int r = 0; r <= world; ++r) bounds[r] = std::min(r * step, total);
    const int64_t words = pdt_bucket_events_scratch(n, world);
    const int64_t ntiles = (n + pdt_bucket_tile() - 1) / pdt_bucket_tile();
    uint32_t *dp, *dop;
    int32_t *dd, *dod, *dc;
    int64_t *db, *ds, *dscr;
    unsigned long long* dph;
    cudaMalloc(&dp, 4 * n); cudaMalloc(&dop, 4 * n);
    cudaMalloc(&dd, 4 * n); cudaMalloc(&dod, 4 * n);
    cudaMalloc(&db, 8 * (world + 1)); cudaMalloc(&dc, 4 * world);
    cudaMalloc(&ds, 8 * world); cudaMalloc(&dscr, 8 * words);
    cudaMalloc(&dph, 8 * 8 * ntiles);
    cudaMemcpy(dp, pos.data(), 4 * n, cudaMemcpyHostToDevice);
    cudaMemcpy(dd, dl.data(), 4 * n, cudaMemcpyHostToDevice);
    cudaMemcpy(db, bounds.data(), 8 * (world + 1), cudaMemcpyHostToDevice);
    for (int k = 0; k < 5; ++k)
        pdt_bucket_events(0, 1, dp, dd, n, db, world, dop, dod, dc, ds,
                          dscr, 0);
    cudaDeviceSynchronize();
    cudaMemcpyToSymbol(g_phase, &dph, sizeof(dph));
    const int rc = pdt_bucket_events(0, 1, dp, dd, n, db, world, dop, dod,
                                     dc, ds, dscr, 0);
    const cudaError_t err = cudaDeviceSynchronize();
    if (rc != 0 || err != cudaSuccess) {
        printf("launch %d, %s\n", rc, cudaGetErrorString(err));
        return 1;
    }
    std::vector<unsigned long long> h(8 * ntiles);
    cudaMemcpy(h.data(), dph, 8 * 8 * ntiles, cudaMemcpyDeviceToHost);
    unsigned long long t0 = ~0ull, t1 = 0;
    double sum[7] = {0}, busy = 0;
    for (int64_t b = 0; b < ntiles; ++b) {
        const unsigned long long* p = &h[8 * b];
        t0 = std::min(t0, p[0]);
        t1 = std::max(t1, p[6]);
        busy += (double)(p[6] - p[0]);
        for (int k = 1; k < 7; ++k) sum[k] += (double)(p[k] - p[k - 1]);
    }
    printf("span %.1f us, %ld tiles, %.3f us a tile, %.1f blocks resident\n",
           (t1 - t0) / 1e3, (long)ntiles, busy / ntiles / 1e3,
           busy / (double)(t1 - t0));
    for (int k = 1; k < 7; ++k) printf("%.3f\n", sum[k] / ntiles / 1e3);
    return 0;
}
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "scatter_phases"))
    args = ap.parse_args()
    src = open(SOURCE).read()
    at = src.index("bucket_scatter_kernel(const W* __restrict__ pos,")
    head, kernel = src[:at], src[at:]
    for old, new in MARKS:
        if old not in kernel:
            print(f"scatter_phases: the kernel no longer holds {old!r}",
                  file=sys.stderr)
            return 1
        kernel = kernel.replace(old, new, 1)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernels.cu"), "w") as fh:
        fh.write(PROBE + head + kernel)
    with open(os.path.join(args.out, "harness.cu"), "w") as fh:
        fh.write(HARNESS)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    exe = os.path.join(args.out, "harness")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", exe,
                    os.path.join(args.out, "harness.cu")], check=True)
    r = subprocess.run([exe, str(args.world)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(f"scatter_phases: {r.stdout}{r.stderr}", file=sys.stderr)
        return 1
    lines = r.stdout.splitlines()
    print(f"bucket_scatter_kernel, 15,199,506 events, {args.world} ranges: "
          f"{lines[0]}")
    for name, us in zip(PHASES, lines[1:]):
        print(f"  {name:20s} {float(us):.3f} us a tile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
