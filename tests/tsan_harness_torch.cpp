// ThreadSanitizer harness for the port's libpancov_io
// (pandepth_tpu_torch/io/native/pancov_io.cpp): drives the stream's split
// walk on 3 threads (every thread reads, inflates and walks its own
// split; the in-order merge; the hand-off to the consumer) over the whole
// file cut at the index's record starts and over the ranges of a mode-1
// region filter, each against the serial walk of the same stream; the
// fall back to the serial walk from a split that does not end where its
// cut or range says; and a consumer that closes the stream while the
// splits are in flight. Built and run by tests/test_torch_tsan.py; any
// data race makes TSAN print a WARNING and exit nonzero
// (halt_on_error=1).
//
// usage: harness file.bam cuts.i64 ranged.i64
//   cuts: the index's record starts, little-endian int64
//   ranged: little-endian int64 n_off, n_regions, n_ranges, then the
//   read filter's per-contig offsets (n_off), starts and ends
//   (n_regions each), then the ranges' (v0, v1) pairs
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void* pancov_stream_open(const char* path, int n_threads,
                         uint32_t flags_mask, int32_t min_mapq,
                         int64_t pad, const int64_t* ext_offsets,
                         const int64_t* ext_limits, int64_t n_ext,
                         const int64_t* reg_off,
                         const int64_t* reg_start,
                         const int64_t* reg_end, int64_t n_regions,
                         int region_mode, const int64_t* vr,
                         int64_t n_vr, const int64_t* cuts,
                         int64_t n_cuts, int serial_walk,
                         int64_t window_bytes, char* err, int err_len);
int64_t pancov_stream_take_enc_acc(void* h, uint8_t* d8, uint8_t* l8,
                                   int64_t* excd, int64_t* excl,
                                   int64_t cap, int64_t exc_cap,
                                   int64_t* base_out,
                                   int64_t* n_excd_out,
                                   int64_t* n_excl_out);
int64_t pancov_stream_n_records(void* h);
int64_t pancov_stream_split_records(void* h);
int64_t pancov_stream_kept_records(void* h);
void pancov_stream_close(void* h);
}

namespace {

struct Drained {
  int64_t pairs = 0, records = 0, split = 0, kept = 0;
  uint64_t digest = 1469598103934665603ull;  // FNV-1a of the codes
};

// a mode-1 read filter and its ranges (empty: the whole file)
struct Ranged {
  std::vector<int64_t> off, start, end, vr;
};

// open with `cuts` (may be empty) or `rg`'s ranges, 3 threads, 1 MB
// windows, the serial walk where `serial`; drain up to `max_takes`
// encoded buffers (-1: all), then close
bool drain(const char* path, const std::vector<int64_t>& cuts,
           const Ranged& rg, bool serial, int max_takes, Drained& out) {
  char err[256] = {0};
  const bool ranged = !rg.vr.empty();
  void* h = pancov_stream_open(
      path, 3, 1796, -1, 512, nullptr, nullptr, 0,
      ranged ? rg.off.data() : nullptr, ranged ? rg.start.data() : nullptr,
      ranged ? rg.end.data() : nullptr,
      ranged ? (int64_t)rg.start.size() : 0, ranged ? 1 : 0,
      ranged ? rg.vr.data() : nullptr, (int64_t)rg.vr.size() / 2,
      cuts.empty() ? nullptr : cuts.data(), (int64_t)cuts.size(),
      serial ? 1 : 0, 1 << 20, err, sizeof(err));
  if (!h) {
    std::fprintf(stderr, "stream_open: %s\n", err);
    return false;
  }
  const int64_t cap = 1 << 14, ce = 1 << 8;
  std::vector<uint8_t> d8(cap), l8(cap);
  std::vector<int64_t> excd(ce), excl(ce);
  int64_t base, nd, nl;
  for (int t = 0; max_takes < 0 || t < max_takes; t++) {
    int64_t n = pancov_stream_take_enc_acc(h, d8.data(), l8.data(),
                                           excd.data(), excl.data(), cap,
                                           ce, &base, &nd, &nl);
    if (n == -2) {
      std::fprintf(stderr, "stream error\n");
      pancov_stream_close(h);
      return false;
    }
    if (n == 0) break;
    out.pairs += n;
    for (int64_t i = 0; i < n; i++)
      out.digest = (out.digest ^ (uint64_t)(d8[i] | l8[i] << 8)) *
                   1099511628211ull;
  }
  out.records = pancov_stream_n_records(h);
  out.split = pancov_stream_split_records(h);
  out.kept = pancov_stream_kept_records(h);
  pancov_stream_close(h);
  return true;
}

bool same(const Drained& a, const Drained& b) {
  return a.pairs == b.pairs && a.digest == b.digest &&
         a.records == b.records && a.kept == b.kept;
}

std::vector<int64_t> read_i64(const char* path) {
  std::vector<int64_t> v;
  FILE* f = std::fopen(path, "rb");
  if (!f) return v;
  int64_t x;
  while (std::fread(&x, sizeof(x), 1, f) == 1) v.push_back(x);
  std::fclose(f);
  return v;
}

void report(const char* what, const Drained& a, const Drained& b) {
  std::fprintf(stderr,
               "mismatch (%s): %lld/%lld/%lld/%lld split %lld against "
               "%lld/%lld/%lld/%lld split %lld\n",
               what, (long long)a.pairs, (long long)a.records,
               (long long)a.kept, (long long)(a.digest & 0xFFFF),
               (long long)a.split, (long long)b.pairs,
               (long long)b.records, (long long)b.kept,
               (long long)(b.digest & 0xFFFF), (long long)b.split);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s file.bam cuts.i64 ranged.i64\n",
                 argv[0]);
    return 2;
  }
  const std::vector<int64_t> cuts = read_i64(argv[2]);
  const std::vector<int64_t> flat = read_i64(argv[3]);
  if (cuts.empty() || flat.size() < 3) return 2;
  Ranged rg;
  {
    const int64_t no = flat[0], nr = flat[1], nv = flat[2];
    if ((int64_t)flat.size() != 3 + no + 2 * nr + 2 * nv) return 2;
    auto at = flat.begin() + 3;
    rg.off.assign(at, at + no);
    rg.start.assign(at + no, at + no + nr);
    rg.end.assign(at + no + nr, at + no + 2 * nr);
    rg.vr.assign(at + no + 2 * nr, flat.end());
  }
  // the cuts, and the ranges' ends, from the middle on one byte off: the
  // serial walk takes over from the first split they are in
  std::vector<int64_t> shifted(cuts);
  for (size_t i = shifted.size() / 2; i < shifted.size(); i++)
    shifted[i] += 1;
  Ranged rg_shifted(rg);
  for (size_t i = rg.vr.size() / 4; i < rg.vr.size() / 2; i++)
    rg_shifted.vr[2 * i + 1] += 1;
  const Ranged whole;

  Drained serial, split, fallback, early;
  Drained r_serial, r_split, r_fb_serial, r_fallback, r_early;
  if (!drain(argv[1], {}, whole, false, -1, serial) ||
      !drain(argv[1], cuts, whole, false, -1, split) ||
      !drain(argv[1], shifted, whole, false, -1, fallback) ||
      !drain(argv[1], cuts, whole, false, 2, early) ||
      !drain(argv[1], {}, rg, true, -1, r_serial) ||
      !drain(argv[1], {}, rg, false, -1, r_split) ||
      !drain(argv[1], {}, rg_shifted, true, -1, r_fb_serial) ||
      !drain(argv[1], {}, rg_shifted, false, -1, r_fallback) ||
      !drain(argv[1], {}, rg, false, 1, r_early))
    return 1;
  if (!same(split, serial) || split.split != split.records ||
      !same(fallback, serial) || fallback.split <= 0 ||
      fallback.split >= fallback.records || serial.split != 0) {
    report("whole file", split, serial);
    report("whole-file fallback", fallback, serial);
    return 1;
  }
  if (!same(r_split, r_serial) || r_split.split != r_split.records ||
      r_serial.split != 0 || r_split.records >= serial.records ||
      !same(r_fallback, r_fb_serial) || r_fallback.split <= 0 ||
      r_fallback.split >= r_fallback.records) {
    report("ranged", r_split, r_serial);
    report("ranged fallback", r_fallback, r_fb_serial);
    return 1;
  }
  std::printf("TSAN_HARNESS_OK pairs=%lld recs=%lld fallback_split=%lld "
              "ranged_pairs=%lld ranged_recs=%lld "
              "ranged_fallback_split=%lld\n",
              (long long)split.pairs, (long long)split.records,
              (long long)fallback.split, (long long)r_split.pairs,
              (long long)r_split.records, (long long)r_fallback.split);
  return 0;
}
