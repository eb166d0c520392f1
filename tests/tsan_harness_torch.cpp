// ThreadSanitizer harness for the port's libpancov_io
// (pandepth_tpu_torch/io/native/pancov_io.cpp): drives the whole-file
// stream's index-cut split walk (every thread reads, inflates and walks
// its own split; the in-order merge; the hand-off to the consumer), its
// fall back to the serial walk from a cut that does not match, and a
// consumer that closes the stream while the splits are in flight. Built
// and run by tests/test_torch_tsan.py; any data race makes TSAN print a
// WARNING and exit nonzero (halt_on_error=1).
//
// usage: harness file.bam cuts.i64   (cuts: the index's record starts,
// little-endian int64)
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
                         int64_t n_cuts, int64_t window_bytes,
                         char* err, int err_len);
int64_t pancov_stream_take_enc_acc(void* h, uint8_t* d8, uint8_t* l8,
                                   int64_t* excd, int64_t* excl,
                                   int64_t cap, int64_t exc_cap,
                                   int64_t* base_out,
                                   int64_t* n_excd_out,
                                   int64_t* n_excl_out);
int64_t pancov_stream_n_records(void* h);
int64_t pancov_stream_split_records(void* h);
void pancov_stream_close(void* h);
}

namespace {

struct Drained {
  int64_t pairs = 0, records = 0, split = 0;
  uint64_t digest = 1469598103934665603ull;  // FNV-1a of the codes
};

// open with `cuts` (may be empty), 3 threads, 1 MB windows; drain up
// to `max_takes` encoded buffers (-1: all), then close
bool drain(const char* path, const std::vector<int64_t>& cuts,
           int max_takes, Drained& out) {
  char err[256] = {0};
  void* h = pancov_stream_open(path, 3, 1796, -1, 512, nullptr, nullptr,
                               0, nullptr, nullptr, nullptr, 0, 0,
                               nullptr, 0,
                               cuts.empty() ? nullptr : cuts.data(),
                               (int64_t)cuts.size(), 1 << 20, err,
                               sizeof(err));
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
  pancov_stream_close(h);
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s file.bam cuts.i64\n", argv[0]);
    return 2;
  }
  std::vector<int64_t> cuts;
  {
    FILE* f = std::fopen(argv[2], "rb");
    if (!f) return 2;
    int64_t v;
    while (std::fread(&v, sizeof(v), 1, f) == 1) cuts.push_back(v);
    std::fclose(f);
  }
  // the cuts from the middle on one byte off: the serial walk takes over
  std::vector<int64_t> shifted(cuts);
  for (size_t i = shifted.size() / 2; i < shifted.size(); i++)
    shifted[i] += 1;

  Drained serial, split, fallback, early;
  if (!drain(argv[1], {}, -1, serial) || !drain(argv[1], cuts, -1, split) ||
      !drain(argv[1], shifted, -1, fallback) ||
      !drain(argv[1], cuts, 2, early))
    return 1;
  if (split.pairs != serial.pairs || split.digest != serial.digest ||
      split.records != serial.records || split.split != split.records ||
      fallback.pairs != serial.pairs || fallback.digest != serial.digest ||
      fallback.records != serial.records || fallback.split <= 0 ||
      fallback.split >= fallback.records || serial.split != 0) {
    std::fprintf(stderr,
                 "mismatch: serial %lld/%lld, split %lld/%lld/%lld, "
                 "fallback %lld/%lld/%lld\n",
                 (long long)serial.pairs, (long long)serial.records,
                 (long long)split.pairs, (long long)split.records,
                 (long long)split.split, (long long)fallback.pairs,
                 (long long)fallback.records, (long long)fallback.split);
    return 1;
  }
  std::printf("TSAN_HARNESS_OK pairs=%lld recs=%lld fallback_split=%lld\n",
              (long long)split.pairs, (long long)split.records,
              (long long)fallback.split);
  return 0;
}
