// AddressSanitizer and UndefinedBehaviorSanitizer harness for the port's
// BGZF inflate (inflate_block in pandepth_tpu_torch/io/native/pancov_io.cpp,
// through pancov_inflate_raw). Each case's payload and the 8 trailer bytes
// that follow a BGZF payload end exactly at the end of their allocation,
// and its output allocation is exactly its expected length, so any read
// or write outside them is reported. Built and run by
// tests/test_torch_inflate_asan.py; a report exits nonzero
// (-fno-sanitize-recover), as does a verdict or an output (its CRC-32)
// other than zlib's.
//
// usage: harness corpus.bin [exact | short_dst | short_src]
//   corpus: records of little-endian u32 payload length, u32 expected
//   length, u8 zlib's verdict (1: inflates to exactly that length), u32
//   the output's CRC-32, then the payload
//   short_dst: each case that inflates gets an output allocation one byte
//   short; short_src: a payload allocation one byte short and no trailer.
//   Both must be reported: they show that the check bites.
#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" int pancov_inflate_raw(const uint8_t* src, int64_t n,
                                  uint8_t* dst, int64_t dst_len);

static uint32_t u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

int main(int argc, char** argv) {
  if (argc < 2) return 2;
  const std::string mode = argc > 2 ? argv[2] : "exact";
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) return 2;
  std::vector<uint8_t> corpus;
  uint8_t buf[1 << 16];
  for (size_t got; (got = std::fread(buf, 1, sizeof buf, f)) > 0;)
    corpus.insert(corpus.end(), buf, buf + got);
  std::fclose(f);
  size_t off = 0, n = 0, n_ok = 0, wrong = 0;
  while (off + 13 <= corpus.size()) {
    const uint32_t len = u32(&corpus[off]), dst_len = u32(&corpus[off + 4]);
    const bool want = corpus[off + 8] != 0;
    const uint32_t crc = u32(&corpus[off + 9]);
    const uint8_t* payload = &corpus[off + 13];
    off += 13 + (size_t)len;
    if (mode != "exact" && (!want || dst_len == 0 || len == 0)) continue;
    const size_t src_size = mode == "short_src" ? len - 1 : (size_t)len + 8;
    const size_t dst_size = mode == "short_dst" ? dst_len - 1 : dst_len;
    uint8_t* src = (uint8_t*)std::malloc(src_size);
    uint8_t* dst = (uint8_t*)std::malloc(dst_size);
    std::memcpy(src, payload, std::min<size_t>(len, src_size));
    if (mode != "short_src") std::memset(src + len, 0xA5, 8);
    const bool ok = pancov_inflate_raw(src, len, dst, dst_len) != 0;
    if (ok != want ||
        (ok && crc32(0, dst, dst_len) != crc)) {
      if (wrong < 10)
        std::fprintf(stderr, "case %zu: verdict %d, zlib's %d\n", n, ok,
                     want);
      wrong++;
    }
    n++;
    n_ok += ok;
    std::free(src);
    std::free(dst);
  }
  std::printf("INFLATE_HARNESS cases=%zu ok=%zu wrong=%zu\n", n, n_ok,
              wrong);
  return wrong ? 1 : 0;
}
