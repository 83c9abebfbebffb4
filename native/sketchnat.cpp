// Native host MinHash sketcher (bottom-s of MurmurHash3_x64_128 low
// 64 bits over canonical k-mers, k <= 15, seed 42).
//
// Numeric contract (bit-exact with dipper_tpu/sketch/minhash.py and
// tests/oracle.py, which transliterate the reference sketch engine,
// /root/reference/src/mash.cu:386-424):
//   - 2-bit encoding: A/other->0 C->1 G->2 T/U->3 (lowercase -> 0)
//   - canonical k-mer: min(lex form, bitwise-complemented LSB-first
//     form) == min(kmer, reverse complement) in lexicographic order
//   - hash: MurmurHash3_x64_128(seed 42) of the canonical k-mer's
//     ASCII spelling (MSB-first), low 64 bits
//   - sketch: bottom sketch_size hashes of all L-k+1 positions
//     (duplicates kept), ascending, padded with 0xFFFF...FF
//
// Why native: the CLI needs the bank HOST-side for np.unique rank
// compression. Hashing on the host removes a device-to-host copy of
// the bank and leaves the device free for tree building.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t C1 = 0x87c37b91114253d5ULL;
constexpr uint64_t C2 = 0x4cf5ad432745937fULL;
constexpr uint64_t F1 = 0xff51afd7ed558ccdULL;
constexpr uint64_t F2 = 0xc4ceb9fe1a85ec53ULL;

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= F1;
  k ^= k >> 33;
  k *= F2;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128 low 64 bits for keys of length 1..15 (tail-only
// path), seed 42. k1/k2 are the little-endian key words.
inline uint64_t murmur_low64_tail(uint64_t k1, uint64_t k2, int len) {
  uint64_t h1 = 42, h2 = 42;
  if (len > 8) {
    k2 *= C2;
    k2 = rotl64(k2, 33);
    k2 *= C1;
    h2 ^= k2;
  }
  k1 *= C1;
  k1 = rotl64(k1, 31);
  k1 *= C2;
  h1 ^= k1;
  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

struct Tables {
  uint8_t code[256];
  Tables() {
    std::memset(code, 0, sizeof(code));
    code[(unsigned)'C'] = 1;
    code[(unsigned)'G'] = 2;
    code[(unsigned)'T'] = 3;
    code[(unsigned)'U'] = 3;
  }
};
const Tables T;
const char BASE[4] = {'A', 'C', 'G', 'T'};

void sketch_one(const uint8_t* seq, int64_t len, int k, int s,
                uint64_t* out, std::vector<uint64_t>& heap) {
  const uint64_t SENT = ~0ULL;
  heap.clear();
  int64_t P = len - k + 1;
  if (P > 0) {
    const uint32_t mask = (1u << (2 * k)) - 1;
    uint32_t lex = 0, lsb = 0;
    for (int i = 0; i < k - 1; i++) {
      uint32_t c = T.code[seq[i]];
      lex = ((lex << 2) | c) & mask;
      lsb = (lsb >> 2) | (c << (2 * (k - 1)));
    }
    uint8_t key[16];
    std::memset(key, 0, sizeof(key));
    for (int64_t p = 0; p < P; p++) {
      uint32_t c = T.code[seq[p + k - 1]];
      lex = ((lex << 2) | c) & mask;
      lsb = (lsb >> 2) | (c << (2 * (k - 1)));
      uint32_t canon = std::min(lex, ~lsb & mask);
      for (int i = 0; i < k; i++)
        key[i] = (uint8_t)BASE[(canon >> (2 * (k - 1 - i))) & 3];
      uint64_t k1, k2;
      std::memcpy(&k1, key, 8);  // little-endian hosts only
      std::memcpy(&k2, key + 8, 8);
      uint64_t h = murmur_low64_tail(k1, k2, k);
      if ((int)heap.size() < s) {
        heap.push_back(h);
        std::push_heap(heap.begin(), heap.end());
      } else if (h < heap.front()) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = h;
        std::push_heap(heap.begin(), heap.end());
      }
    }
  }
  std::sort(heap.begin(), heap.end());
  size_t m = heap.size();
  std::memcpy(out, heap.data(), m * sizeof(uint64_t));
  for (size_t i = m; i < (size_t)s; i++) out[i] = SENT;
}

}  // namespace

extern "C" {

// buf: concatenated ASCII sequences; offs[n+1] byte offsets into buf;
// out: [n, sketch_size] u64, row-major. Returns 0 on success.
int sketchnat_sketch(const uint8_t* buf, const int64_t* offs, int64_t n,
                     int k, int sketch_size, int nthreads, uint64_t* out) {
  if (k < 2 || k > 15 || sketch_size < 1) return -1;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  std::atomic<int64_t> next{0};
  const int64_t GRAIN = 16;
  auto worker = [&]() {
    std::vector<uint64_t> heap;
    heap.reserve(sketch_size + 1);
    for (;;) {
      int64_t lo = next.fetch_add(GRAIN);
      if (lo >= n) break;
      int64_t hi = std::min(n, lo + GRAIN);
      for (int64_t i = lo; i < hi; i++)
        sketch_one(buf + offs[i], offs[i + 1] - offs[i], k, sketch_size,
                   out + (size_t)i * sketch_size, heap);
    }
  };
  for (int t = 1; t < nthreads; t++) ts.emplace_back(worker);
  worker();
  for (auto& th : ts) th.join();
  return 0;
}

}  // extern "C"
