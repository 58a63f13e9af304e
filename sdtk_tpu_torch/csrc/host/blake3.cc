// First-party portable BLAKE3 (one-shot) for sdtk_tpu_torch, implemented from the
// public BLAKE3 specification.  Exposed via a C ABI for ctypes binding
// (sdtk_tpu_torch/utils/hashing.py).  The reference toolkit shells out to the
// external `b3sum` CLI (reference speaker_detection:253-269); this library
// replaces that dependency.
#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint32_t kIV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};
constexpr int kMsgPerm[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kParent = 4, kRoot = 8;
constexpr size_t kChunkLen = 1024, kBlockLen = 64;

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline void g(uint32_t* v, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  v[a] += v[b] + mx;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] += v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] += v[b] + my;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] += v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

void compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
              uint32_t block_len, uint32_t flags, uint32_t out_cv[8]) {
  uint32_t v[16];
  std::memcpy(v, cv, 32);
  std::memcpy(v + 8, kIV, 16);
  v[12] = static_cast<uint32_t>(counter);
  v[13] = static_cast<uint32_t>(counter >> 32);
  v[14] = block_len;
  v[15] = flags;
  uint32_t m[16];
  std::memcpy(m, block, 64);
  for (int round = 0;; ++round) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (round == 6) break;
    uint32_t p[16];
    for (int i = 0; i < 16; ++i) p[i] = m[kMsgPerm[i]];
    std::memcpy(m, p, 64);
  }
  for (int i = 0; i < 8; ++i) out_cv[i] = v[i] ^ v[i + 8];
}

void load_block(const uint8_t* p, size_t len, uint32_t words[16]) {
  uint8_t buf[kBlockLen];
  std::memset(buf, 0, kBlockLen);
  std::memcpy(buf, p, len);
  for (int i = 0; i < 16; ++i) {
    words[i] = static_cast<uint32_t>(buf[4 * i]) |
               (static_cast<uint32_t>(buf[4 * i + 1]) << 8) |
               (static_cast<uint32_t>(buf[4 * i + 2]) << 16) |
               (static_cast<uint32_t>(buf[4 * i + 3]) << 24);
  }
}

// Compress one leaf chunk (<= 1024 bytes) into its chaining value.
void chunk_cv(const uint8_t* p, size_t len, uint64_t counter, bool is_root,
              uint32_t out_cv[8]) {
  uint32_t cv[8];
  std::memcpy(cv, kIV, 32);
  size_t n_blocks = len == 0 ? 1 : (len + kBlockLen - 1) / kBlockLen;
  for (size_t i = 0; i < n_blocks; ++i) {
    size_t off = i * kBlockLen;
    size_t blen = (i == n_blocks - 1) ? len - off : kBlockLen;
    uint32_t flags = 0;
    if (i == 0) flags |= kChunkStart;
    if (i == n_blocks - 1) {
      flags |= kChunkEnd;
      if (is_root) flags |= kRoot;
    }
    uint32_t words[16];
    load_block(p + off, blen, words);
    compress(cv, words, counter, static_cast<uint32_t>(blen), flags, cv);
  }
  std::memcpy(out_cv, cv, 32);
}

}  // namespace

extern "C" {

// data -> 32-byte digest.  One-shot; hashes the whole buffer.
void sdtk_blake3(const uint8_t* data, size_t len, uint8_t out[32]) {
  size_t n_chunks = len == 0 ? 1 : (len + kChunkLen - 1) / kChunkLen;
  uint32_t root_cv[8];
  if (n_chunks == 1) {
    chunk_cv(data, len, 0, /*is_root=*/true, root_cv);
  } else {
    // Leaf CVs, then left-pairing merge with odd carry (== BLAKE3 tree).
    uint32_t* cvs = new uint32_t[n_chunks * 8];
    for (size_t t = 0; t < n_chunks; ++t) {
      size_t off = t * kChunkLen;
      size_t clen = (t == n_chunks - 1) ? len - off : kChunkLen;
      chunk_cv(data + off, clen, t, false, cvs + t * 8);
    }
    size_t n = n_chunks;
    while (n > 1) {
      size_t pairs = n / 2;
      bool root_level = (n == 2);
      for (size_t i = 0; i < pairs; ++i) {
        uint32_t block[16];
        std::memcpy(block, cvs + 2 * i * 8, 32);
        std::memcpy(block + 8, cvs + (2 * i + 1) * 8, 32);
        uint32_t flags = kParent | (root_level ? kRoot : 0);
        compress(kIV, block, 0, kBlockLen, flags, cvs + i * 8);
      }
      if (n % 2) std::memcpy(cvs + pairs * 8, cvs + (n - 1) * 8, 32);
      n = pairs + (n % 2);
    }
    std::memcpy(root_cv, cvs, 32);
    delete[] cvs;
  }
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = static_cast<uint8_t>(root_cv[i]);
    out[4 * i + 1] = static_cast<uint8_t>(root_cv[i] >> 8);
    out[4 * i + 2] = static_cast<uint8_t>(root_cv[i] >> 16);
    out[4 * i + 3] = static_cast<uint8_t>(root_cv[i] >> 24);
  }
}

}  // extern "C"
