// Host-side packing of the port's cache format: bit planes and outlier
// words converted on the CPU, with no device and no torch involved.
//
// This is the port's counterpart of the JAX package's host packer. It is
// built by kvquant_tpu_torch/ops/kernels/build.py with the host compiler
// (g++ -std=c++17 -O3 -shared -fPIC) into kvquant_tpu_torch/_build/ and
// loaded with ctypes by kvquant_tpu_torch/native. It serves cache import /
// export and tooling, and it is a second encoding of the layout that the
// torch packing (ops/packing.py) and the cache written on the card are
// checked against.
//
// Layout (ops/packing.py):
//   codes (lead, T, D), planes (lead, bits, T/32, D), T a multiple of 128;
//   token t of group g = t/128 lives in word row g*4 + (t%128)%4 of every
//   plane, at bit (t%128)/4; plane b holds bit b of the code.
// Outlier words: the fp32 bit pattern (value & ~0x1FF) | (idx & 0x1FF),
//   idx = head_in_group << 7 | dim.
//
// The loops run word row by word row: a word row's 32 tokens are
// t = g*128 + j*4 + q (j the bit, q = row % 4), and each output word is
// complete once its row is done. Shifts run on uint32_t, so bit 31 is
// well defined.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kGroup = 128;  // tokens per packing group
constexpr int64_t kRows = 4;     // word rows per group and plane
constexpr int kBitsPerWord = 32;

// token held at bit j of word row w
inline int64_t token_of(int64_t w, int j) {
  return (w / kRows) * kGroup + (int64_t)j * kRows + (w % kRows);
}

}  // namespace

extern "C" {

// codes (lead, T, D) int32 -> planes (lead, bits, T/32, D) int32
void kvq_pack_codes(const int32_t* codes, int32_t* planes, int64_t lead,
                    int64_t T, int64_t D, int32_t bits) {
  const int64_t rows = T / kBitsPerWord;
  const int64_t plane = rows * D;
  for (int64_t l = 0; l < lead; ++l) {
    const int32_t* src = codes + l * T * D;
    uint32_t* dst = reinterpret_cast<uint32_t*>(planes) + l * bits * plane;
    for (int64_t w = 0; w < rows; ++w) {
      for (int32_t b = 0; b < bits; ++b) {
        uint32_t* out = dst + b * plane + w * D;
        std::memset(out, 0, sizeof(uint32_t) * D);
        for (int j = 0; j < kBitsPerWord; ++j) {
          const int32_t* row = src + token_of(w, j) * D;
          for (int64_t d = 0; d < D; ++d)
            out[d] |= (((uint32_t)row[d] >> b) & 1u) << j;
        }
      }
    }
  }
}

// planes (lead, bits, T/32, D) int32 -> codes (lead, T, D) int32
void kvq_unpack_codes(const int32_t* planes, int32_t* codes, int64_t lead,
                      int64_t T, int64_t D, int32_t bits) {
  const int64_t rows = T / kBitsPerWord;
  const int64_t plane = rows * D;
  for (int64_t l = 0; l < lead; ++l) {
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(planes) + l * bits * plane;
    int32_t* dst = codes + l * T * D;
    for (int64_t w = 0; w < rows; ++w) {
      for (int j = 0; j < kBitsPerWord; ++j) {
        int32_t* row = dst + token_of(w, j) * D;
        std::memset(row, 0, sizeof(int32_t) * D);
        for (int32_t b = 0; b < bits; ++b) {
          const uint32_t* in = src + b * plane + w * D;
          for (int64_t d = 0; d < D; ++d)
            row[d] |= (int32_t)(((in[d] >> j) & 1u) << b);
        }
      }
    }
  }
}

// n values and indices -> n outlier words
void kvq_encode_outliers(const float* vals, const int32_t* idx, float* out,
                         int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t u;
    std::memcpy(&u, vals + i, sizeof u);
    u = (u & ~0x1FFu) | ((uint32_t)idx[i] & 0x1FFu);
    std::memcpy(out + i, &u, sizeof u);
  }
}

// n outlier words -> n values and indices
void kvq_decode_outliers(const float* words, float* vals, int32_t* idx,
                         int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t u;
    std::memcpy(&u, words + i, sizeof u);
    idx[i] = (int32_t)(u & 0x1FFu);
    u &= ~0x1FFu;
    std::memcpy(vals + i, &u, sizeof u);
  }
}

}  // extern "C"
