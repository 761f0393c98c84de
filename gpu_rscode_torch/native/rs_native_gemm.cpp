// rs_native_gemm — the host GF(2^8) codec: the GEMM and the Gauss-Jordan
// inverse behind strategy="cpu".
//
// The CPU codec of the reference (cpu-rs.c) and its host inverter
// (cpu-decode.c:251-298), written for a modern host core:
//  * the GEMM's hot loop is PSHUFB nibble-table SIMD when the build target
//    has AVX2 (split-nibble linearity, a*x = a*(hi<<4) ^ a*lo: two
//    shuffles and three XORs per 32 bytes), with parity rows grouped four
//    wide so the data streams from memory once per group; without AVX2 the
//    scalar loop reads the full 64 KiB product table.  All tables are built
//    once, at first use, from the primitive polynomial 0x11D;
//  * the GEMM is cache-blocked over columns and fans out across
//    std::thread workers by column range;
//  * Gauss-Jordan uses row pivoting (correct under zero pivots);
//  * everything is exposed extern "C" for ctypes.
// What bounds it: one pass over B per group of four parity rows, so the
// host's memory rate at large m and the shuffle ports of each core below.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPoly = 0x11D;
uint8_t g_mul[256][256];
uint8_t g_inv[256];

uint8_t slow_mul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  while (b) {
    if (b & 1) r ^= a;
    b >>= 1;
    a <<= 1;
    if (a & 0x100) a ^= kPoly;
  }
  return static_cast<uint8_t>(r);
}

void gemm_range_scalar(const uint8_t* A, const uint8_t* B, uint8_t* C, int p,
                       int k, long long m, long long lo, long long hi) {
  constexpr long long kBlock = 4096;  // keep working set in L1/L2
  for (long long c0 = lo; c0 < hi; c0 += kBlock) {
    const long long c1 = c0 + kBlock < hi ? c0 + kBlock : hi;
    for (int i = 0; i < p; ++i) {
      uint8_t* crow = C + static_cast<long long>(i) * m;
      std::memset(crow + c0, 0, static_cast<size_t>(c1 - c0));
      for (int t = 0; t < k; ++t) {
        const uint8_t a = A[i * k + t];
        if (a == 0) continue;
        const uint8_t* mrow = g_mul[a];
        const uint8_t* brow = B + static_cast<long long>(t) * m;
        if (a == 1) {
          for (long long c = c0; c < c1; ++c) crow[c] ^= brow[c];
        } else {
          for (long long c = c0; c < c1; ++c) crow[c] ^= mrow[brow[c]];
        }
      }
    }
  }
}

#if defined(__AVX2__)
// SIMD GF(2^8) constant-multiply via two 16-entry nibble tables + PSHUFB
// (the split-nibble linearity a*x = a*(hi<<4) ^ a*lo — the same
// decomposition the reference's cpu-rs-double.c strategy and its GF(16)
// nibble tables exploit, here vectorised 32 bytes per shuffle pair).
// ~10x the 64 KiB-table scalar loop per core: the scalar path is one
// dependent L1 gather per byte; this is 2 shuffles + 3 xors per 32 bytes.
// Parity rows are processed in groups of 4 sharing each loaded data block,
// so B streams from DRAM once per group instead of once per parity row,
// and the column loop runs 2x32-byte blocks per iteration so each pair of
// nibble tables is loaded from L1 once per 64 output bytes (the table
// loads, not the shuffles, bound the 1-block form).
void gemm_range_avx2(const uint8_t* A, const uint8_t* B, uint8_t* C, int p,
                     int k, long long m, long long lo, long long hi) {
  const __m256i nib = _mm256_set1_epi8(0x0f);
  constexpr int kGroup = 4;
  // (group-row, t) nibble tables; a == 0 rows keep all-zero tables (a
  // shuffle of zeros XORs as a no-op) so the inner loop stays branch-free.
  std::vector<__m256i> tlo(static_cast<size_t>(kGroup) * k);
  std::vector<__m256i> thi(static_cast<size_t>(kGroup) * k);
  for (int i0 = 0; i0 < p; i0 += kGroup) {
    const int pg = p - i0 < kGroup ? p - i0 : kGroup;
    for (int g = 0; g < pg; ++g) {
      for (int t = 0; t < k; ++t) {
        const uint8_t a = A[(i0 + g) * k + t];
        alignas(16) uint8_t lo_t[16], hi_t[16];
        for (int x = 0; x < 16; ++x) {
          lo_t[x] = g_mul[a][x];
          hi_t[x] = g_mul[a][x << 4];
        }
        tlo[g * k + t] = _mm256_broadcastsi128_si256(
            _mm_load_si128(reinterpret_cast<const __m128i*>(lo_t)));
        thi[g * k + t] = _mm256_broadcastsi128_si256(
            _mm_load_si128(reinterpret_cast<const __m128i*>(hi_t)));
      }
    }
    long long c = lo;
    for (; c + 64 <= hi; c += 64) {
      __m256i acc[kGroup], acc2[kGroup];
      for (int g = 0; g < kGroup; ++g) {
        acc[g] = _mm256_setzero_si256();
        acc2[g] = _mm256_setzero_si256();
      }
      for (int t = 0; t < k; ++t) {
        const uint8_t* brow = B + static_cast<long long>(t) * m;
        const __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(brow + c));
        const __m256i w2 = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(brow + c + 32));
        const __m256i vl = _mm256_and_si256(v, nib);
        const __m256i vh = _mm256_and_si256(_mm256_srli_epi16(v, 4), nib);
        const __m256i wl = _mm256_and_si256(w2, nib);
        const __m256i wh = _mm256_and_si256(_mm256_srli_epi16(w2, 4), nib);
        for (int g = 0; g < pg; ++g) {
          const __m256i lo_tab = tlo[g * k + t];
          const __m256i hi_tab = thi[g * k + t];
          acc[g] = _mm256_xor_si256(
              acc[g],
              _mm256_xor_si256(_mm256_shuffle_epi8(lo_tab, vl),
                               _mm256_shuffle_epi8(hi_tab, vh)));
          acc2[g] = _mm256_xor_si256(
              acc2[g],
              _mm256_xor_si256(_mm256_shuffle_epi8(lo_tab, wl),
                               _mm256_shuffle_epi8(hi_tab, wh)));
        }
      }
      for (int g = 0; g < pg; ++g) {
        uint8_t* crow = C + static_cast<long long>(i0 + g) * m;
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(crow + c), acc[g]);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(crow + c + 32),
                            acc2[g]);
      }
    }
    for (; c + 32 <= hi; c += 32) {
      __m256i acc[kGroup] = {_mm256_setzero_si256(), _mm256_setzero_si256(),
                             _mm256_setzero_si256(), _mm256_setzero_si256()};
      for (int t = 0; t < k; ++t) {
        const uint8_t* brow = B + static_cast<long long>(t) * m;
        const __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(brow + c));
        const __m256i vl = _mm256_and_si256(v, nib);
        const __m256i vh = _mm256_and_si256(_mm256_srli_epi16(v, 4), nib);
        for (int g = 0; g < pg; ++g) {
          acc[g] = _mm256_xor_si256(
              acc[g],
              _mm256_xor_si256(_mm256_shuffle_epi8(tlo[g * k + t], vl),
                               _mm256_shuffle_epi8(thi[g * k + t], vh)));
        }
      }
      for (int g = 0; g < pg; ++g) {
        _mm256_storeu_si256(
            reinterpret_cast<__m256i*>(C + static_cast<long long>(i0 + g) * m
                                       + c),
            acc[g]);
      }
    }
    if (c < hi) {  // ragged tail: scalar
      for (int g = 0; g < pg; ++g) {
        uint8_t* crow = C + static_cast<long long>(i0 + g) * m;
        std::memset(crow + c, 0, static_cast<size_t>(hi - c));
        for (int t = 0; t < k; ++t) {
          const uint8_t a = A[(i0 + g) * k + t];
          if (a == 0) continue;
          const uint8_t* mrow = g_mul[a];
          const uint8_t* brow = B + static_cast<long long>(t) * m;
          for (long long cc = c; cc < hi; ++cc) crow[cc] ^= mrow[brow[cc]];
        }
      }
    }
  }
}
#endif  // __AVX2__

void gemm_range(const uint8_t* A, const uint8_t* B, uint8_t* C, int p, int k,
                long long m, long long lo, long long hi) {
#if defined(__AVX2__)
  gemm_range_avx2(A, B, C, p, k, m, lo, hi);
#else
  gemm_range_scalar(A, B, C, p, k, m, lo, hi);
#endif
}

}  // namespace

extern "C" {

int rs_gf_init(void) {
  static std::once_flag once;
  std::call_once(once, [] {
    for (int a = 0; a < 256; ++a)
      for (int b = 0; b <= a; ++b) g_mul[a][b] = g_mul[b][a] = slow_mul(a, b);
    for (int a = 1; a < 256; ++a)
      for (int b = 1; b < 256; ++b)
        if (g_mul[a][b] == 1) {
          g_inv[a] = static_cast<uint8_t>(b);
          break;
        }
  });
  return 0;
}

// C[p x m] = A[p x k] . B[k x m] over GF(256), XOR-accumulated.
void rs_gemm(const uint8_t* A, const uint8_t* B, uint8_t* C, int p, int k,
             long long m, int nthreads) {
  rs_gf_init();
  if (nthreads <= 1 || m < (1 << 16)) {
    gemm_range(A, B, C, p, k, m, 0, m);
    return;
  }
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  const int nt =
      nthreads < static_cast<int>(hw) ? nthreads : static_cast<int>(hw);
  std::vector<std::thread> workers;
  const long long step = (m + nt - 1) / nt;
  for (int w = 0; w < nt; ++w) {
    const long long lo = w * step;
    const long long hi = lo + step < m ? lo + step : m;
    if (lo >= hi) break;
    workers.emplace_back(gemm_range, A, B, C, p, k, m, lo, hi);
  }
  for (auto& th : workers) th.join();
}

// Gauss-Jordan inverse with row pivoting.  0 on success, -1 if singular.
int rs_invert(const uint8_t* M, uint8_t* out, int k) {
  rs_gf_init();
  std::vector<uint8_t> a(M, M + static_cast<size_t>(k) * k);
  std::vector<uint8_t> r(static_cast<size_t>(k) * k, 0);
  for (int i = 0; i < k; ++i) r[i * k + i] = 1;
  for (int col = 0; col < k; ++col) {
    int piv = -1;
    for (int row = col; row < k; ++row)
      if (a[row * k + col]) {
        piv = row;
        break;
      }
    if (piv < 0) return -1;
    if (piv != col) {
      for (int j = 0; j < k; ++j) {
        std::swap(a[col * k + j], a[piv * k + j]);
        std::swap(r[col * k + j], r[piv * k + j]);
      }
    }
    const uint8_t inv_p = g_inv[a[col * k + col]];
    for (int j = 0; j < k; ++j) {
      a[col * k + j] = g_mul[a[col * k + j]][inv_p];
      r[col * k + j] = g_mul[r[col * k + j]][inv_p];
    }
    for (int row = 0; row < k; ++row) {
      if (row == col) continue;
      const uint8_t f = a[row * k + col];
      if (!f) continue;
      const uint8_t* fr = g_mul[f];
      for (int j = 0; j < k; ++j) {
        a[row * k + j] ^= fr[a[col * k + j]];
        r[row * k + j] ^= fr[r[col * k + j]];
      }
    }
  }
  std::memcpy(out, r.data(), static_cast<size_t>(k) * k);
  return 0;
}

}  // extern "C"
