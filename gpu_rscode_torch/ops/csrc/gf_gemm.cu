// Fused GF(2^w) GEMM for Hopper (sm_90a): C = A . B over GF(2^w).
//
// Replaces the JAX package's TPU kernel ops/pallas_gemm.py::_kernel_body
// (launched by _pallas_matmul).  Same function, same I/O contract: B is
// read from device memory once, C is written once, and the (p*w, k*w)
// GF(2) operator built on the host from A stays resident on chip.
//
// Bound on the card: device-memory bytes.  The function moves
// (k + p) * m * (w / 8) bytes (3.35 TB/s on an H100 SXM); it needs about
// p*w*k*w/32 word ANDs per column, far below the integer issue rate at the
// main path's shapes.
//
// Design (the simplest bit-exact formulation, no tensor cores):
//   * Operator rows are packed into 32-bit words: bit (i*w + s) of row r is
//     the coefficient on bit s of symbol i.  That is the bit order of
//     ops/gemm.py::to_bitplanes, so the k symbols of one column,
//     concatenated little-endian into words, ARE its packed bit vector:
//     4 uint8 (or 2 uint16) symbols per word, no bit shuffling.
//   * Each thread owns CPT columns (column c, c + blockDim, ...).  Loads and
//     stores are coalesced across the threads of a warp because B and C
//     are row-major (k, m) / (p, m).
//   * Output bit t of symbol row i = parity(sum_j popc(op[i*w+t][j] & col[j]))
//     = popc(XOR_j (op[i*w+t][j] & col[j])) & 1.  With fold == 0 the
//     popcount sums themselves are written as int32 (p*w, m): they equal
//     the masked-shift bit-plane accumulators exactly.
//   * The operator lives in shared memory and every warp reads the same
//     word at once (broadcast, no bank conflicts).  When it exceeds the
//     per-block budget (w=16, k = p = 128 is 512 KB) the output symbol rows
//     are tiled over gridDim.y, each block staging only its rows.
//   * The word count NW = ceil(k*w/32) is a template parameter, rounded up
//     to a power of two from 2 to 64 (the host zero-pads operator rows to
//     NW words), so a column's bit vector stays in registers.  Six buckets
//     x two widths x two fold modes keep the build to 24 instances.
//   * The ragged last column block is masked per thread.
//
// Plain C interface (bound with ctypes): every entry returns a
// cudaError_t value; the launch runs on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;  // two blocks per SM

template <int W>
struct Sym;
template <>
struct Sym<8> {
  using T = uint8_t;
};
template <>
struct Sym<16> {
  using T = uint16_t;
};

template <int NW>
struct ColsPerThread {
  static constexpr int value = NW <= 8 ? 4 : (NW <= 16 ? 2 : 1);
};

template <int W, int NW, int CPT, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    gf_gemm_kernel(const uint32_t* __restrict__ op,
                   const typename Sym<W>::T* __restrict__ B,
                   void* __restrict__ C, int k, int p, long long m,
                   int syms_per_block) {
  using T = typename Sym<W>::T;
  constexpr int SPW = 32 / W;  // symbols per 32-bit word
  extern __shared__ uint32_t op_s[];

  const int s0 = blockIdx.y * syms_per_block;
  const int s1 = min(p, s0 + syms_per_block);
  const uint32_t* op_blk = op + (size_t)s0 * W * NW;
  for (int i = threadIdx.x; i < (s1 - s0) * W * NW; i += kThreads) {
    op_s[i] = op_blk[i];
  }
  __syncthreads();

  const long long c0 = (long long)blockIdx.x * (kThreads * CPT) + threadIdx.x;
  uint32_t cb[CPT][NW];
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const long long c = c0 + (long long)u * kThreads;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        const int i = j * SPW + q;
        if (i < k && c < m) {
          word |= (uint32_t)B[(size_t)i * m + c] << (q * W);
        }
      }
      cb[u][j] = word;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const uint32_t* rows = op_s + (size_t)(s - s0) * W * NW;
    if (FOLD) {
      uint32_t out[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) out[u] = 0;
#pragma unroll
      for (int t = 0; t < W; ++t) {
        uint32_t x[CPT];
#pragma unroll
        for (int u = 0; u < CPT; ++u) x[u] = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t a = rows[t * NW + j];
#pragma unroll
          for (int u = 0; u < CPT; ++u) x[u] ^= a & cb[u][j];
        }
#pragma unroll
        for (int u = 0; u < CPT; ++u) out[u] |= (uint32_t)(__popc(x[u]) & 1) << t;
      }
      T* Cs = static_cast<T*>(C);
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const long long c = c0 + (long long)u * kThreads;
        if (c < m) Cs[(size_t)s * m + c] = (T)out[u];
      }
    } else {
      int32_t* Ci = static_cast<int32_t*>(C);
#pragma unroll
      for (int t = 0; t < W; ++t) {
        int acc[CPT];
#pragma unroll
        for (int u = 0; u < CPT; ++u) acc[u] = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t a = rows[t * NW + j];
#pragma unroll
          for (int u = 0; u < CPT; ++u) acc[u] += __popc(a & cb[u][j]);
        }
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const long long c = c0 + (long long)u * kThreads;
          if (c < m) Ci[(size_t)(s * W + t) * m + c] = acc[u];
        }
      }
    }
  }
}

template <int W, int NW, bool FOLD>
int launch(const void* op, const void* B, void* C, int k, int p, long long m,
           cudaStream_t stream) {
  constexpr int CPT = ColsPerThread<NW>::value;
  const int bytes_per_sym = W * NW * 4;
  const int max_syms = kSmemBudget / bytes_per_sym;  // >= 24: W*NW*4 <= 4096
  const int grid_y = (p + max_syms - 1) / max_syms;
  const int syms_per_block = (p + grid_y - 1) / grid_y;
  const size_t smem = (size_t)syms_per_block * bytes_per_sym;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_gemm_kernel<W, NW, CPT, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long cols_per_block = (long long)kThreads * CPT;
  const dim3 grid((unsigned)((m + cols_per_block - 1) / cols_per_block),
                  (unsigned)grid_y);
  gf_gemm_kernel<W, NW, CPT, FOLD><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(op),
      static_cast<const typename Sym<W>::T*>(B), C, k, p, m, syms_per_block);
  return (int)cudaGetLastError();
}

#define RS_NW_BUCKETS(X) \
  X(2) X(4) X(8) X(16) X(32) X(64)

template <int W, bool FOLD>
int dispatch_nw(int nw, const void* op, const void* B, void* C, int k, int p,
                long long m, cudaStream_t stream) {
  switch (nw) {
#define RS_CASE(N) \
  case N:          \
    return launch<W, N, FOLD>(op, B, C, k, p, m, stream);
    RS_NW_BUCKETS(RS_CASE)
#undef RS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Operator words per row for a depth of k symbols of w bits: the smallest
// bucket holding ceil(k*w/32) words, or -1 when the depth is unsupported.
int rs_gf_gemm_words(int k, int w) {
  if (k <= 0 || (w != 8 && w != 16)) return -1;
  const int need = (k * w + 31) / 32;
  const int buckets[] = {
#define RS_LIST(N) N,
      RS_NW_BUCKETS(RS_LIST)
#undef RS_LIST
  };
  for (int nw : buckets) {
    if (nw >= need) return nw;
  }
  return -1;
}

// C = A . B over GF(2^w).
//   op: (p*w, nw) uint32 operator rows, zero-padded to nw words
//       (nw == rs_gf_gemm_words(k, w)).
//   B:  (k, m) uint8 (w=8) or uint16 (w=16), row-major.
//   C:  fold != 0: (p, m) symbols of B's type; fold == 0: (p*w, m) int32.
int rs_gf_gemm(const void* op, const void* B, void* C, int k, int p, int w,
               long long m, int nw, int fold, void* stream) {
  if (rs_gf_gemm_words(k, w) != nw || p <= 0 || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 8) {
    return fold ? dispatch_nw<8, true>(nw, op, B, C, k, p, m, s)
                : dispatch_nw<8, false>(nw, op, B, C, k, p, m, s);
  }
  return fold ? dispatch_nw<16, true>(nw, op, B, C, k, p, m, s)
              : dispatch_nw<16, false>(nw, op, B, C, k, p, m, s);
}

}  // extern "C"
