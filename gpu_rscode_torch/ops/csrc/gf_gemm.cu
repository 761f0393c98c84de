// K1 for Hopper (sm_90a): C = A . B over GF(2^w), w = 4, 8 or 16.
//
// Replaces the JAX package's TPU kernel ops/pallas_gemm.py::_kernel_body
// (launched by _pallas_matmul).  Same function, same I/O contract: B is
// read from device memory once per output tile, C is written once, and the
// (p*w, k*w) GF(2) operator built on the host from A stays on chip.
//
// Two kernels, one per output form:
//
// gf_bitslice_kernel: the folded form, (p, m) symbols (every encode and
// decode).  Bound on the card: instruction issue on the logic pipe, with
// device-memory bytes as the floor.  The function moves (k + p) * m * (w/8)
// bytes (3.35 TB/s on an H100 SXM); the design issues about
// p*w * k*w / 32 LOP3 per column plus the bit transposes.
//   * Bit slicing.  Each thread owns 32 columns.  Per input symbol row it
//     loads their w*4 bytes as w/4 16-byte chunks: chunk u of lane l sits
//     at byte 512*u + 16*l of the warp's 1024-column span, so every load
//     instruction of a warp reads 512 contiguous bytes.  The w loaded words
//     are transposed in registers into w plane words (plane s holds bit s
//     of the 32 symbols) by log2(w) masked-swap stages: stage a swaps bit a
//     of the word index with bit a of the bit position.  The stages commute
//     and each is its own inverse, so the same routine turns output planes
//     back into symbols.  The columns come out of the transpose permuted
//     within the thread, and go back through the inverse permutation, so
//     the order never has to be undone: every plane op acts on all 32
//     columns alike.
//   * Accumulation.  Output plane t of tile row r gets
//     out[r*w + t] ^= plane[s] & mask[i][s][r*w + t] for every input
//     symbol i and plane s: one LOP3, no popcount.  The masks are the
//     operator's bits spread to all-ones / all-zeros words, packed on the
//     host (ops/cuda_gemm.py::pack_masks).  Plane s of input symbol i meets
//     operator column i*w + s, the order of expand_bitmatrix; output plane
//     t of symbol row r becomes bit t of C[r].  Every thread of a block
//     reads the same mask at once, so shared memory broadcasts them, four
//     per LDS.128.  Input rows stream: load, transpose, fold into the
//     output planes, drop; the next row's load is issued before the
//     current row is folded.  Loop bounds are the true k and p*w.
//   * Tiles.  A tile holds at most 64 output planes (rt rows of w planes)
//     in registers; p is split into `tiles` tiles of rt rows and each tile
//     is its own block, tile-fastest in the grid so that the tiles of one
//     column range read B while it is in L2.  The last tile's rows past p
//     carry zero masks and are not stored.
//   * Depth chunks.  A tile's masks take k * w * rt*w * 4 bytes of shared
//     memory; when that exceeds the host's budget the input rows are staged
//     `depth` rows at a time (96 KB by default, so w=16 at k = 128 stages
//     six chunks).
//   * Misaligned rows.  Row i starts at byte i*m*(w/8), which is 16-byte
//     aligned only when m*(w/8) is: the main path's last segment (1,639
//     columns), small files and odd widths are not.  Each 16-byte chunk
//     takes one vector access when its address is 16-byte aligned, four
//     32-bit accesses when it is 4-byte aligned, and byte accesses
//     otherwise.  The alignment of a chunk is the alignment of its row, so
//     a warp takes one path per row.
//   * Ragged groups.  Bytes past the row's end load as zero; the chunk
//     that holds the row's end is stored byte by byte up to it, and nothing
//     past m is written.
//   * w=4.  A GF(2^4) symbol is stored one to a byte, in the low nibble
//     (the JAX package's uint8 layout); bits 4-7 are ignored.  The kernel
//     loads, transposes and stores bytes as at w=8 (SW = 8 storage bits)
//     and folds only planes 0-3 into rt*4 output planes; the output planes
//     4-7 are zero, so the high nibble of every output byte is zero.
//
// gf_popcount_kernel: the pre-parity form, (p*w, m) int32 (stripe-sharded
// sums, which a XOR network cannot give).  Operator rows are packed into
// 32-bit words, zero-padded to a power-of-two word bucket NW; each thread
// packs its column's k symbols into NW words (w bits each, so at w=4 the
// high nibble of a byte is dropped) and writes
// sum_j popc(op[row][j] & col[j]) per output bit.
//
// Plain C interface (bound with ctypes): every entry returns a
// cudaError_t value; the launch runs on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// ---------------------------------------------------------------------------
// Folded form: the bit-sliced XOR kernel.

// Bit a of the word index <-> bit a of the bit position, for every a with
// 2^a < W.  Turns W words of packed w-bit symbols into W bit planes and back.
template <int W>
__device__ __forceinline__ void transpose_planes(uint32_t (&x)[W]) {
#pragma unroll
  for (int a = 0; (1 << a) < W; ++a) {
    const int sh = 1 << a;
    const uint32_t keep = a == 0   ? 0x55555555u
                          : a == 1 ? 0x33333333u
                          : a == 2 ? 0x0F0F0F0Fu
                                   : 0x00FF00FFu;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i & sh) continue;
      const uint32_t t = ((x[i] >> sh) ^ x[i | sh]) & keep;
      x[i | sh] ^= t;
      x[i] ^= t << sh;
    }
  }
}

// 16 bytes at row[off], zero past len.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row, long long off,
                                        long long len) {
  const uint8_t* p = row + off;
  if (off + 16 <= len) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    if ((a & 3) == 0) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
  }
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (off + b < len) v[b >> 2] |= (uint32_t)__ldg(p + b) << (8 * (b & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// 16 bytes to row[off], none past len.
__device__ __forceinline__ void store16(uint8_t* __restrict__ row, long long off, long long len,
                                        uint4 v) {
  uint8_t* p = row + off;
  if (off + 16 <= len) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = v;
      return;
    }
    if ((a & 3) == 0) {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
      q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
      return;
    }
  }
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (off + b < len) p[b] = (uint8_t)(words[b >> 2] >> (8 * (b & 3)));
  }
}

// The thread's W words of one row: chunk u is words 4u..4u+3.
template <int W>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row, long long off,
                                         long long len, uint32_t (&x)[W]) {
#pragma unroll
  for (int u = 0; u < W / 4; ++u) {
    const uint4 v = load16(row, off + 512LL * u, len);
    x[4 * u] = v.x, x[4 * u + 1] = v.y, x[4 * u + 2] = v.z, x[4 * u + 3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void store_row(uint8_t* __restrict__ row, long long off, long long len,
                                          const uint32_t (&x)[W]) {
#pragma unroll
  for (int u = 0; u < W / 4; ++u) {
    store16(row, off + 512LL * u, len, make_uint4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]));
  }
}

// masks: (tiles, k, W, RT*W) uint32, all-ones or zero; B: (k, m) and
// C: (p, m) symbols of W bits, row-major, one per SW-bit word.
template <int W, int RT>
__global__ void __launch_bounds__(kThreads)
    gf_bitslice_kernel(const uint4* __restrict__ masks, const uint8_t* __restrict__ B,
                       uint8_t* __restrict__ C, int k, int p, long long m, int tiles, int depth) {
  constexpr int SW = W < 8 ? 8 : W;  // storage bits of a symbol: a byte at w <= 8
  constexpr int NP = RT * W;  // output planes of the tile
  constexpr int NQ = NP / 4;  // LDS.128 per input plane
  extern __shared__ uint4 mask_s[];  // (depth, W, NQ)

  const int tile = blockIdx.x % tiles;
  const long long blk = blockIdx.x / tiles;
  const long long len = m * (SW / 8);  // row bytes
  const long long warp_span = 512LL * (SW / 4);
  const long long off = (blk * (kThreads / 32) + threadIdx.x / 32) * warp_span + 16 * (threadIdx.x % 32);
  const uint4* tile_masks = masks + (size_t)tile * k * W * NQ;

  uint32_t out[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) out[q] = 0;

  for (int i0 = 0; i0 < k; i0 += depth) {
    const int rows = min(depth, k - i0);
    __syncthreads();  // the previous chunk's masks are no longer read
    const uint4* src = tile_masks + (size_t)i0 * W * NQ;
    for (int q = threadIdx.x; q < rows * W * NQ; q += kThreads) mask_s[q] = src[q];
    __syncthreads();

    uint32_t x[SW];
    load_row<SW>(B + (size_t)i0 * len, off, len, x);
    for (int r = 0; r < rows; ++r) {
      uint32_t next[SW];
      if (r + 1 < rows) load_row<SW>(B + (size_t)(i0 + r + 1) * len, off, len, next);
      transpose_planes<SW>(x);
      const uint4* mk = mask_s + (size_t)r * W * NQ;
#pragma unroll
      for (int s = 0; s < W; ++s) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const uint4 v = mk[s * NQ + q];
          out[4 * q] ^= x[s] & v.x;
          out[4 * q + 1] ^= x[s] & v.y;
          out[4 * q + 2] ^= x[s] & v.z;
          out[4 * q + 3] ^= x[s] & v.w;
        }
      }
      if (r + 1 < rows) {
#pragma unroll
        for (int j = 0; j < SW; ++j) x[j] = next[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = tile * RT + r;
    if (row >= p) break;
    uint32_t y[SW];
#pragma unroll
    for (int t = 0; t < SW; ++t) y[t] = t < W ? out[r * W + t] : 0u;
    transpose_planes<SW>(y);
    store_row<SW>(C + (size_t)row * len, off, len, y);
  }
}

template <int W, int RT>
int launch_bitslice(const void* masks, const void* B, void* C, int k, int p, long long m,
                    int tiles, int depth, cudaStream_t stream) {
  const size_t smem = (size_t)depth * W * RT * W * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gf_bitslice_kernel<W, RT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long cols_per_block = (kThreads / 32) * 1024LL;
  const long long blocks = (m + cols_per_block - 1) / cols_per_block * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  gf_bitslice_kernel<W, RT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(masks), static_cast<const uint8_t*>(B), static_cast<uint8_t*>(C),
      k, p, m, tiles, depth);
  return (int)cudaGetLastError();
}

// Tile rows: rt * w <= 64 output planes.
#define RS_RT4(X)                                                            \
  X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6) X(4, 7) X(4, 8) X(4, 9)   \
  X(4, 10) X(4, 11) X(4, 12) X(4, 13) X(4, 14) X(4, 15) X(4, 16)
#define RS_RT8(X) X(8, 1) X(8, 2) X(8, 3) X(8, 4) X(8, 5) X(8, 6) X(8, 7) X(8, 8)
#define RS_RT16(X) X(16, 1) X(16, 2) X(16, 3) X(16, 4)

// ---------------------------------------------------------------------------
// Pre-parity form: the popcount kernel.

template <int W>
struct Sym;
template <>
struct Sym<4> {
  using T = uint8_t;  // one symbol a byte, in the low nibble
};
template <>
struct Sym<8> {
  using T = uint8_t;
};
template <>
struct Sym<16> {
  using T = uint16_t;
};

constexpr int kPopThreads = 256;
constexpr int kPopSmemBudget = 96 * 1024;  // two blocks per SM

template <int NW>
struct ColsPerThread {
  static constexpr int value = NW <= 8 ? 4 : (NW <= 16 ? 2 : 1);
};

template <int W, int NW, int CPT>
__global__ void __launch_bounds__(kPopThreads)
    gf_popcount_kernel(const uint32_t* __restrict__ op, const typename Sym<W>::T* __restrict__ B,
                       int32_t* __restrict__ C, int k, int p, long long m, int syms_per_block) {
  constexpr int SPW = 32 / W;  // symbols per 32-bit word
  extern __shared__ uint32_t op_s[];

  const int s0 = blockIdx.y * syms_per_block;
  const int s1 = min(p, s0 + syms_per_block);
  const uint32_t* op_blk = op + (size_t)s0 * W * NW;
  for (int i = threadIdx.x; i < (s1 - s0) * W * NW; i += kPopThreads) {
    op_s[i] = op_blk[i];
  }
  __syncthreads();

  const long long c0 = (long long)blockIdx.x * (kPopThreads * CPT) + threadIdx.x;
  uint32_t cb[CPT][NW];
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const long long c = c0 + (long long)u * kPopThreads;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        const int i = j * SPW + q;
        if (i < k && c < m) {
          word |= ((uint32_t)B[(size_t)i * m + c] & ((1u << W) - 1u)) << (q * W);
        }
      }
      cb[u][j] = word;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const uint32_t* rows = op_s + (size_t)(s - s0) * W * NW;
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
        const long long c = c0 + (long long)u * kPopThreads;
        if (c < m) C[(size_t)(s * W + t) * m + c] = acc[u];
      }
    }
  }
}

template <int W, int NW>
int launch_popcount(const void* op, const void* B, void* C, int k, int p, long long m,
                    cudaStream_t stream) {
  constexpr int CPT = ColsPerThread<NW>::value;
  const int bytes_per_sym = W * NW * 4;
  const int max_syms = kPopSmemBudget / bytes_per_sym;  // >= 24: W*NW*4 <= 4096
  const int grid_y = (p + max_syms - 1) / max_syms;
  const int syms_per_block = (p + grid_y - 1) / grid_y;
  const size_t smem = (size_t)syms_per_block * bytes_per_sym;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gf_popcount_kernel<W, NW, CPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long cols_per_block = (long long)kPopThreads * CPT;
  const dim3 grid((unsigned)((m + cols_per_block - 1) / cols_per_block), (unsigned)grid_y);
  gf_popcount_kernel<W, NW, CPT><<<grid, kPopThreads, smem, stream>>>(
      static_cast<const uint32_t*>(op), static_cast<const typename Sym<W>::T*>(B),
      static_cast<int32_t*>(C), k, p, m, syms_per_block);
  return (int)cudaGetLastError();
}

#define RS_NW_BUCKETS(X) X(2) X(4) X(8) X(16) X(32) X(64)

template <int W>
int dispatch_nw(int nw, const void* op, const void* B, void* C, int k, int p, long long m,
                cudaStream_t stream) {
  switch (nw) {
#define RS_CASE(N) \
  case N:          \
    return launch_popcount<W, N>(op, B, C, k, p, m, stream);
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

// C = A . B over GF(2^w), folded: (p, m) symbols.
//   masks: (tiles, k, w, rt*w) uint32 from pack_masks, rt*w <= 64.
//   B:     (k, m) uint8 (w=4, 8) or uint16 (w=16), row-major.
//   C:     (p, m) symbols of B's type.
//   depth: input rows whose masks are staged in shared memory at once.
int rs_gf_bitslice(const void* masks, const void* B, void* C, int k, int p, int w, long long m,
                   int rt, int tiles, int depth, void* stream) {
  if (k <= 0 || p <= 0 || m < 0 || tiles <= 0 || depth <= 0 || depth > k ||
      (long long)rt * tiles < p || (long long)rt * (tiles - 1) >= p) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_CASE(W, RT)                                                              \
  if (w == W && rt == RT) {                                                         \
    return launch_bitslice<W, RT>(masks, B, C, k, p, m, tiles, depth, s);           \
  }
  RS_RT4(RS_CASE)
  RS_RT8(RS_CASE)
  RS_RT16(RS_CASE)
#undef RS_CASE
  return (int)cudaErrorInvalidValue;
}

// Operator words per row of the pre-parity kernel for a depth of k symbols
// of w bits: the smallest bucket holding ceil(k*w/32) words, or -1 when the
// depth is unsupported.
int rs_gf_popcount_words(int k, int w) {
  if (k <= 0 || (w != 4 && w != 8 && w != 16)) return -1;
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

// The pre-parity accumulators: (p*w, m) int32.
//   op: (p*w, nw) uint32 operator rows, zero-padded to nw words
//       (nw == rs_gf_popcount_words(k, w)).
//   B:  (k, m) uint8 (w=4, 8) or uint16 (w=16), row-major.
int rs_gf_popcount(const void* op, const void* B, void* C, int k, int p, int w, long long m,
                   int nw, void* stream) {
  if (rs_gf_popcount_words(k, w) != nw || p <= 0 || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 4) return dispatch_nw<4>(nw, op, B, C, k, p, m, s);
  return w == 8 ? dispatch_nw<8>(nw, op, B, C, k, p, m, s)
                : dispatch_nw<16>(nw, op, B, C, k, p, m, s);
}

}  // extern "C"
