// Bit-plane GF(2^8) GEMMs on the int8 tensor cores, and the copy floor,
// for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel tools/kernel_sweep.py::make_fn
// (its pallas_call `run`, with the bodies _body_base, _body_cmp,
// _body_sign, _body_signc, _body_signf, _body_nibble, _body_raw_dot and
// _body_dma, and the pinned-input mode), and with it the expansion and
// refold variants of ops/pallas_gemm.py::_kernel_body (_expand_shift,
// _expand_shift_raw, _expand_sign, _expand_nibble; refold "sum" and "dot").
//
// gf_planes_kernel<EXPAND, REFOLD>: C = A . B over GF(2^8).
//   Bound on the card: device-memory bytes, (k + p) * m.  The product is
//   p*8 x k*8 (k*32 for nibble) int8 multiply-adds per column, about 1 % of
//   the int8 tensor-core rate at the main path's shape; what is left is the
//   in-register expansion of each loaded byte into planes, the refold, and
//   the loads themselves.  Design:
//   * The operator, zero-padded to (16*MT rows, 32*KC depth), is the A
//     operand of mma.sync.m16n8k32.s8.  The wrapper packs it on the host in
//     fragment order (uint4 per lane per (m-tile, depth chunk)); each block
//     stages it in shared memory once and every lane reads its uint4.
//   * The expanded planes are the B operand, built in registers.  In the
//     .col B fragment a lane (g = lane/4, t = lane%4) holds depth rows
//     t*4..t*4+3 and 16+t*4..16+t*4+3 of column g.  At w=8 depth row
//     i*8 + s is bit s of data symbol i, so those are 4 bit planes of one
//     byte; for nibble (depth i*32 + v) they are 4 one-hot compares of one
//     nibble.  The lane expands the byte it loaded: no shared memory.
//   * A warp takes 32 columns per step as 4 mma column groups; n-index n of
//     group j is column 4n + j.  So lane (g, t) loads one 32-bit word (the
//     4 columns 4g..4g+3) per data row it needs, and 8 lanes read 32
//     consecutive bytes of a row.
//   * Expansions: shift (b >> s) & 1; shift_raw (b >> s) wrapped to int8
//     (parity of the accumulator unchanged: the dropped higher bits add
//     even terms); cmp (b & 2^s) != 0 with a SIMD byte compare; sign
//     {0, -1} (-1 is odd, so parity is unchanged); nibble one-hot.
//   * Refold sum: output bit s of symbol i is the parity of accumulator row
//     i*8 + s, which a C fragment spreads over lanes g = s.  Each lane
//     shifts its 4 parities to bit g of 4 bytes and three xor-shuffles OR
//     them over g; lanes g = 0 and 1 then hold 8 consecutive output bytes
//     of symbols 2*mt and 2*mt + 1 and store them as one 8-byte word.
//   * Refold dot: the parity bits go through shared memory (column-major,
//     a warp's own region) from the C fragment layout into the B fragment
//     layout, then a second mma (u8: F holds 2^s up to 128) multiplies them
//     by the (p, p*8) bit-weight operator F.
//   * pinned: every block reads the columns of block 0 and writes its own
//     block, the compute-only ceiling (the input is served from L2).
//   * tile is the number of columns a block covers (a multiple of 32); the
//     ragged edge is masked per lane.
//
// copy_floor_kernel: C = B[:p], moving exactly K1's traffic.  Each block
// brings its whole (k, tile) block of B into shared memory, in chunks that
// fit, with cp.async (16 bytes a thread), then writes rows 0..p-1 out.
// The copies into shared memory cannot be dropped by the compiler, so the
// rows >= p are read as a GEMM reads them.  Bound: (k + p) * m bytes.
//
// Plain C interface (bound with ctypes): every entry returns a
// cudaError_t value; launches run on the caller's stream and do not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kCopyBudget = 64 * 1024;

enum Expand { kShift = 0, kShiftRaw = 1, kCmp = 2, kSign = 3, kNibble = 4 };
enum Refold { kSum = 0, kDot = 1 };

struct Dims {
  int mt;  // 16-row m-tiles of the operator (p*8 rows)
  int kc;  // 32-deep chunks of the operator's depth
  int mf;  // 16-row m-tiles of F (p rows)
  int kf;  // 32-deep chunks of F (16*mt columns)
};

__host__ __device__ inline Dims dims(int k, int p, int expand) {
  Dims d;
  d.mt = (p * 8 + 15) / 16;
  d.kc = expand == kNibble ? k : (k * 8 + 31) / 32;
  d.mf = (p + 15) / 16;
  d.kf = (d.mt * 16 + 31) / 32;
  return d;
}

inline size_t planes_smem(const Dims& d, int refold) {
  size_t bytes = (size_t)d.mt * d.kc * 32 * sizeof(uint4);
  if (refold == kDot) {
    bytes += (size_t)d.mf * d.kf * 32 * sizeof(uint4);  // F fragments
    bytes += (size_t)kWarps * 32 * d.kf * 32;            // parity bits
  }
  return bytes;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Four int8 planes (bits s0..s0+3 of byte b), plane s0 in the low byte.
template <int EXPAND>
__device__ __forceinline__ uint32_t expand4(uint32_t b, int s0) {
  if (EXPAND == kShiftRaw) {
    return (b >> s0) | ((b >> (s0 + 1)) << 8) | ((b >> (s0 + 2)) << 16) |
           ((b >> (s0 + 3)) << 24);
  }
  if (EXPAND == kCmp) {
    const uint32_t masks = 0x08040201u << s0;  // byte q: 2^(s0 + q)
    return __vcmpne4((b * 0x01010101u) & masks, 0u) & 0x01010101u;
  }
  // Spread the 4 bits to 4 bytes: the shifted copies at 0, 7, 14, 21 do
  // not overlap, so the product has no carries.
  const uint32_t bits = (((b >> s0) & 0xFu) * 0x00204081u) & 0x01010101u;
  return EXPAND == kSign ? bits * 0xFFu : bits;  // sign: {0, -1}
}

// The data word of 4 columns (col0 .. col0+3) of one row, zero past the
// edge.  Little-endian: column col0 + j is byte j.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ B,
                                          int row, int k, long long m,
                                          long long col0) {
  if (row >= k) return 0u;
  const uint8_t* src = B + (size_t)row * m + col0;
  if ((m & 3) == 0 && col0 + 3 < m) {
    return *reinterpret_cast<const uint32_t*>(src);
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (col0 + j < m) w |= (uint32_t)src[j] << (8 * j);
  }
  return w;
}

// Store 8 consecutive output bytes of one symbol row.
__device__ __forceinline__ void store8(uint8_t* __restrict__ C, int sym,
                                       long long m, long long col0,
                                       uint32_t lo, uint32_t hi) {
  uint8_t* dst = C + (size_t)sym * m + col0;
  if ((m & 7) == 0 && col0 + 7 < m) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (col0 + j < m) dst[j] = (uint8_t)((j < 4 ? lo : hi) >> (8 * (j & 3)));
  }
}

template <int EXPAND, int REFOLD>
__global__ void __launch_bounds__(kThreads)
    gf_planes_kernel(const uint4* __restrict__ opA,
                     const uint4* __restrict__ opF,
                     const uint8_t* __restrict__ B, uint8_t* __restrict__ C,
                     int k, int p, long long m, int tile, int pinned) {
  extern __shared__ uint4 smem[];
  const Dims d = dims(k, p, EXPAND);
  const int na = d.mt * d.kc * 32;
  const int nf = REFOLD == kDot ? d.mf * d.kf * 32 : 0;
  uint4* a_s = smem;
  uint4* f_s = smem + na;
  for (int i = threadIdx.x; i < na; i += kThreads) a_s[i] = opA[i];
  for (int i = threadIdx.x; i < nf; i += kThreads) f_s[i] = opF[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bits_rows = d.kf * 32;
  uint8_t* bits_s =
      reinterpret_cast<uint8_t*>(f_s + nf) + (size_t)warp * 32 * bits_rows;

  const long long blk0 = (long long)blockIdx.x * tile;
  const long long blk1 = min(m, blk0 + tile);
  const long long rd_off = pinned ? blk0 : 0;
  for (long long base = blk0 + warp * 32; base < blk1;
       base += kWarps * 32) {
    const long long rcol = base - rd_off + 4 * g;  // this lane's 4 columns
    for (int mg = 0; mg < d.mt; mg += 2) {
      int acc[2][4][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[u][j][r] = 0;

      for (int c = 0; c < d.kc; ++c) {
        uint32_t bf[4][2];
        if (EXPAND == kNibble) {
          const uint32_t wd = load4(B, c, k, m, rcol);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = (wd >> (8 * j)) & 0xFFu;
            const uint32_t hi = b >> 4, lo = b & 0xFu;
            bf[j][0] = (hi >> 2) == (uint32_t)t ? 1u << (8 * (hi & 3)) : 0u;
            bf[j][1] = (lo >> 2) == (uint32_t)t ? 1u << (8 * (lo & 3)) : 0u;
          }
        } else {
          const int s0 = (t & 1) * 4;
          const uint32_t w0 = load4(B, c * 4 + (t >> 1), k, m, rcol);
          const uint32_t w1 = load4(B, c * 4 + 2 + (t >> 1), k, m, rcol);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bf[j][0] = expand4<EXPAND>((w0 >> (8 * j)) & 0xFFu, s0);
            bf[j][1] = expand4<EXPAND>((w1 >> (8 * j)) & 0xFFu, s0);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (mg + u < d.mt) {
            const uint4 a = a_s[((mg + u) * d.kc + c) * 32 + lane];
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[u][j], a, bf[j][0], bf[j][1]);
          }
        }
      }

#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int mt = mg + u;
        if (mt >= d.mt) continue;
        if (REFOLD == kSum) {
          // Rows 0-7 of the m-tile are symbol 2*mt, rows 8-15 symbol
          // 2*mt + 1; lane g holds bit g of both.
          uint32_t lo = 0, hi = 0;
          const int sel = g == 0 ? 0 : 16;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t v = ((uint32_t)acc[u][j][0] & 1u) |
                         (((uint32_t)acc[u][j][1] & 1u) << 8) |
                         (((uint32_t)acc[u][j][2] & 1u) << 16) |
                         (((uint32_t)acc[u][j][3] & 1u) << 24);
            v <<= g;
            v |= __shfl_xor_sync(0xffffffffu, v, 4);
            v |= __shfl_xor_sync(0xffffffffu, v, 8);
            v |= __shfl_xor_sync(0xffffffffu, v, 16);
            lo |= ((v >> sel) & 0xFFu) << (8 * j);
            hi |= ((v >> (sel + 8)) & 0xFFu) << (8 * j);
          }
          const int sym = 2 * mt + g;
          if (g < 2 && sym < p) store8(C, sym, m, base + 8 * t, lo, hi);
        } else {
          // Parity bits, column-major per warp: bits_s[col * rows + row],
          // col = 4n + j for n-index n of column group j.
          const int r0 = mt * 16 + g;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bits_s[(8 * t + j) * bits_rows + r0] = (uint8_t)(acc[u][j][0] & 1);
            bits_s[(8 * t + 4 + j) * bits_rows + r0] = (uint8_t)(acc[u][j][1] & 1);
            bits_s[(8 * t + j) * bits_rows + r0 + 8] = (uint8_t)(acc[u][j][2] & 1);
            bits_s[(8 * t + 4 + j) * bits_rows + r0 + 8] = (uint8_t)(acc[u][j][3] & 1);
          }
        }
      }
    }

    if (REFOLD == kDot) {
      // Rows past 16*mt up to 32*kf are left as they are: F is zero there.
      __syncwarp();
      for (int f = 0; f < d.mf; ++f) {
        int out[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) out[j][r] = 0;
        for (int c = 0; c < d.kf; ++c) {
          const uint4 a = f_s[(f * d.kf + c) * 32 + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint8_t* col = bits_s + (4 * g + j) * bits_rows + c * 32 + t * 4;
            mma_u8(out[j], a, *reinterpret_cast<const uint32_t*>(col),
                   *reinterpret_cast<const uint32_t*>(col + 16));
          }
        }
        uint32_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo0 |= ((uint32_t)out[j][0] & 0xFFu) << (8 * j);
          hi0 |= ((uint32_t)out[j][1] & 0xFFu) << (8 * j);
          lo1 |= ((uint32_t)out[j][2] & 0xFFu) << (8 * j);
          hi1 |= ((uint32_t)out[j][3] & 0xFFu) << (8 * j);
        }
        const int sym = f * 16 + g;
        if (sym < p) store8(C, sym, m, base + 8 * t, lo0, hi0);
        if (sym + 8 < p) store8(C, sym + 8, m, base + 8 * t, lo1, hi1);
      }
      __syncwarp();
    }
  }
}

template <int EXPAND, int REFOLD>
int launch_planes(const void* opA, const void* opF, const void* B, void* C,
                  int k, int p, long long m, int tile, int pinned,
                  cudaStream_t stream) {
  const size_t smem = planes_smem(dims(k, p, EXPAND), REFOLD);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_planes_kernel<EXPAND, REFOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (m + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gf_planes_kernel<EXPAND, REFOLD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(opA), static_cast<const uint4*>(opF),
      static_cast<const uint8_t*>(B), static_cast<uint8_t*>(C), k, p, m,
      tile, pinned);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads)
    copy_floor_kernel(const uint8_t* __restrict__ B, uint8_t* __restrict__ C,
                      int k, int p, long long m, int tile, int chunk) {
  extern __shared__ uint4 copy_s[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(copy_s);
  const bool vec = (m & 15) == 0;  // every row start 16-byte aligned
  const long long blk0 = (long long)blockIdx.x * tile;
  const long long blk1 = min(m, blk0 + tile);
  for (long long c0 = blk0; c0 < blk1; c0 += chunk) {
    const int w = (int)min((long long)chunk, blk1 - c0);
    if (vec) {
      const int segs = w / 16;  // w is a multiple of 16 here
      for (int idx = threadIdx.x; idx < k * segs; idx += kThreads) {
        const int r = idx / segs, s = idx % segs;
        cp_async16(buf + (size_t)r * chunk + s * 16,
                   B + (size_t)r * m + c0 + s * 16);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (int idx = threadIdx.x; idx < p * segs; idx += kThreads) {
        const int r = idx / segs, s = idx % segs;
        *reinterpret_cast<uint4*>(C + (size_t)r * m + c0 + s * 16) =
            *reinterpret_cast<const uint4*>(buf + (size_t)r * chunk + s * 16);
      }
    } else {
      for (int idx = threadIdx.x; idx < k * w; idx += kThreads) {
        const int r = idx / w, s = idx % w;
        buf[(size_t)r * chunk + s] = B[(size_t)r * m + c0 + s];
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < p * w; idx += kThreads) {
        const int r = idx / w, s = idx % w;
        C[(size_t)r * m + c0 + s] = buf[(size_t)r * chunk + s];
      }
    }
    __syncthreads();
  }
}

// Every (expand, refold) pair: the sweep's bodies and both refolds of
// every expansion the probe names.
#define RS_PLANES_PAIRS(X)            \
  X(kShift, kSum) X(kShift, kDot)     \
  X(kShiftRaw, kSum) X(kShiftRaw, kDot) \
  X(kCmp, kSum) X(kCmp, kDot)         \
  X(kSign, kSum) X(kSign, kDot)       \
  X(kNibble, kSum) X(kNibble, kDot)

}  // namespace

extern "C" {

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory the GEMM needs at (k, p), in bytes, and its limit.
long long rs_gf_planes_smem(int k, int p, int expand, int refold) {
  return (long long)planes_smem(dims(k, p, expand), refold);
}
int rs_gf_planes_smem_limit() { return kMaxSmem; }

// C = A . B over GF(2^8) with the (expand, refold) formulation.
//   opA: operator fragments, opF: F fragments (refold dot; else unused).
//   B: (k, m) uint8, C: (p, m) uint8, row-major.  tile: columns per block,
//   a positive multiple of 32.  pinned != 0: every block reads block 0.
int rs_gf_planes(const void* opA, const void* opF, const void* B, void* C,
                 int k, int p, long long m, int tile, int expand, int refold,
                 int pinned, void* stream) {
  if (k <= 0 || p <= 0 || m < 0 || tile <= 0 || tile % 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_CALL(E, R)                                                   \
  if (expand == E && refold == R)                                       \
    return launch_planes<E, R>(opA, opF, B, C, k, p, m, tile, pinned, s);
  RS_PLANES_PAIRS(RS_CALL)
#undef RS_CALL
  return (int)cudaErrorInvalidValue;
}

// C = B[:p] through shared memory: (k, m) uint8 in, (p, m) uint8 out.
// tile: columns per block, a positive multiple of 32.
int rs_copy_floor(const void* B, void* C, int k, int p, long long m, int tile,
                  void* stream) {
  if (k <= 0 || p <= 0 || p > k || m < 0 || tile <= 0 || tile % 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  int chunk = (kCopyBudget / k) & ~31;
  if (chunk < 32) return (int)cudaErrorInvalidValue;
  if (chunk > tile) chunk = tile;
  const size_t smem = (size_t)k * chunk;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        copy_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (m + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_floor_kernel<<<(unsigned)blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(B), static_cast<uint8_t*>(C), k, p, m, tile,
      chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
