// Packed two-column GF(2^8) GEMM for Hopper (sm_90a): C = A . B, w = 8.
//
// Replaces the JAX package's TPU kernel ops/pallas_gemm.py::_kernel_pack2
// (launched by _pallas_matmul_pack2 once per carry-free depth slice, the
// slices XORed by gf_matmul_pallas).  Same function: two adjacent data
// bytes share one uint16 lane, bit plane s of both is (v >> s) & 0x0101,
// the (p*8, k*8) 0/1 operator selects which planes are summed into each
// output bit's accumulator, and acc & 0x0101 refolded over the 8 output bits
// gives both output bytes of the lane at once.  The TPU kernel ran that
// product as an f32 matmul on its matrix unit; here it runs on the fp16
// tensor cores, mma.sync.m16n8k16 with f32 accumulation.
//
// Bound on the card: the bytes, (k + p) * m, at the memory rate.  The
// tensor-core work is small (p*8 x k*8 fp16 multiply-adds per uint16 lane,
// about 1 % of the card's fp16 rate at k=10, p=4); what costs instruction slots
// is building the B fragments and refolding the accumulators, so the design
// keeps both to a few integer instructions per register, and keeps enough
// loads in flight to cover the memory's latency:
//   * Exactness.  A plane value x is 0, 1, 256 or 257.  x | 0x6400 is the
//     fp16 value 1024 + x exactly (x < 1024), so the B fragments need no
//     conversion.  The offset adds 1024 per selected plane, which touches
//     bits 10 and up only.  Each 8-bit field sums at most 8 * 30 = 240
//     planes per depth slice (below 256: no carry), and the largest
//     accumulator, 240 * 1281 = 307,440, is an exact f32 integer.
//   * Operator as the A operand.  The operator, zero-padded to 16-row
//     m-tiles and k16-steps, is packed on the host in A-fragment order as
//     fp16 (one uint4 per lane per (m-tile, k-step)) and staged in shared
//     memory once per block (but see the large-operator case below).  One k16-step covers data symbols 2c and
//     2c + 1: depth row i*8 + s is plane s of symbol i.
//   * Loads.  A warp's work is a list of (128-column step, pass over a
//     pair of m-tiles, depth slice) triples.  Each triple's rows are copied
//     into a per-warp shared-memory buffer by cp.async, 16 bytes a lane,
//     one triple ahead of the one being computed (two buffers), so a warp
//     keeps up to 30 * 128 bytes in flight without spending registers on
//     them.  Rows past k are not copied: their operator columns are zero,
//     and whatever bits the buffer holds make a finite B value.
//   * Packed planes as the B operand, built in registers.  A warp takes 64
//     uint16 lanes (128 columns) a step as 8 mma column groups; n-index n
//     of group j is lane 8n + j.  So lane (g = lane/4, t = lane%4) reads the
//     8 uint16s 8g..8g+7 of a row as 16 bytes, and its B registers for
//     group j hold planes 2t and 2t+1 of lane 8g + j: of symbol 2c in b0,
//     of symbol 2c + 1 in b1.  Two shifts, two LOP3 and two PRMT make the
//     registers of two groups.  One A fragment serves the 8 mma of a step.
//   * Refold.  A C fragment holds output bit g of symbols 2mt (rows g) and
//     2mt + 1 (rows g + 8) at n = 2t, 2t + 1.  acc + 2^23 puts the integer
//     in the float's low mantissa bits (no F2I); PRMT and a mask pack the
//     two columns' parity bits of one symbol into a word, shifted to bit g.
//     One xor-shuffle over g's high bit trades the two symbols (each half
//     of the warp keeps one), two more OR over g's low bits; lanes g = 0
//     and g = 4 then hold the finished lanes of symbols 2mt and 2mt + 1,
//     16 consecutive uint16 lanes each, stored as two 16-byte words.
//   * Depth slices inside the kernel: 30 data symbols (15 k-steps) each,
//     even, so no k-step straddles two.  Each slice's accumulators are
//     refolded and XORed into the warp's running output words (in shared
//     memory when there is more than one slice), so C is written once for
//     any k, with no partial in device memory.
//   * m-tiles run in pairs (64 accumulators a thread); p > 4 takes several
//     passes, each copying its rows again (from L2).  An operator too large
//     for shared memory (p * k above about 1,200) is read from device
//     memory through L1 instead of staged (gf_pack2_kernel<false>).
//   * Edges.  The wrapper pads an odd m to even.  Copies read nothing past
//     the last lane, and stores past it are dropped; rows that do not start
//     16-byte aligned are copied byte by byte and stored as uint16s.  tile
//     (columns per block) is a multiple of 128.
//
// Plain C interface (bound with ctypes): every entry returns a
// cudaError_t value; the launch runs on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 8;                  // mma column groups a warp step
constexpr int kWarpLanes = 8 * kGroups;     // uint16 lanes a warp step
constexpr int kSlice = 30;                  // data symbols per carry-free slice
constexpr int kSliceSteps = kSlice / 2;     // k16-steps per slice
constexpr int kRowBytes = 2 * kWarpLanes;   // a data row's bytes a warp step
constexpr int kChunkRows = 32 / kGroups;    // rows a warp copies per 16-byte chunk a lane
constexpr int kBufBytes = kSlice * kRowBytes;  // one slice of a warp step
constexpr int kStages = 2;                  // slice buffers a warp: 1 in flight
constexpr int kMaxSmem = 227 * 1024;

struct Dims {
  int mt;  // 16-row m-tiles of the operator (p*8 rows)
  int ks;  // k16-steps of its depth (two data symbols each)
};

__host__ __device__ inline Dims dims(int k, int p) {
  return Dims{(p * 8 + 15) / 16, (k + 1) / 2};
}

__host__ __device__ inline int slices(const Dims& d) {
  return (d.ks + kSliceSteps - 1) / kSliceSteps;
}

// Shared memory: the A fragments (when they fit), each warp's slice
// buffers and, with more than one slice, each warp's running output words
// of its pair of m-tiles.
inline size_t pack2_smem(int k, int p, bool a_shared) {
  const Dims d = dims(k, p);
  size_t bytes = a_shared ? (size_t)d.mt * d.ks * 32 * sizeof(uint4) : 0;
  bytes += (size_t)kWarps * kStages * kBufBytes;
  if (slices(d) > 1) bytes += (size_t)kWarps * 2 * kGroups * 32 * sizeof(uint32_t);
  return bytes;
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint4& a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Start copying the rows < k of one slice of a warp step into `buf`
// (kRowBytes a row).  Lane L copies the 16-byte chunks q = L, L + 32, ...
// below `chunks` (row q / kGroups, bytes 16 * (q % kGroups)); `src` points
// at its first chunk and `rows_stride` is the stride of kChunkRows rows.
// `bytes` is 16, or fewer in the ragged last step, where cp.async fills the
// rest of the chunk with zeros.  Rows >= k are not copied: their operator
// columns are zero, and any bits make a finite B value.  Every row starts
// 16-byte aligned here; fetch_bytes is the path for rows that do not.
__device__ __forceinline__ void fetch(uint8_t* buf, const uint8_t* src,
                                      long long rows_stride, int chunks, int bytes,
                                      int lane) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf) + lane * 16;
#pragma unroll
  for (int i = 0; i < (kSlice * kGroups + 31) / 32; ++i) {
    const int on = lane + 32 * i < chunks;
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
        " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(
            dst + 512 * i),
        "l"(src), "r"(bytes), "r"(on));
    src += rows_stride;
  }
}

__device__ __noinline__ void fetch_bytes(uint8_t* buf, const uint8_t* src,
                                         long long rows_stride, int chunks,
                                         int bytes, int lane) {
  for (int q = lane; q < chunks; q += 32, src += rows_stride) {
    for (int e = 0; e < bytes; ++e) buf[q * 16 + e] = src[e];
  }
}

// `one` holds 0x64006400, so that (v & 0x01010101) | one is one LOP3.
__device__ __forceinline__ uint32_t fp16_planes(uint32_t v, uint32_t one) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(v), "n"(0x01010101), "r"(one));
  return r;
}

__device__ __forceinline__ void planes2(uint32_t W, int s, uint32_t one,
                                        uint32_t& lo, uint32_t& hi) {
  const uint32_t x = fp16_planes(W >> s, one);
  const uint32_t y = fp16_planes(W >> (s + 1), one);
  lo = __byte_perm(x, y, 0x5410);
  hi = __byte_perm(x, y, 0x7632);
}

// An exact integer-valued float below 2^23 -> a word whose low 23 bits are
// that integer.
__device__ __forceinline__ uint32_t int_bits(float a) {
  return __float_as_uint(a + 8388608.0f);
}

// One group's C fragment -> the packed output word of this lane's half of
// the warp: for g < 4 lanes n = 2t (low half) and 2t + 1 (high half) of
// symbol 2mt, for g >= 4 the same of symbol 2mt + 1.
__device__ __forceinline__ uint32_t refold(const float (&c)[4], int g,
                                           bool upper) {
  const uint32_t w0 =
      (__byte_perm(int_bits(c[0]), int_bits(c[1]), 0x5410) & 0x01010101u) << g;
  const uint32_t w1 =
      (__byte_perm(int_bits(c[2]), int_bits(c[3]), 0x5410) & 0x01010101u) << g;
  uint32_t v = (upper ? w1 : w0) |
               __shfl_xor_sync(0xffffffffu, upper ? w0 : w1, 16);
  v |= __shfl_xor_sync(0xffffffffu, v, 4);
  v |= __shfl_xor_sync(0xffffffffu, v, 8);
  return v;
}

// Store uint16 lanes u..u + 2*kGroups - 1 of output symbol `sym`: lanes
// u + j and u + kGroups + j are the low and high halves of out[j].
__device__ __forceinline__ void store_lanes(uint8_t* __restrict__ C, int sym,
                                            long long m2, long long u,
                                            const uint32_t (&out)[kGroups]) {
  uint32_t o[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups / 2; ++q) {
    o[q] = __byte_perm(out[2 * q], out[2 * q + 1], 0x5410);
    o[kGroups / 2 + q] = __byte_perm(out[2 * q], out[2 * q + 1], 0x7632);
  }
  uint8_t* dst = C + ((size_t)sym * m2 + u) * 2;
  if (u + 2 * kGroups <= m2 && ((uintptr_t)dst & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kGroups; q += 4) {
      reinterpret_cast<uint4*>(dst)[q / 4] = make_uint4(o[q], o[q + 1], o[q + 2], o[q + 3]);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 2 * kGroups; ++q) {
    if (u + q < m2) {
      reinterpret_cast<uint16_t*>(dst)[q] = (uint16_t)(o[q / 2] >> (16 * (q & 1)));
    }
  }
}

// kASmem: the A fragments are staged in shared memory; otherwise (an
// operator too large for it) each is read from device memory through L1.
template <bool kASmem>
__global__ void __launch_bounds__(kThreads)
    gf_pack2_kernel(const uint4* __restrict__ opA,
                    const uint8_t* __restrict__ B, uint8_t* __restrict__ C,
                    int k, int p, long long m2, int lanes_per_block) {
  extern __shared__ uint4 smem[];
  const Dims d = dims(k, p);
  const int nsl = slices(d);
  const int na = kASmem ? d.mt * d.ks * 32 : 0;
  if (kASmem) {
    for (int i = threadIdx.x; i < na; i += kThreads) smem[i] = opA[i];
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool upper = g >= 4;
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem + na) + (size_t)warp * kStages * kBufBytes;
  uint32_t* out_s = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(smem + na) +
                                                (size_t)kWarps * kStages * kBufBytes) +
                    warp * 2 * kGroups * 32 + lane;
  const bool vec = ((uintptr_t)B & 15) == 0 && (m2 & 7) == 0;

  // A warp's work is a list of (step, pass, slice) triples, slice fastest:
  // a step is kWarpLanes uint16 lanes, a pass a pair of m-tiles.  The rows
  // of a triple's slice are copied kStages - 1 triples ahead of its compute.
  const long long stride = kWarps * kWarpLanes;
  const long long first = (long long)blockIdx.x * lanes_per_block + warp * kWarpLanes;
  const long long blk1 = min(m2, (long long)(blockIdx.x + 1) * lanes_per_block);
  const long long rows_stride = kChunkRows * 2 * m2;
  const long long slice_bytes = (long long)kSlice * 2 * m2;
  const int part = lane % kGroups;  // this lane's 16 bytes of a row
  const uint8_t* lane_src = B + (lane / kGroups) * 2 * m2 + 16 * part;
  auto advance = [&](long long& base, int& mg, int& sl) {
    if (++sl == nsl) {
      sl = 0;
      mg += 2;
      if (mg >= d.mt) {
        mg = 0;
        base += stride;
      }
    }
  };
  long long f_base = first;
  int f_mg = 0, f_sl = 0, f_buf = 0;
  auto fetch_next = [&]() {
    if (f_base < blk1) {
      const long long left = 2 * (m2 - f_base) - 16 * part;  // bytes
      const int bytes = left >= 16 ? 16 : (int)max(0LL, left);
      const int chunks = bytes ? kGroups * min(kSlice, k - f_sl * kSlice) : 0;
      const uint8_t* src = lane_src + 2 * f_base + f_sl * slice_bytes;
      uint8_t* buf = bufs + f_buf * kBufBytes;
      if (vec) {
        fetch(buf, src, rows_stride, chunks, bytes, lane);
      } else {
        fetch_bytes(buf, src, rows_stride, chunks, bytes, lane);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    advance(f_base, f_mg, f_sl);
    f_buf = f_buf + 1 == kStages ? 0 : f_buf + 1;
  };
  for (int n = 0; n < kStages - 1; ++n) fetch_next();

  const uint32_t one = 0x64006400u;
  long long base = first;
  int mg = 0, sl = 0, cbuf = 0;
  while (base < blk1) {
    fetch_next();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const uint8_t* rows = bufs + cbuf * kBufBytes + 2 * kGroups * g;
    const int c0 = sl * kSliceSteps;
    const int c1 = min(d.ks, c0 + kSliceSteps);
    float acc[2][kGroups][4] = {};
    for (int c = c0; c < c1; ++c) {
      const uint2* wa = reinterpret_cast<const uint2*>(rows + (2 * (c - c0)) * kRowBytes);
      const uint2* wb = reinterpret_cast<const uint2*>(rows + (2 * (c - c0) + 1) * kRowBytes);
      uint32_t b0[kGroups], b1[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups / 4; ++q) {
        const uint2 x = wa[q], y = wb[q];
        planes2(x.x, 2 * t, one, b0[4 * q], b0[4 * q + 1]);
        planes2(x.y, 2 * t, one, b0[4 * q + 2], b0[4 * q + 3]);
        planes2(y.x, 2 * t, one, b1[4 * q], b1[4 * q + 1]);
        planes2(y.y, 2 * t, one, b1[4 * q + 2], b1[4 * q + 3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (mg + u < d.mt) {
          const int ia = ((mg + u) * d.ks + c) * 32 + lane;
          const uint4 a = kASmem ? smem[ia] : __ldg(opA + ia);
#pragma unroll
          for (int j = 0; j < kGroups; ++j) mma_f16(acc[u][j], a, b0[j], b1[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (mg + u >= d.mt) continue;
      uint32_t res[kGroups];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        res[j] = refold(acc[u][j], g, upper);
        if (nsl > 1) {  // XOR the slices in the warp's output words
          uint32_t* o = out_s + (u * kGroups + j) * 32;
          if (sl > 0) res[j] ^= *o;
          if (sl + 1 < nsl) *o = res[j];
        }
      }
      const int sym = 2 * (mg + u) + (upper ? 1 : 0);
      if (sl + 1 == nsl && (g & 3) == 0 && sym < p) {
        store_lanes(C, sym, m2, base + 2 * kGroups * t, res);
      }
    }
    __syncwarp();
    advance(base, mg, sl);
    cbuf = cbuf + 1 == kStages ? 0 : cbuf + 1;
  }
}

template <bool kASmem>
int launch_pack2(const void* opA, const void* B, void* C, int k, int p,
                 long long m2, int lanes_per_block, cudaStream_t stream) {
  const size_t smem = pack2_smem(k, p, kASmem);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_pack2_kernel<kASmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (m2 + lanes_per_block - 1) / lanes_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gf_pack2_kernel<kASmem><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(opA), static_cast<const uint8_t*>(B),
      static_cast<uint8_t*>(C), k, p, m2, lanes_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C = A . B over GF(2^8), two columns per uint16 lane.
//   opA: operator A fragments, (mt, ks, 32 lanes) uint4, fp16 0/1.
//   B:   (k, 2*m2) uint8, row-major (m2 uint16 lanes a row).
//   C:   (p, 2*m2) uint8, row-major.
//   tile: columns per block, a positive multiple of 2 * kWarpLanes.
int rs_gf_pack2(const void* opA, const void* B, void* C, int k, int p,
                long long m2, int tile, void* stream) {
  if (k <= 0 || p <= 0 || m2 < 0 || tile <= 0 || tile % (2 * kWarpLanes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m2 == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack2_smem(k, p, true) <= (size_t)kMaxSmem) {
    return launch_pack2<true>(opA, B, C, k, p, m2, tile / 2, s);
  }
  return launch_pack2<false>(opA, B, C, k, p, m2, tile / 2, s);
}

}  // extern "C"
