// Packed two-column GF(2^8) GEMM for Hopper (sm_90a): C = A . B, w = 8.
//
// Replaces the JAX package's TPU kernel ops/pallas_gemm.py::_kernel_pack2
// (launched by _pallas_matmul_pack2 once per carry-free depth slice, the
// slices XORed by gf_matmul_pallas).  Same function: two adjacent data
// bytes share one integer lane, bit plane s of both is (v >> s) & 0x0101,
// the operator's 0/1 entries select which planes are summed into each
// output bit's accumulator, and the packed refold yields both output bytes
// of the lane at once.
//
// Bound on the card: integer issue, not bytes.  The function moves
// (k + p) * m bytes, but every lane (two columns) needs p*8 * k*8 selected
// adds; at the main path's shape (k=10, p=4) that is about 1,300 integer
// operations per column, several times what the memory rate leaves room
// for.  The design keeps everything else minimal:
//   * One thread owns one uint16 lane (columns 2l, 2l+1) per step; a block
//     covers tile/2 lanes.  Loads and stores are coalesced uint16s.
//   * The operator lives in shared memory as one 64-bit word per
//     (output symbol o, data symbol i): bit (t*8 + s) is the coefficient of
//     output bit t on data bit s.  Every thread reads the same word at once
//     (broadcast).
//   * Field carries: each 8-bit field of an accumulator sums at most
//     8 * 31 = 248 planes, so it never carries into the next field.  Depth
//     beyond 31 symbols runs as ceil(k/31) slices INSIDE the kernel: the
//     slice loop is outside the loop over output rows, so each slice of B
//     is loaded once per lane, and each output row's refolded slices are
//     XORed into a partial result the thread keeps in shared memory.  B is
//     read once and C written once for every k (the TPU version launched
//     once per slice and XORed in device memory).
//   * An odd m is padded to even by the wrapper, as the JAX version does.
//
// Plain C interface (bound with ctypes): every entry returns a
// cudaError_t value; the launch runs on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 31;  // data symbols per carry-free slice (depth 248)
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void load_slice(uint32_t (&v)[kSlice],
                                           const uint16_t* __restrict__ B,
                                           int i0, int kk, long long m2,
                                           long long lane) {
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    v[i] = i < kk ? (uint32_t)B[(size_t)(i0 + i) * m2 + lane] : 0u;
  }
}

// One output symbol's two bytes from one carry-free slice of kk <= 31 data
// symbols: the selected planes summed per output bit, then refolded.
__device__ __forceinline__ uint32_t slice_product(
    const uint32_t (&v)[kSlice], const uint2* ops, int kk) {
  uint32_t acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t] = 0;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    if (i < kk) {
      const uint2 wd = ops[i];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint32_t plane = (v[i] >> s) & 0x0101u;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const uint32_t word = t < 4 ? wd.x : wd.y;
          acc[t] += plane * ((word >> ((t & 3) * 8 + s)) & 1u);
        }
      }
    }
  }
  uint32_t packed = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) packed |= (acc[t] & 0x0101u) << t;
  return packed;
}

__global__ void __launch_bounds__(kThreads)
    gf_pack2_kernel(const uint2* __restrict__ op,
                    const uint16_t* __restrict__ B, uint16_t* __restrict__ C,
                    int k, int p, long long m2, int lanes_per_block) {
  // Shared memory: the p*k operator words, then, when there is more than
  // one slice, p partial results per thread (row o at o*kThreads + thread).
  extern __shared__ uint2 op_s[];
  uint16_t* part_s = reinterpret_cast<uint16_t*>(op_s + (size_t)p * k);
  for (int i = threadIdx.x; i < p * k; i += kThreads) op_s[i] = op[i];
  __syncthreads();

  const int nsl = (k + kSlice - 1) / kSlice;
  const long long l0 = (long long)blockIdx.x * lanes_per_block;
  const long long l1 = min(m2, l0 + lanes_per_block);
  for (long long lane = l0 + threadIdx.x; lane < l1; lane += kThreads) {
    for (int sl = 0; sl < nsl; ++sl) {
      const int i0 = sl * kSlice;
      const int kk = min(kSlice, k - i0);
      uint32_t v[kSlice];
      load_slice(v, B, i0, kk, m2, lane);
      for (int o = 0; o < p; ++o) {
        uint32_t res = slice_product(v, op_s + (size_t)o * k + i0, kk);
        uint16_t* part = part_s + (size_t)o * kThreads + threadIdx.x;
        if (sl > 0) res ^= *part;
        if (sl + 1 < nsl) {
          *part = (uint16_t)res;
        } else {
          C[(size_t)o * m2 + lane] = (uint16_t)res;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C = A . B over GF(2^8), two columns per uint16 lane.
//   op: (p * k) 64-bit operator words, word (o, i) at index o*k + i.
//   B:  (k, m2) uint16 lanes (the (k, 2*m2) uint8 data, row-major).
//   C:  (p, m2) uint16 lanes (the (p, 2*m2) uint8 output).
//   tile: columns per block (even, >= 2).
int rs_gf_pack2(const void* op, const void* B, void* C, int k, int p,
                long long m2, int tile, void* stream) {
  if (k <= 0 || p <= 0 || m2 < 0 || tile < 2 || (tile & 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m2 == 0) return (int)cudaSuccess;
  const bool sliced = k > kSlice;
  const size_t smem = (size_t)p * k * sizeof(uint2) +
                      (sliced ? (size_t)p * kThreads * sizeof(uint16_t) : 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_pack2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int lanes_per_block = tile / 2;
  const long long blocks = (m2 + lanes_per_block - 1) / lanes_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gf_pack2_kernel<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(op), static_cast<const uint16_t*>(B),
      static_cast<uint16_t*>(C), k, p, m2, lanes_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
