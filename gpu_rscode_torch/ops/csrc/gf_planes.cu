// Bit-plane GF(2^4), GF(2^8) and GF(2^16) GEMMs on the int8 tensor cores,
// and the copy floor, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel tools/kernel_sweep.py::make_fn
// (its pallas_call `run`, with the bodies _body_base, _body_cmp,
// _body_sign, _body_signc, _body_signf, _body_nibble, _body_raw_dot and
// _body_dma, and the pinned-input mode), and with it the expansion and
// refold variants of ops/pallas_gemm.py::_kernel_body (_expand_shift,
// _expand_shift_raw, _expand_sign, _expand_nibble; refold "sum" and "dot";
// fold=False, the pre-parity accumulators), at w=8, for the three
// lane-width expansions at w=16, and for shift and shift_raw at w=4.
//
// Which kernel runs which (w, expand, refold): the refold picks it, the
// width is its template argument W.
//   sum    gf_planes_sum_kernel<W, E, SRC>    w=8: every expansion;
//   dot    gf_planes_dot_kernel<W, E, SRC>    w=16: shift, shift_raw, sign;
//   none   gf_planes_none_kernel<W, E, SRC>   w=4: shift, shift_raw
// SRC is where a launch reads its operator and data from (route()): both
// through shared memory (kStaged), the operator through L1 beside the ring
// (kOpL1: nibble's sum and dot past its shared-memory edge), or both
// through L1 from device memory (kDirect: w=4 and w=16, and the pre-parity
// form at w=8, past their edge).  w=8's folded byte expansions are refused
// past theirs.
//
// gf_planes_sum_kernel<W, EXPAND, SRC>: C = A . B with the sum refold.
//   Bound on the card: device-memory bytes, (k + p) * m * b, b the bytes a
//   symbol takes (2 at W=16, else 1).  The product is p*W x k*W (k*32 for
//   nibble) int8 multiply-adds per column, about 1 % of the int8
//   tensor-core rate at the main path's shape; what costs instruction
//   slots is building the planes and refolding, so the design cuts both
//   per column:
//   * The operator scaled by 2^s.  The host packs output plane s's operator
//     row times 2^s (0 or 2^s <= 128: u8), so bit s of the int32
//     accumulator is already output bit s (every term is a multiple of
//     2^s).  mma.sync.m16n8k32 is u8 x u8, or u8 x s8 for sign's {0, -1}
//     planes.  Plane values other than 0/1 (shift_raw's high bits, sign's
//     -1) add only at or above bit s + 1, or keep bit s's parity.  The mma
//     adds without .satfinite, modulo 2^32, so bit s stays exact at any
//     depth (the sums stay below 2^31 wherever the operator is staged).
//   * Four-symbol plane words.  Inside a 32-deep chunk c, depth
//     h*16 + t*4 + q is plane 4h + t of symbol 4c + q (the host packs A to
//     that order), so B register b0 of lane (g, t) is plane t of symbols
//     4c..4c+3 of its column and b1 plane 4 + t.  A lane reads rows
//     4c..4c+3 at its 8 columns (two words each), transposes each 4x4 byte
//     block with 8 PRMT to one word per column (byte q: symbol 4c + q), and
//     makes each plane register from that word in 1-3 instructions.
//   * A warp step is 64 columns as 8 mma column groups: n-index n of group
//     j is column 8n + j, so lane g reads bytes 8g..8g+7 of a row, and one
//     LDS.128 of A serves 8 mma.  m-tiles run in pairs (64 accumulators);
//     the host pads the operator to an even number of m-tiles, so a pass
//     has no branch and builds each plane register once for both.
//   * Loads.  Each step's k rows are copied by cp.async into a per-warp
//     shared-memory ring, up to kSumStages - 1 steps ahead of the compute;
//     every pass over a pair of m-tiles reads them there.  Rows at or past
//     k are not copied: their operator columns are zero.  Rows that do not
//     start 16-byte aligned are copied byte by byte.  kDirect instead
//     reads each lane's 8 columns of a row from device memory (zero past k
//     and past m): its later passes hit L1.
//   * Refold.  A C fragment holds bit g of symbols 2mt (rows g) and
//     2mt + 1 (rows g + 8) at n = 2t, 2t + 1.  Three PRMT gather the low
//     bytes of the 4 accumulators into one word, one mask keeps bit g of
//     each byte, and three xor-shuffles, each with an OR, collect bits 0-7.
//     Lanes g < 4 then hold byte g of 8 group words: 8 consecutive output
//     bytes of one symbol, made with 6 PRMT and stored as one 8-byte word.
//   * W=16: a 16-bit symbol is two byte-symbols, its low byte (bits 0-7)
//     and its high byte (8-15), and the (16p, 16k) GF(2) operator is the
//     same matrix read as the (2p*8, 2k*8) operator over them.  The host
//     scales its rows as at W=8 (bits 8-15 by 2^(s-8)), so the folded
//     forms need only bit (s mod 8) of each accumulator and the W=8 plane
//     words serve unchanged.  A step's row is 128 bytes (lo, hi of each
//     column); chunk c is symbols 2c and 2c + 1, and a lane reads its 16
//     bytes of both rows (one LDS.128 each) and splits the low and high
//     bytes with 8 PRMT into the same words (byte q: lo(2c), hi(2c),
//     lo(2c + 1), hi(2c + 1)).  An m-tile is one 16-bit symbol: after the
//     refold, lanes g < 2 interleave the low and high bytes of 8 columns
//     with 4 PRMT and store them as one 16-byte word.
//   * W=4: a symbol is one byte, its bits 4-7 ignored (shift masks them
//     off; shift_raw's r >> t carries them, and the next byte's bits, only
//     at 2^1 and up).  A 32-deep chunk c is 8 symbols: depth 16h + 4t + q
//     is plane t of symbol 8c + 4h + q, so b0 of lane (g, t) is plane t of
//     the transposed word of rows 8c..8c+3 and b1 of rows 8c + 4..8c + 7
//     (zero, with no reads, where row 8c + 4 is past k): step_words runs
//     twice a chunk, 2 chunks a step at k=10 against w=8's 3.  A 16-row
//     m-tile is 4 symbols: row g of the C fragment is bit g & 3 of symbol
//     4mt + g / 4 and row g + 8 of symbol 4mt + 2 + g / 4, so the mask
//     keeps bit g & 3 and two xor-shuffles (g ^ 1, g ^ 2) collect a
//     symbol's 4 bits; every lane then stores 8 bytes (byte g & 3 of the
//     group words), symbol 4mt + g / 4 + 2((g / 2) & 1).  Where the p*4
//     rows leave the last m-tile unpaired (p=4: one m-tile), the last pass
//     runs it alone (kW4Single), not beside an m-tile of padding.
//   * tile (columns a block covers) is a multiple of the 64-column step;
//     pinned: every block reads the columns of block 0 and writes its own
//     block, the compute-only ceiling (the input is served from L2).
//
// gf_planes_dot_kernel<W, EXPAND, SRC>: the same expansions with the dot
//   refold (shift_raw+dot is the JAX package's production pair at w=8).
//   It shares the sum kernel's operator (scaled by 2^s, four-symbol plane
//   words), its ring of 64-column steps, its transposes and plane words;
//   the first product is the same work with the operands' roles swapped,
//   so that the second product needs no data movement between lanes:
//   * First product, transposed: D (16 columns x 8 accumulator rows) +=
//     planes (16 x 32, the A operand) . operator (32 x 8, the B operand).
//     A's row g is column 8g + mb of m-block mb (mb = 0..3), row g + 8 is
//     column 8g + 4 + mb: exactly the words r[mb] and r[4 + mb] a lane
//     transposes, so a0..a3 are the sum kernel's plane words of those two
//     columns, planes t and 4 + t.  The host packs the operator as B
//     fragments, two 8-row n-tiles a uint4 (one LDS.128 per 8 mma).  A pass
//     covers 4 n-tiles (32 rows: 4 symbols; the operator is padded as the
//     sum kernel's, to whole pairs of 16-row tiles), 4 m-blocks x 4 n-tiles
//     = 64 accumulators, with no branch.
//   * The move to the second operand.  In mma.m16n8k32 the C fragment of
//     lane (g, t) holds rows g and g + 8 at columns 2t, 2t + 1, and the A
//     fragment of the same lane rows g and g + 8 at depths 4t..4t+3 and
//     16 + 4t..: the same lane owns the same rows (data columns).  So the
//     accumulators (symbol nt of the pass, bits 2t and 2t + 1) of n-tiles
//     nt = 0, 1 become depths 4t..4t+3 and those of n-tiles 2, 3 depths
//     16 + 4t.., each byte masked to its output bit (acc & 2^s, at most
//     128): 3 PRMT and one AND a register, 16 a m-block, and no shuffle,
//     movmatrix or shared memory (tests/test_torch_k3_dot.py checks that
//     the move stays inside the lane).
//   * Second product: out (16 columns x 8 symbols) += bits (16 x 32) . F
//     (32 x 8, 0/1: depth d of pass Q of an 8-symbol tile to symbol
//     4Q + the n-tile of d), u8 x u8, one mma a m-block and pass.  Each sum
//     is one output byte, sum_s (acc & 2^s) < 256.  F's two B fragments are
//     packed on the host and held in 4 registers.
//   * Stores.  The second product's lane (g, t) holds symbols 8f + 2t and
//     8f + 2t + 1 of columns 8g + mb and 8g + 4 + mb, mb = 0..3: 8
//     consecutive bytes of two symbols, made with 6 PRMT each and stored as
//     one 8-byte word each (byte by byte at the ragged edge).  At W=16
//     those two byte-symbols are the low and high bytes of symbol 4f + t:
//     12 PRMT make its 8 columns, stored as one 16-byte word.
//   * W=4: the sum kernel's 8-symbol chunks, so a0..a3 are plane t of rows
//     8c..8c+3 (columns 8g + mb, 8g + 4 + mb) and of rows 8c + 4..8c + 7.
//     An 8-row n-tile is 2 symbols: register 2t (+1) of n-tile nt is bit
//     2(t & 1) (+1) of symbol 8 pass + 2nt + t / 2, so the move keeps the
//     same PRMT with the mask 0x02010201 << 2(t & 1), and F takes depth
//     16h + 4t + e to symbol 4h + 2(e / 2) + t / 2: one pass is a whole
//     8-symbol tile, and the stores are W=8's.
//
// gf_planes_none_kernel<W, EXPAND, SRC>: the pre-parity form (JAX's
//   fold=False), the (p*W, m) int32 sums, equal value for value to JAX's
//   with acc_dtype=int8.  Bound: (k * b + 4 * p * W) * m bytes, the sums'
//   stores most of it.  The sum kernel's first product
//   (its ring, transposes, four-symbol plane words, m-tile pairs and at
//   W=4 its lone last m-tile) with:
//   * The unscaled 0/1 operator in the same depth order, and JAX's plane
//     values exactly: shift and cmp 0/1, sign {0, -1}, shift_raw
//     int8(b >> s) (the next byte's bits that r >> s carries masked off, a
//     signed operand), nibble 0/1 (the PRMT sign rule's 0xFF and 0x80 for
//     v >= 8 ANDed to 1 and 0).  u8 x s8 for sign and shift_raw.  At W=16
//     JAX's shift_raw plane s < 8 is the low byte of the whole 16-bit
//     b >> s: in the word lo(2c), hi(2c), lo(2c + 1), hi(2c + 1), r >> s
//     is exactly that for a low byte, and a high byte's plane is w=8's, so
//     one AND with 0x00FF00FF | (0xFF >> s) * 0x01000100 makes all four.
//     The unscaled operator's rows i*16 + 8h + s' are JAX's rows i*16 + s
//     (sum_operator(A, 16, scaled=False)), so the 16p rows are staged and
//     stored as w=8's 2p byte-symbols' are.
//   * An epilogue through shared memory.  Lane (g, t) holds rows g and
//     g + 8 of each m-tile at columns 16t..16t+15: 4 STS.128 a row into a
//     warp's staging rows (32 rows of 64 int32, 288 bytes apart, 16-byte
//     chunks swizzled by c ^ (c >> 3) so that neither side conflicts),
//     then each STG.128 writes two whole 256-byte row segments (lane L:
//     row 2i + L / 16, chunk L % 16), streaming (st.global.cs).  The stores
//     overlap the next pass's products.
//
// The nibble expansion (EXPAND kNibble, w=8 only): the same product against
//   the (p*8, k*32) one-hot-nibble operator.  Its depth is 4x the bit
//   planes' (320 against 80 at k=10), so the tensor cores bound it first:
//   2 * 32 * 320 int8 operations a column, 0.069 ms at the main path's
//   shape at the card's dense int8 rate.  Design:
//   * Plane words from PRMT tables.  In the transposed word r (byte q:
//     symbol 4c + q of one column) the low 16 bits are the nibbles lo0,
//     hi0, lo1, hi1 of symbols 4c and 4c + 1.  PTX prmt.b32 takes those 4
//     nibbles as its selector: byte n of the result is byte (nibble n & 7)
//     of the 8-byte table {x, y}, and where the nibble's bit 3 is set, that
//     byte's bit 7 replicated.  The table of plane v has one nonzero byte,
//     at v & 7: 0x01 for v < 8, so the result is 1 for nibble v and 0 for
//     every other; 0x80 for v >= 8, so it is 0xFF (odd) for nibble v, 0x80
//     (even) for nibble v - 8 and 0 else.  Under the operator scaled by
//     2^s (u8 x u8) an even plane byte adds only above bit s: bit s of the
//     accumulator is still output bit s.  One PRMT makes plane v of both
//     nibbles of two symbols; the same on r >> 16 of the other two.
//   * Depth order.  A four-symbol block of rows is 4 chunks; chunk
//     c = 4b + 2h' + e covers symbols 4b + 2h', 4b + 2h' + 1 (h' = 0: the
//     low half of r, 1: r >> 16) and plane v = 8e + 4h + t at depth
//     16h + 4t + q (q: lo, hi of the first symbol, lo, hi of the second).
//     So lane t's tables are 1 << 8t (e = 0) and 0x80 << 8t (e = 1), in x
//     for h = 0 and in y for h = 1: 8 PRMT and one shift make a column's 8
//     plane registers of a block.  The host packs the operator in that
//     order (cuda_planes.nibble_operator) with k rounded up to pairs, so a
//     last block of 1 or 2 symbols runs 2 chunks, not 4.
//   * Shared memory.  The operator takes 512 bytes a (16-row m-tile,
//     chunk), one chunk a symbol: 4x the byte expansions'.  Staged in
//     shared memory it ran about 10 % faster at the main path's shape (k=10,
//     p=4) than read through L1 (PERF.md, section 6), so the folded kernels
//     stage it where it and one step buffer a warp fit (p=16: k <= 52), and
//     past that read its fragments through L1 (kOpL1), shared memory
//     holding the ring alone: k <= 908 at any p.
//   * One chunk loop (nibble_chunks) walks the blocks and chunks for every
//     kernel and hands each chunk's table and selectors (NibbleChunk) to
//     the kernel's mma, which makes each plane word just before its use.
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
// gf_planes_sum_kernel, gf_planes_dot_kernel, gf_planes_none_kernel
constexpr int kSumWarps = 4;
constexpr int kSumThreads = kSumWarps * 32;
constexpr int kSumGroups = 8;                  // mma column groups a warp step
constexpr int kSumStepCols = 8 * kSumGroups;   // columns a warp step
constexpr int kSumStages = 3;                  // step buffers a warp, at most
// gf_planes_none_kernel's staging: a warp's 32 rows (two m-tiles) of 64
// int32 sums, a row 72 int32 (288 bytes) apart.
constexpr int kNoneRows = 32;
constexpr int kNoneStride = 72;
// W=4: the sum and none kernels run the operator's last m-tile alone where
// p*4 rows leave it unpaired (p=4: one m-tile).  false: every pass covers
// a pair of m-tiles, the padding's products included.  (A like half pass
// of the dot kernel, its first 2 n-tiles alone, ran 1-1.5 % slower than
// the whole pass at k=10, p=4 on an H100 (PERF.md, section 6), so the dot
// kernel runs whole passes.)
constexpr bool kW4Single = true;

enum Expand { kShift = 0, kShiftRaw = 1, kCmp = 2, kSign = 3, kNibble = 4 };
enum Refold { kSum = 0, kDot = 1, kNone = 2 };
// Where a launch of the sum, dot and none kernels reads its operator and
// data: both staged in shared memory; the operator through L1 beside the
// ring; both through L1 from device memory.
enum Src { kStaged = 0, kOpL1 = 1, kDirect = 2 };

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Words x0..x3 (rows 0-3, 4 columns each) -> r0..r3 (columns 0-3, byte q
// from row q).
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t* r) {
  const uint32_t a = __byte_perm(x0, x1, 0x5140);
  const uint32_t b = __byte_perm(x2, x3, 0x5140);
  const uint32_t c = __byte_perm(x0, x1, 0x7362);
  const uint32_t d = __byte_perm(x2, x3, 0x7362);
  r[0] = __byte_perm(a, b, 0x5410);
  r[1] = __byte_perm(a, b, 0x7632);
  r[2] = __byte_perm(c, d, 0x5410);
  r[3] = __byte_perm(c, d, 0x7632);
}

// Byte-symbols of n W-bit symbols: the sum, dot and none kernels take a
// 16-bit symbol as two bytes, low then high (a 4-bit symbol is one byte).
__host__ __device__ inline int byte_syms(int n, int w) { return w == 16 ? 2 * n : n; }

// Bytes a symbol takes in memory: one at w=4 and 8, two at w=16.
__host__ __device__ constexpr int sym_bytes(int w) { return w == 16 ? 2 : 1; }

// Rows of a step buffer: whole chunks of symbol rows (8 at w=4, 4 at w=8,
// 2 at w=16).
__host__ __device__ inline int ring_rows(int k, int w) {
  return w == 16 ? (k + 1) / 2 * 2 : w == 4 ? (k + 7) / 8 * 8 : (k + 3) / 4 * 4;
}

// The bytes past the row's end are zero: the ragged edge, or rows that do
// not start aligned.  `len` (8 or 16) bytes of the row from byte `off`.
__device__ __noinline__ uint4 row_edge(const uint8_t* row, long long nbytes,
                                       long long off, int len) {
  unsigned long long lo = 0, hi = 0;
  for (int b = 0; b < len && off + b < nbytes; ++b) {
    const unsigned long long v = row[off + b];
    if (b < 8) {
      lo |= v << (8 * b);
    } else {
      hi |= v << (8 * (b - 8));
    }
  }
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
}

// One lane's view of a warp step's rows: its bytes of the step buffer in
// shared memory (s: row 0), or for kDirect its 8 columns straight from
// device memory (row r of B from column col; zero past k and past m).
template <int W, int SRC>
struct StepRows {
  const uint8_t* s;
  const uint8_t* B;
  long long m, col;
  int k;
  bool vec;  // kDirect: rows start aligned for one 8-byte (W=4, 8) or 16-byte (W=16) load
};

// Row r's 8 bytes at W=4 and 8 (8 columns, a symbol a byte).
template <int W, int SRC>
__device__ __forceinline__ uint2 row8(const StepRows<W, SRC>& rows, int r) {
  static_assert(W != 16, "w=16 reads 16 bytes a row");
  if (SRC != kDirect) return *reinterpret_cast<const uint2*>(rows.s + r * kSumStepCols);
  if (r >= rows.k) return make_uint2(0u, 0u);
  const uint8_t* row = rows.B + (size_t)r * rows.m;
  if (rows.vec && rows.col + 8 <= rows.m) return __ldg(reinterpret_cast<const uint2*>(row + rows.col));
  const uint4 v = row_edge(row, rows.m, rows.col, 8);
  return make_uint2(v.x, v.y);
}

// Row r's 16 bytes at W=16 (8 columns: lo, hi of each).
template <int SRC>
__device__ __forceinline__ uint4 row16(const StepRows<16, SRC>& rows, int r) {
  if (SRC != kDirect) return *reinterpret_cast<const uint4*>(rows.s + r * 2 * kSumStepCols);
  if (r >= rows.k) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* row = rows.B + (size_t)r * rows.m * 2;
  if (rows.vec && rows.col + 8 <= rows.m) return __ldg(reinterpret_cast<const uint4*>(row + 2 * rows.col));
  return row_edge(row, 2 * rows.m, 2 * rows.col, 16);
}

// The transposed words of word chunk c of one warp step: r[j] is column
// 8g + j, byte q byte-symbol 4c + q.  W=4 and 8: rows 4c..4c+3, 4 LDS.64 and
// 8 PRMT (two transposes).  W=16: rows 2c and 2c + 1, 2 LDS.128 and 8 PRMT
// that split each column's low and high bytes: lo(2c), hi(2c), lo(2c + 1),
// hi(2c + 1).
template <int W, int SRC>
__device__ __forceinline__ void step_words(const StepRows<W, SRC>& rows, int c, uint32_t (&r)[kSumGroups]) {
  if constexpr (W == 16) {
    const uint4 x = row16(rows, 2 * c), y = row16(rows, 2 * c + 1);
    r[0] = __byte_perm(x.x, y.x, 0x5410);
    r[1] = __byte_perm(x.x, y.x, 0x7632);
    r[2] = __byte_perm(x.y, y.y, 0x5410);
    r[3] = __byte_perm(x.y, y.y, 0x7632);
    r[4] = __byte_perm(x.z, y.z, 0x5410);
    r[5] = __byte_perm(x.z, y.z, 0x7632);
    r[6] = __byte_perm(x.w, y.w, 0x5410);
    r[7] = __byte_perm(x.w, y.w, 0x7632);
  } else {
    uint2 x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = row8(rows, 4 * c + q);
    transpose4(x[0].x, x[1].x, x[2].x, x[3].x, r);
    transpose4(x[0].y, x[1].y, x[2].y, x[3].y, r + 4);
  }
}

// PTX prmt.b32 in its default mode: byte n of the result is byte
// sel[4n+2:4n] of {y, x} (x: bytes 0-3), or, where sel bit 4n+3 is set,
// bit 7 of that byte replicated over the byte (sel[31:16] is not read).
// __byte_perm is documented with 3-bit selectors only, so the nibble
// tables ask for the instruction itself.
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(y), "r"(sel));
  return d;
}

// Fragment i of the operator: from shared memory, or through L1 from
// device memory.
template <bool OP_SMEM>
__device__ __forceinline__ uint4 op_frag(const uint4* op_s, const uint4* __restrict__ op_g, int i) {
  return OP_SMEM ? op_s[i] : __ldg(op_g + i);
}

// One nibble chunk of a warp step: lane t's table for it and the selector
// word of each column group j (r[j] or r[j] >> 16).  lo(j) (table in x)
// is plane 8e + t of the group's column 8g + j, hi(j) (table in y) plane
// 8e + 4 + t.
struct NibbleChunk {
  uint32_t tab;
  uint32_t sel[kSumGroups];
  __device__ __forceinline__ uint32_t lo(int j) const { return prmt(tab, 0u, sel[j]); }
  __device__ __forceinline__ uint32_t hi(int j) const { return prmt(0u, tab, sel[j]); }
};

// The nibble's chunk loop over one warp step's rows: per four-symbol block
// the transposed words r, then its chunks c = 4b + 2h' + e (2 for a last
// block of 1 or 2 symbols, else 4), with table e (e1, e8) on r (h' = 0) or
// r >> 16 (h' = 1).  mma(c, chunk) issues the chunk's products.
template <int SRC, typename Mma>
__device__ __forceinline__ void nibble_chunks(const StepRows<8, SRC>& rows, int k, uint32_t e1, uint32_t e8,
                                              Mma&& mma) {
  for (int b = 0; 4 * b < k; ++b) {
    uint32_t r[kSumGroups];
    step_words(rows, b, r);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (h2 == 1 && 4 * b + 2 >= k) break;  // a last block of 1 or 2 symbols
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        NibbleChunk chunk;
        chunk.tab = e ? e8 : e1;
#pragma unroll
        for (int j = 0; j < kSumGroups; ++j) chunk.sel[j] = h2 ? r[j] >> 16 : r[j];
        mma(4 * b + 2 * h2 + e, chunk);
      }
    }
  }
}

// Plane s of the 4 symbols in word r, one per byte.  `bit` is
// 0x01010101 << s.  EXACT (the pre-parity form): JAX's values, shift_raw's
// int8(b >> s) without the next byte's bits; at W=16 (r: lo(2c), hi(2c),
// lo(2c + 1), hi(2c + 1)) a low byte's plane is the low byte of the whole
// 16-bit b >> s, so it keeps its high byte's bits and only a high byte's
// plane is masked.
template <int EXPAND, bool EXACT, int W = 8>
__device__ __forceinline__ uint32_t plane_word(uint32_t r, int s,
                                               uint32_t bit) {
  if (EXPAND == kShiftRaw) {  // folded: bits from the next byte land at 2^1 and up
    if (EXACT && W == 16) return (r >> s) & (0x00FF00FFu | ((0xFFu >> s) * 0x01000100u));
    return EXACT ? (r >> s) & ((0xFFu >> s) * 0x01010101u) : r >> s;
  }
  if (EXPAND == kCmp) return __vcmpne4(r & bit, 0u) & 0x01010101u;
  if (EXPAND == kSign) return __vcmpne4(r & bit, 0u);  // 0 or 0xFF (-1)
  return (r >> s) & 0x01010101u;
}

// Start copying the rows < k of one warp step (kSumStepCols columns, P
// 16-byte pieces a row) into `buf`.  Lane L copies piece L % P of rows
// L / P + (32 / P) i, so that its piece i lands at 16 L + 512 i; `src`
// points at its piece of row L / P and `rows_stride` is the stride of
// 32 / P rows.  In a ragged last step cp.async fills the bytes past the
// row's end with zeros.
template <int P>
__device__ __forceinline__ void sum_fetch(uint8_t* buf, const uint8_t* src,
                                          long long rows_stride, long long left,
                                          int k, int lane) {
  const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf) + lane * 16;
  for (int row = lane / P, i = 0; row < k; row += 32 / P, ++i) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
        " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(
            dst + 512 * i),
        "l"(src), "r"(bytes), "r"(bytes));
    src += rows_stride;
  }
}

// The same for rows that do not start 16-byte aligned: byte by byte, zero
// past the row's `row_bytes`; the step's bytes `off`.. of each row, `step`
// a row.
__device__ __noinline__ void sum_fetch_bytes(uint8_t* buf,
                                             const uint8_t* __restrict__ B,
                                             int k, long long row_bytes,
                                             long long off, int step, int lane) {
  for (int idx = lane; idx < k * step; idx += 32) {
    const int row = idx / step, b = idx % step;
    buf[idx] = off + b < row_bytes ? B[(size_t)row * row_bytes + off + b] : 0;
  }
}

// Store the first `left` (if below 8) of 8 output bytes, byte by byte: the
// ragged edge, or rows that do not start 8-byte aligned.
__device__ __noinline__ void sum_store_edge(uint8_t* dst, long long left,
                                            uint32_t lo, uint32_t hi) {
  for (int j = 0; j < 8 && j < left; ++j) {
    dst[j] = (uint8_t)((j < 4 ? lo : hi) >> (8 * (j & 3)));
  }
}

// The same for 8 16-bit outputs (the words hold 2 each).
__device__ __noinline__ void sum_store_edge16(uint16_t* dst, long long left,
                                              uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < 8 && j < left; ++j) dst[j] = (uint16_t)(w[j >> 1] >> (16 * (j & 1)));
}

// m-tiles of the sum, dot and none kernels' operator (p W-bit symbols,
// p*w rows): rounded up to pairs.
__host__ __device__ inline int sum_mtiles(int p, int w) {
  return ((p * w + 15) / 16 + 1) & ~1;
}

// 32-deep operator chunks of the sum, dot and none kernels (k
// byte-symbols): one per 4 symbols for the byte expansions, one per symbol
// for nibble, with k rounded up to pairs.
__host__ __device__ inline int sum_chunks(int k, int expand) {
  return expand == kNibble ? (k + 1) / 2 * 2 : (k + 3) / 4;
}

// The same for k W-bit symbols: at w=4 one chunk per 8 symbols (their 4
// planes each), else sum_chunks of the byte-symbols.
__host__ __device__ inline int op_chunks(int k, int w, int expand) {
  return w == 4 ? (k + 7) / 8 : sum_chunks(byte_syms(k, w), expand);
}

// One warp's ring of step buffers (the sum, dot and none kernels): step n
// of the warp covers the block's columns first + n * stride ..+63 and is
// copied into buffer n % stages, up to stages - 1 steps ahead of the
// compute.  Under kDirect nothing is copied: rows() points the step at
// device memory.
template <int W>
struct StepRing {
  static constexpr int kSym = sym_bytes(W);                // bytes a symbol
  static constexpr int kRowBytes = kSumStepCols * kSym;    // a step's bytes of one row
  static constexpr int kPieces = kRowBytes / 16;          // 16-byte pieces of them
  uint8_t* bufs;
  int buf_bytes, stages, nsteps, first, stride, k, lane;
  const uint8_t* B;
  const uint8_t* lane_src;
  long long m, row_bytes, rd0, rows_stride;
  bool vec_in, vec_direct;
  int f_step, f_buf, c_buf;

  __device__ StepRing(uint8_t* smem_bufs, const uint8_t* B_, int k_, long long m_,
                      long long blk0, int span, int pinned, int stages_, int warp,
                      int lane_)
      : bufs(smem_bufs), buf_bytes(ring_rows(k_, W) * kRowBytes), stages(stages_),
        first(warp * kSumStepCols), stride(kSumWarps * kSumStepCols), k(k_), lane(lane_),
        B(B_), m(m_), row_bytes(m_ * kSym), rd0(pinned ? 0 : blk0),
        rows_stride((32 / kPieces) * m_ * kSym),
        vec_in(((uintptr_t)B_ & 15) == 0 && ((m_ * kSym) & 15) == 0),
        vec_direct(((uintptr_t)B_ & (8 * kSym - 1)) == 0 && (m_ & 7) == 0), f_step(0), f_buf(0),
        c_buf(0) {
    bufs += warp * stages * buf_bytes;
    nsteps = first < span ? (span - first + stride - 1) / stride : 0;
    lane_src = B + (size_t)(lane / kPieces) * row_bytes + rd0 * kSym + 16 * (lane % kPieces);
  }

  // Start copying the next step (an empty commit group past the last).
  __device__ __forceinline__ void fetch_next() {
    if (f_step < nsteps) {
      const int col = first + f_step * stride;
      uint8_t* buf = bufs + f_buf * buf_bytes;
      if (vec_in) {
        sum_fetch<kPieces>(buf, lane_src + (long long)col * kSym, rows_stride,
                           row_bytes - (rd0 + col) * kSym - 16 * (lane % kPieces), k, lane);
      } else {
        sum_fetch_bytes(buf, B, k, row_bytes, (rd0 + col) * kSym, kRowBytes, lane);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    ++f_step;
    f_buf = f_buf + 1 == stages ? 0 : f_buf + 1;
  }

  // Wait for the next step's copies (the oldest group still pending but
  // the stages - 1 behind it), make them visible to the warp and return
  // its buffer.  The caller ends the step with __syncwarp() before the
  // next fetch_next() refills that buffer.
  __device__ __forceinline__ const uint8_t* wait() {
    if (stages == 3) {
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else if (stages == 2) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
    const uint8_t* buf = bufs + c_buf * buf_bytes;
    c_buf = c_buf + 1 == stages ? 0 : c_buf + 1;
    return buf;
  }

  // Start the first stages - 1 steps' copies.
  template <int SRC>
  __device__ __forceinline__ void start() {
    if (SRC != kDirect) {
      for (int n = 0; n < stages - 1; ++n) fetch_next();
    }
  }

  // Step n's rows as lane (g, t) reads them, its copies waited for.
  template <int SRC>
  __device__ __forceinline__ StepRows<W, SRC> rows(int n, int g) {
    StepRows<W, SRC> out;
    if (SRC != kDirect) {
      fetch_next();
      out.s = wait() + g * 8 * kSym;
    } else {
      out.B = B;
      out.m = m;
      out.col = rd0 + first + (long long)n * stride + 8 * g;
      out.k = k;
      out.vec = vec_direct;
    }
    return out;
  }
};

// The plane registers of operator chunk c of one warp step: b0 (depths
// 4t..4t+3) and b1 (16 + 4t..) of each column group j.  W=8 and 16: the
// words of word chunk c, planes t and 4 + t of byte-symbols 4c..4c+3.
// W=4: plane t of the words of word chunks 2c (symbols 8c..8c+3) and
// 2c + 1 (8c + 4..8c + 7), the latter zero where it starts past k.
template <int W, int EXPAND, int SRC, bool EXACT>
__device__ __forceinline__ void chunk_planes(const StepRows<W, SRC>& rows, int c, int k, int t,
                                             uint32_t (&b0)[kSumGroups], uint32_t (&b1)[kSumGroups]) {
  uint32_t r[kSumGroups];
  if constexpr (W == 4) {
    const uint32_t bit = 0x01010101u << t;
    step_words(rows, 2 * c, r);
#pragma unroll
    for (int j = 0; j < kSumGroups; ++j) b0[j] = plane_word<EXPAND, EXACT>(r[j], t, bit);
    if (8 * c + 4 < k) {
      step_words(rows, 2 * c + 1, r);
#pragma unroll
      for (int j = 0; j < kSumGroups; ++j) b1[j] = plane_word<EXPAND, EXACT>(r[j], t, bit);
    } else {
#pragma unroll
      for (int j = 0; j < kSumGroups; ++j) b1[j] = 0u;
    }
  } else {
    const uint32_t bit0 = 0x01010101u << t, bit1 = 0x01010101u << (t + 4);
    step_words(rows, c, r);
#pragma unroll
    for (int j = 0; j < kSumGroups; ++j) {
      b0[j] = plane_word<EXPAND, EXACT, W>(r[j], t, bit0);
      b1[j] = plane_word<EXPAND, EXACT, W>(r[j], t + 4, bit1);
    }
  }
}

// The first product of the sum and none kernels over one warp step: m-tiles
// mg and mg + 1 (NT = 2) or mg alone (NT = 1) of the operator times every
// chunk of the step's planes (kc chunks, k symbols), into acc.  EXACT (the
// none kernel): JAX's plane values against the unscaled operator.
template <int W, int EXPAND, int SRC, bool EXACT, int NT = 2>
__device__ __forceinline__ void sum_pass(int (&acc)[2][kSumGroups][4], const StepRows<W, SRC>& rows,
                                         const uint4* op_s, const uint4* __restrict__ opA, int mg, int kc,
                                         int k, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < kSumGroups; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][j][r] = 0;
  if constexpr (EXPAND == kNibble) {
    // Lane t's PRMT tables, planes t, 4 + t (e1) and 8 + t, 12 + t (e8).
    const uint32_t e1 = 1u << (8 * t), e8 = 0x80u << (8 * t);
    nibble_chunks(rows, k, e1, e8, [&](int c, const NibbleChunk& chunk) {
      const uint4 a0 = op_frag<SRC == kStaged>(op_s, opA, (mg * kc + c) * 32 + lane);
      const uint4 a1 = op_frag<SRC == kStaged>(op_s, opA, ((mg + 1) * kc + c) * 32 + lane);
      // EXACT: e8's 0xFF and 0x80 (chunks c = 4b + 2h' + 1) to 1 and 0.
      const uint32_t keep = EXACT && (c & 1) ? 0x01010101u : 0xFFFFFFFFu;
#pragma unroll
      for (int j = 0; j < kSumGroups; ++j) {
        const uint32_t b0 = chunk.lo(j) & keep, b1 = chunk.hi(j) & keep;
        mma_u8(acc[0][j], a0, b0, b1);
        mma_u8(acc[1][j], a1, b0, b1);
      }
    });
  } else {
    constexpr bool kSigned = EXPAND == kSign || (EXACT && EXPAND == kShiftRaw);
    for (int c = 0; c < kc; ++c) {
      uint32_t b0[kSumGroups], b1[kSumGroups];
      chunk_planes<W, EXPAND, SRC, EXACT>(rows, c, k, t, b0, b1);
      const uint4 a0 = op_frag<SRC == kStaged>(op_s, opA, (mg * kc + c) * 32 + lane);
      uint4 a1 = a0;
      if constexpr (NT == 2) a1 = op_frag<SRC == kStaged>(op_s, opA, ((mg + 1) * kc + c) * 32 + lane);
#pragma unroll
      for (int j = 0; j < kSumGroups; ++j) {
        if (kSigned) {
          mma_u8s8(acc[0][j], a0, b0[j], b1[j]);
          if constexpr (NT == 2) mma_u8s8(acc[1][j], a1, b0[j], b1[j]);
        } else {
          mma_u8(acc[0][j], a0, b0[j], b1[j]);
          if constexpr (NT == 2) mma_u8(acc[1][j], a1, b0[j], b1[j]);
        }
      }
    }
  }
}

// Whether the pass over m-tiles mg, mg + 1 covers both (else mg alone):
// at W=4 (kW4Single) the last of an odd count of the operator's p*4 rows'
// m-tiles runs alone.
template <int W>
__device__ __forceinline__ bool pass_pair(int mg, int p) {
  return W != 4 || !kW4Single || mg + 1 < (p * W + 15) / 16;
}

// Stage the operator's fragments in shared memory (kStaged).
template <int SRC>
__device__ __forceinline__ int stage_operator(uint4* smem, const uint4* __restrict__ op, int n) {
  const int na = SRC == kStaged ? n : 0;
  for (int i = threadIdx.x; i < na; i += kSumThreads) smem[i] = op[i];
  __syncthreads();
  return na;
}

// C: (p, m) uint8 at W=4 and 8, uint16 at W=16; k and p count W-bit symbols.
template <int W, int EXPAND, int SRC>
__global__ void __launch_bounds__(kSumThreads)
    gf_planes_sum_kernel(const uint4* __restrict__ opA,
                         const uint8_t* __restrict__ B,
                         void* __restrict__ Cv, int k, int p, long long m,
                         int tile, int pinned, int stages) {
  static_assert(W == 8 || ((W == 16 || W == 4) && EXPAND != kNibble && EXPAND != kCmp),
                "w=16: shift, shift_raw, sign; w=4: shift, shift_raw");
  static_assert(W != 4 || EXPAND != kSign, "w=4: shift, shift_raw");
  static_assert(SRC != kOpL1 || EXPAND == kNibble, "only nibble reads its operator through L1 beside the ring");
  static_assert(SRC != kDirect || W != 8, "w=8's folded forms stage their rows");
  extern __shared__ uint4 smem[];
  const int mtn = sum_mtiles(p, W);
  const int kc = op_chunks(k, W, EXPAND);
  const int na = stage_operator<SRC>(smem, opA, mtn * kc * 32);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec_out = ((uintptr_t)Cv & (W == 16 ? 15 : 7)) == 0 && (m & 7) == 0;

  // Column offsets within the block are 32-bit; the block's first write
  // and read columns are the only 64-bit ones.
  const long long blk0 = (long long)blockIdx.x * tile;
  const int span = (int)(min(m, blk0 + tile) - blk0);
  StepRing<W> ring(reinterpret_cast<uint8_t*>(smem + na), B, k, m, blk0, span, pinned, stages, warp, lane);
  ring.template start<SRC>();

  // Row g of an m-tile is output bit g (W=8, 16) or g & 3 (W=4: 4 symbols
  // of 4 bits a tile).
  const uint32_t keep = 0x01010101u << (W == 4 ? (g & 3) : g);
  // W=8: this lane's output bytes of a step, symbol 2mt + g / 2, columns
  // 16t + 8(g & 1) .. + 7.  W=4: every lane, symbol 4mt + g / 4 +
  // 2((g / 2) & 1), the same columns.  W=16: lanes g < 2, symbol mt,
  // columns 16t + 8g .. + 7 (low bytes of w[j] at byte g, high at 2 + g).
  const uint32_t pick = (uint32_t)(g & 3) | ((uint32_t)((g & 3) + 4) << 4);
  const uint32_t pick16 = 0x6420u + 0x1111u * (uint32_t)(g & 1);
  const int c_off = W == 16 ? 16 * t + 8 * g : 16 * t + 8 * (g & 1);
  for (int n = 0; n < ring.nsteps; ++n) {
    const StepRows<W, SRC> rows = ring.template rows<SRC>(n, g);
    const long long col0 = blk0 + ring.first + n * ring.stride;
    const bool full = vec_out && col0 + kSumStepCols <= m;
    for (int mg = 0; mg < mtn; mg += 2) {
      int acc[2][kSumGroups][4];
      const bool pair = pass_pair<W>(mg, p);
      if (pair) {
        sum_pass<W, EXPAND, SRC, false>(acc, rows, smem, opA, mg, kc, k, lane);
      } else {
        sum_pass<W, EXPAND, SRC, false, W == 4 ? 1 : 2>(acc, rows, smem, opA, mg, kc, k, lane);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !pair) break;
        uint32_t w[kSumGroups];
#pragma unroll
        for (int j = 0; j < kSumGroups; ++j) {
          const uint32_t lo = __byte_perm((uint32_t)acc[u][j][0], (uint32_t)acc[u][j][1], 0x0040);
          const uint32_t hi = __byte_perm((uint32_t)acc[u][j][2], (uint32_t)acc[u][j][3], 0x4000);
          uint32_t v = __byte_perm(lo, hi, 0x7610) & keep;
          v |= __shfl_xor_sync(0xffffffffu, v, 4);
          v |= __shfl_xor_sync(0xffffffffu, v, 8);
          if (W != 4) v |= __shfl_xor_sync(0xffffffffu, v, 16);  // W=4: g ^ 1, g ^ 2 hold a symbol's 4 bits
          w[j] = v;
        }
        // Byte b of w[j]: byte-symbol 2mt + b / 2 (W=4: symbol 4mt + g / 4
        // + 2(b / 2)) at column 16t + 8(b & 1) + j.
        if constexpr (W == 16) {
          const int sym = mg + u;  // byte-symbols 2mt, 2mt + 1: its low and high bytes
          if (g < 2 && sym < p) {
            const uint4 v = make_uint4(__byte_perm(w[0], w[1], pick16), __byte_perm(w[2], w[3], pick16),
                                       __byte_perm(w[4], w[5], pick16), __byte_perm(w[6], w[7], pick16));
            uint16_t* dst = static_cast<uint16_t*>(Cv) + (size_t)sym * m + col0 + c_off;
            if (full) {
              *reinterpret_cast<uint4*>(dst) = v;
            } else {
              sum_store_edge16(dst, m - (col0 + c_off), v);
            }
          }
        } else {
          const int sym = W == 4 ? 4 * (mg + u) + (g >> 2) + 2 * ((g >> 1) & 1) : 2 * (mg + u) + (g >> 1);
          if ((W == 4 || g < 4) && sym < p) {
            const uint32_t lo = __byte_perm(__byte_perm(w[0], w[1], pick), __byte_perm(w[2], w[3], pick), 0x5410);
            const uint32_t hi = __byte_perm(__byte_perm(w[4], w[5], pick), __byte_perm(w[6], w[7], pick), 0x5410);
            uint8_t* dst = static_cast<uint8_t*>(Cv) + (size_t)sym * m + col0 + c_off;
            if (full) {
              *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
            } else {
              sum_store_edge(dst, m - (col0 + c_off), lo, hi);
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// The low bytes of a, b, c and d as bytes 0-3 of one word: 3 PRMT.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x4000), 0x7610);
}

// The dot kernel's first product at W=4 over one pass: its 4 n-tiles of
// every chunk, into acc.  A register a of m-block mb holds plane t of rows
// 8c..8c+3 (a.x: column 8g + mb, a.y: 8g + 4 + mb) and of rows
// 8c + 4..8c + 7 (a.z, a.w), zero past k.
template <int EXPAND, int SRC>
__device__ __forceinline__ void dot_pass4(int (&acc)[4][4][4], const StepRows<4, SRC>& rows, const uint4* op_s,
                                          const uint4* __restrict__ opB, int pass, int kc, int k, int lane) {
  const int t = lane & 3;
  const uint32_t bit = 0x01010101u << t;
  for (int c = 0; c < kc; ++c) {
    uint32_t lo[kSumGroups], hi[kSumGroups];
    step_words(rows, 2 * c, lo);
    if (8 * c + 4 < k) {
      step_words(rows, 2 * c + 1, hi);
    } else {
#pragma unroll
      for (int j = 0; j < kSumGroups; ++j) hi[j] = 0u;  // a zero word's planes are zero
    }
    const uint4 b01 = op_frag<SRC == kStaged>(op_s, opB, ((2 * pass) * kc + c) * 32 + lane);
    const uint4 b23 = op_frag<SRC == kStaged>(op_s, opB, ((2 * pass + 1) * kc + c) * 32 + lane);
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
      const uint4 a = make_uint4(plane_word<EXPAND, false>(lo[mb], t, bit), plane_word<EXPAND, false>(lo[4 + mb], t, bit),
                                 plane_word<EXPAND, false>(hi[mb], t, bit), plane_word<EXPAND, false>(hi[4 + mb], t, bit));
      mma_u8(acc[mb][0], a, b01.x, b01.y);
      mma_u8(acc[mb][1], a, b01.z, b01.w);
      mma_u8(acc[mb][2], a, b23.x, b23.y);
      mma_u8(acc[mb][3], a, b23.z, b23.w);
    }
  }
}

// opB: the scaled operator as B fragments, (16 * mtn rows / 16, kc, 32
// lanes) uint4, two 8-row n-tiles each (x, y: rows g; z, w: rows 8 + g);
// opF: F's B fragments for the passes of an 8-symbol tile, (2, 32) uint2
// (W=4: one pass a tile, (1, 32)).  Everything else as
// gf_planes_sum_kernel.
template <int W, int EXPAND, int SRC>
__global__ void __launch_bounds__(kSumThreads)
    gf_planes_dot_kernel(const uint4* __restrict__ opB,
                         const uint2* __restrict__ opF,
                         const uint8_t* __restrict__ B,
                         void* __restrict__ Cv, int k, int p, long long m,
                         int tile, int pinned, int stages) {
  static_assert(W == 8 || ((W == 16 || W == 4) && EXPAND != kNibble && EXPAND != kCmp),
                "w=16: shift, shift_raw, sign; w=4: shift, shift_raw");
  static_assert(W != 4 || EXPAND != kSign, "w=4: shift, shift_raw");
  static_assert(SRC != kOpL1 || EXPAND == kNibble, "only nibble reads its operator through L1 beside the ring");
  static_assert(SRC != kDirect || W != 8, "w=8's folded forms stage their rows");
  extern __shared__ uint4 smem[];
  // 32 operator rows a pass: 4 byte-symbols (W=8, 16) or 8 symbols (W=4);
  // an 8-symbol output tile is kTilePasses passes.
  constexpr int kTilePasses = W == 4 ? 1 : 2;
  const int npass = sum_mtiles(p, W) / 2;
  const int kc = op_chunks(k, W, EXPAND);
  const int nb = stage_operator<SRC>(smem, opB, 2 * npass * kc * 32);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint2 f0 = opF[lane], f1 = kTilePasses == 2 ? opF[32 + lane] : f0;
  const bool vec_out = ((uintptr_t)Cv & (W == 16 ? 15 : 7)) == 0 && (m & 7) == 0;

  const long long blk0 = (long long)blockIdx.x * tile;
  const int span = (int)(min(m, blk0 + tile) - blk0);
  StepRing<W> ring(reinterpret_cast<uint8_t*>(smem + nb), B, k, m, blk0, span, pinned, stages, warp, lane);
  ring.template start<SRC>();

  const int sh0 = t, sh1 = t + 4;
  const uint32_t bit0 = 0x01010101u << sh0, bit1 = 0x01010101u << sh1;
  const uint32_t e1 = 1u << (8 * t), e8 = 0x80u << (8 * t);  // nibble's tables
  // Byte e of a second-product A register is output bit 2t + (e & 1), at
  // W=4 bit 2(t & 1) + (e & 1) of symbol t / 2 of its n-tile.
  const uint32_t keep = 0x02010201u << (2 * (W == 4 ? t & 1 : t));
  for (int n = 0; n < ring.nsteps; ++n) {
    const StepRows<W, SRC> rows = ring.template rows<SRC>(n, g);
    const long long col0 = blk0 + ring.first + n * ring.stride;
    const bool full = vec_out && col0 + kSumStepCols <= m;
    for (int f = 0; kTilePasses * f < npass; ++f) {
      int out[4][4];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int r = 0; r < 4; ++r) out[mb][r] = 0;
#pragma unroll
      for (int q = 0; q < kTilePasses; ++q) {
        const int pass = kTilePasses * f + q;
        if (pass >= npass) break;
        int acc[4][4][4];
#pragma unroll
        for (int mb = 0; mb < 4; ++mb)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mb][nt][r] = 0;
        if constexpr (EXPAND == kNibble) {
          nibble_chunks(rows, k, e1, e8, [&](int c, const NibbleChunk& chunk) {
            const uint4 b01 = op_frag<SRC == kStaged>(smem, opB, ((2 * pass) * kc + c) * 32 + lane);
            const uint4 b23 = op_frag<SRC == kStaged>(smem, opB, ((2 * pass + 1) * kc + c) * 32 + lane);
#pragma unroll
            for (int mb = 0; mb < 4; ++mb) {
              // Each plane register is made just before its 4 mma.
              const uint4 a = make_uint4(chunk.lo(mb), chunk.lo(4 + mb), chunk.hi(mb), chunk.hi(4 + mb));
              mma_u8(acc[mb][0], a, b01.x, b01.y);
              mma_u8(acc[mb][1], a, b01.z, b01.w);
              mma_u8(acc[mb][2], a, b23.x, b23.y);
              mma_u8(acc[mb][3], a, b23.z, b23.w);
            }
          });
        } else if constexpr (W == 4) {
          dot_pass4<EXPAND, SRC>(acc, rows, smem, opB, pass, kc, k, lane);
        } else {
          for (int c = 0; c < kc; ++c) {
            uint32_t r[kSumGroups];
            step_words(rows, c, r);
            const uint4 b01 = op_frag<SRC == kStaged>(smem, opB, ((2 * pass) * kc + c) * 32 + lane);
            const uint4 b23 = op_frag<SRC == kStaged>(smem, opB, ((2 * pass + 1) * kc + c) * 32 + lane);
#pragma unroll
            for (int mb = 0; mb < 4; ++mb) {
              // Each plane register is made once, just before its 4 mma.
              const uint4 a = make_uint4(
                  plane_word<EXPAND, false>(r[mb], sh0, bit0), plane_word<EXPAND, false>(r[4 + mb], sh0, bit0),
                  plane_word<EXPAND, false>(r[mb], sh1, bit1), plane_word<EXPAND, false>(r[4 + mb], sh1, bit1));
              if (EXPAND == kSign) {
                mma_s8u8(acc[mb][0], a, b01.x, b01.y);
                mma_s8u8(acc[mb][1], a, b01.z, b01.w);
                mma_s8u8(acc[mb][2], a, b23.x, b23.y);
                mma_s8u8(acc[mb][3], a, b23.z, b23.w);
              } else {
                mma_u8(acc[mb][0], a, b01.x, b01.y);
                mma_u8(acc[mb][1], a, b01.z, b01.w);
                mma_u8(acc[mb][2], a, b23.x, b23.y);
                mma_u8(acc[mb][3], a, b23.z, b23.w);
              }
            }
          }
        }
        // acc[mb][nt]: regs 0, 1 column 8g + mb, regs 2, 3 column
        // 8g + 4 + mb; bits 2t (regs 0, 2) and 2t + 1 of byte-symbol
        // 4 pass + nt (W=4: bits 2(t & 1), 2(t & 1) + 1 of symbol
        // 8 pass + 2nt + t / 2).
        const uint2 fq = q == 0 ? f0 : f1;
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          const int(&a)[4][4] = acc[mb];
          const uint4 e = make_uint4(low_bytes(a[0][0], a[0][1], a[1][0], a[1][1]) & keep,
                                     low_bytes(a[0][2], a[0][3], a[1][2], a[1][3]) & keep,
                                     low_bytes(a[2][0], a[2][1], a[3][0], a[3][1]) & keep,
                                     low_bytes(a[2][2], a[2][3], a[3][2], a[3][3]) & keep);
          mma_u8(out[mb], e, fq.x, fq.y);
        }
      }
      // out[mb]: byte-symbols 8f + 2t (regs 0, 2) and 8f + 2t + 1 (regs 1,
      // 3) at columns 8g + mb (regs 0, 1) and 8g + 4 + mb (regs 2, 3); at
      // W=4 symbols, the same.
      if constexpr (W == 16) {
        // Those are the low and high bytes of symbol 4f + t.
        const int sym = 4 * f + t;
        if (sym < p) {
          const uint4 v = make_uint4(low_bytes(out[0][0], out[0][1], out[1][0], out[1][1]),
                                     low_bytes(out[2][0], out[2][1], out[3][0], out[3][1]),
                                     low_bytes(out[0][2], out[0][3], out[1][2], out[1][3]),
                                     low_bytes(out[2][2], out[2][3], out[3][2], out[3][3]));
          uint16_t* dst = static_cast<uint16_t*>(Cv) + (size_t)sym * m + col0 + 8 * g;
          if (full) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            sum_store_edge16(dst, m - (col0 + 8 * g), v);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sym = 8 * f + 2 * t + h;
          if (sym >= p) continue;
          const uint32_t lo = low_bytes(out[0][h], out[1][h], out[2][h], out[3][h]);
          const uint32_t hi = low_bytes(out[0][2 + h], out[1][2 + h], out[2][2 + h], out[3][2 + h]);
          uint8_t* dst = static_cast<uint8_t*>(Cv) + (size_t)sym * m + col0 + 8 * g;
          if (full) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
          } else {
            sum_store_edge(dst, m - (col0 + 8 * g), lo, hi);
          }
        }
      }
    }
    __syncwarp();
  }
}

// Store the first `left` (if below 4) of 4 int32 sums one by one: the
// ragged edge, or rows that do not start 16-byte aligned.
__device__ __noinline__ void none_store_edge(int* dst, long long left, int4 v) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < 4 && j < left; ++j) dst[j] = w[j];
}

// C: the (p*W, m) int32 sums (row i*W + s: bit s of symbol i; at W=16 the
// byte-symbols' rows i*16 + 8h + s' are that order too).  Shared memory:
// the operator (kStaged), each warp's staging rows, the ring (not kDirect).
template <int W, int EXPAND, int SRC>
__global__ void __launch_bounds__(kSumThreads)
    gf_planes_none_kernel(const uint4* __restrict__ opA,
                          const uint8_t* __restrict__ B,
                          int* __restrict__ C, int k, int p, long long m,
                          int tile, int pinned, int stages) {
  static_assert(W == 8 || ((W == 16 || W == 4) && EXPAND != kNibble && EXPAND != kCmp),
                "w=16: shift, shift_raw, sign; w=4: shift, shift_raw");
  static_assert(W != 4 || EXPAND != kSign, "w=4: shift, shift_raw");
  static_assert(SRC != kOpL1, "the pre-parity form stages its operator or reads everything through L1");
  extern __shared__ uint4 smem[];
  const int mtn = sum_mtiles(p, W);
  const int kc = op_chunks(k, W, EXPAND);
  const int na = stage_operator<SRC>(smem, opA, mtn * kc * 32);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec_out = ((uintptr_t)C & 15) == 0 && (m & 3) == 0;
  int* stage = reinterpret_cast<int*>(smem + na) + warp * kNoneRows * kNoneStride;
  uint8_t* ring_bufs = reinterpret_cast<uint8_t*>(smem + na) + kSumWarps * kNoneRows * kNoneStride * sizeof(int);

  const long long blk0 = (long long)blockIdx.x * tile;
  const int span = (int)(min(m, blk0 + tile) - blk0);
  StepRing<W> ring(ring_bufs, B, k, m, blk0, span, pinned, stages, warp, lane);
  ring.template start<SRC>();

  // Staging: 16-byte chunk c of a row at c ^ (c >> 3).  Lane (g, t) writes
  // chunks 4t..4t+3 of rows g and g + 8 of each m-tile (its columns
  // 16t..16t+15); lane L reads chunk L % 16 of rows L / 16 + 2i.
  int* st_w = stage + g * kNoneStride + 16 * t;
  const int sw = t >> 1;
  const int c_rd = lane & 15;
  const int* st_r = stage + (lane >> 4) * kNoneStride + 4 * (c_rd ^ (c_rd >> 3));
  for (int n = 0; n < ring.nsteps; ++n) {
    const StepRows<W, SRC> rows = ring.template rows<SRC>(n, g);
    const long long col0 = blk0 + ring.first + n * ring.stride;
    const bool full = vec_out && col0 + kSumStepCols <= m;
    for (int mg = 0; mg < mtn; mg += 2) {
      int acc[2][kSumGroups][4];
      const bool pair = pass_pair<W>(mg, p);
      if (pair) {
        sum_pass<W, EXPAND, SRC, true>(acc, rows, smem, opA, mg, kc, k, lane);
      } else {
        sum_pass<W, EXPAND, SRC, true, W == 4 ? 1 : 2>(acc, rows, smem, opA, mg, kc, k, lane);
      }
      // acc[u][j]: regs 0, 2 rows g, g + 8 of m-tile mg + u at column
      // 16t + j, regs 1, 3 at column 16t + 8 + j.  A single m-tile's pass
      // stages rows 0-15 alone (nrows <= 16 reads no more).
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (u == 1 && !pair) break;
          int* row = st_w + (16 * u + 8 * h) * kNoneStride;
          const int(&a)[kSumGroups][4] = acc[u];
          *reinterpret_cast<int4*>(row + 4 * (0 ^ sw)) = make_int4(a[0][2 * h], a[1][2 * h], a[2][2 * h], a[3][2 * h]);
          *reinterpret_cast<int4*>(row + 4 * (1 ^ sw)) = make_int4(a[4][2 * h], a[5][2 * h], a[6][2 * h], a[7][2 * h]);
          *reinterpret_cast<int4*>(row + 4 * (2 ^ sw)) =
              make_int4(a[0][2 * h + 1], a[1][2 * h + 1], a[2][2 * h + 1], a[3][2 * h + 1]);
          *reinterpret_cast<int4*>(row + 4 * (3 ^ sw)) =
              make_int4(a[4][2 * h + 1], a[5][2 * h + 1], a[6][2 * h + 1], a[7][2 * h + 1]);
        }
      __syncwarp();
      // Two whole 256-byte row segments a store; rows past p*W (the
      // operator's padding) are not written.
      const int nrows = min(kNoneRows, W * p - 16 * mg);
      const int* src = st_r;
      int* dst = C + (size_t)(16 * mg + (lane >> 4)) * m + col0 + 4 * c_rd;
      for (int r = lane >> 4; r < nrows; r += 2) {
        const int4 v = *reinterpret_cast<const int4*>(src);
        if (full) {
          __stcs(reinterpret_cast<int4*>(dst), v);
        } else {
          none_store_edge(dst, m - (col0 + 4 * c_rd), v);
        }
        src += 2 * kNoneStride;
        dst += 2 * m;
      }
      __syncwarp();
    }
  }
}

// Shared memory of a sum, dot or none kernel's launch (k, p in W-bit
// symbols): the operator (kStaged), the none kernel's staging rows and
// `stages` step buffers a warp (not kDirect).
inline size_t mma_smem(int k, int p, int w, int expand, int refold, int src, int stages) {
  const size_t op = (size_t)sum_mtiles(p, w) * op_chunks(k, w, expand) * 32 * sizeof(uint4);
  const size_t ring = (size_t)kSumWarps * stages * ring_rows(k, w) * kSumStepCols * sym_bytes(w);
  const size_t staging = refold == kNone ? (size_t)kSumWarps * kNoneRows * kNoneStride * sizeof(int) : 0;
  return (src == kStaged ? op : 0) + (src == kDirect ? 0 : ring) + staging;
}

struct Route {
  int src;     // Src, or -1: nothing fits
  int stages;  // step buffers a warp (0 under kDirect)
};

// The route of a launch: operator and ring in shared memory with the most
// step buffers (kSumStages down to 1) that fit; else, for nibble's folded
// forms, the operator through L1 beside the most that fit alone; else, at
// w=4 and 16 and for the pre-parity form, both through L1 from device
// memory.  Only w=8's folded byte expansions are refused past their edge.
inline Route mma_route(int k, int p, int w, int expand, int refold) {
  for (int stages = kSumStages; stages >= 1; --stages) {
    if (mma_smem(k, p, w, expand, refold, kStaged, stages) <= (size_t)kMaxSmem) return {kStaged, stages};
  }
  if (expand == kNibble && refold != kNone) {
    for (int stages = kSumStages; stages >= 1; --stages) {
      if (mma_smem(k, p, w, expand, refold, kOpL1, stages) <= (size_t)kMaxSmem) return {kOpL1, stages};
    }
  }
  if (w != 8 || refold == kNone) return {kDirect, 0};
  return {-1, 0};
}

template <int W, int EXPAND, int REFOLD, int SRC>
int launch_src(const void* opA, const void* opF, const void* B, void* C, int k, int p,
               long long m, int tile, int pinned, int stages, unsigned blocks,
               cudaStream_t stream) {
  const void* fn;
  if constexpr (REFOLD == kSum) {
    fn = (const void*)gf_planes_sum_kernel<W, EXPAND, SRC>;
  } else if constexpr (REFOLD == kDot) {
    fn = (const void*)gf_planes_dot_kernel<W, EXPAND, SRC>;
  } else {
    fn = (const void*)gf_planes_none_kernel<W, EXPAND, SRC>;
  }
  const size_t smem = mma_smem(k, p, W, EXPAND, REFOLD, SRC, stages);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uint8_t* Bb = static_cast<const uint8_t*>(B);
  if constexpr (REFOLD == kSum) {
    gf_planes_sum_kernel<W, EXPAND, SRC><<<blocks, kSumThreads, smem, stream>>>(
        static_cast<const uint4*>(opA), Bb, C, k, p, m, tile, pinned, stages);
  } else if constexpr (REFOLD == kDot) {
    gf_planes_dot_kernel<W, EXPAND, SRC><<<blocks, kSumThreads, smem, stream>>>(
        static_cast<const uint4*>(opA), static_cast<const uint2*>(opF), Bb, C, k, p, m, tile, pinned, stages);
  } else {
    gf_planes_none_kernel<W, EXPAND, SRC><<<blocks, kSumThreads, smem, stream>>>(
        static_cast<const uint4*>(opA), Bb, static_cast<int*>(C), k, p, m, tile, pinned, stages);
  }
  return (int)cudaGetLastError();
}

// Launch the sum (REFOLD kSum), dot (kDot; opF: F) or none kernel on the
// operator packed for it, by its route.
template <int W, int EXPAND, int REFOLD>
int launch_mma(const void* opA, const void* opF, const void* B, void* C, int k, int p,
               long long m, int tile, int pinned, cudaStream_t stream) {
  const Route r = mma_route(k, p, W, EXPAND, REFOLD);
  const long long blocks = (m + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  if (r.src == kStaged) {
    return launch_src<W, EXPAND, REFOLD, kStaged>(opA, opF, B, C, k, p, m, tile, pinned, r.stages, nb, stream);
  }
  if constexpr (EXPAND == kNibble && REFOLD != kNone) {
    if (r.src == kOpL1) {
      return launch_src<W, EXPAND, REFOLD, kOpL1>(opA, opF, B, C, k, p, m, tile, pinned, r.stages, nb, stream);
    }
  }
  if constexpr (W != 8 || REFOLD == kNone) {
    if (r.src == kDirect) {
      return launch_src<W, EXPAND, REFOLD, kDirect>(opA, opF, B, C, k, p, m, tile, pinned, 1, nb, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
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

// The expansions of the sum, dot and none kernels at w=8, at w=16 and at
// w=4: every (w, expand, refold) instance runs one of the three.
#define RS_SUM_EXPANDS(X) X(kShift) X(kShiftRaw) X(kCmp) X(kSign) X(kNibble)
#define RS_WIDE_EXPANDS(X) X(kShift) X(kShiftRaw) X(kSign)
#define RS_NARROW_EXPANDS(X) X(kShift) X(kShiftRaw)

}  // namespace

extern "C" {

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The route a launch at (k, p, w) takes: 0 operator and data staged in
// shared memory, 1 the operator through L1 beside the staged data, 2 both
// from device memory through L1, -1 refused (the shared memory does not
// hold what the instance needs).
int rs_gf_planes_route(int k, int p, int w, int expand, int refold) {
  return mma_route(k, p, w, expand, refold).src;
}

// Dynamic shared memory the GEMM needs at (k, p, w), in bytes, and its
// limit: its route's, with one step buffer a warp (the launch takes up to
// kSumStages that fit).
long long rs_gf_planes_smem(int k, int p, int w, int expand, int refold) {
  const Route r = mma_route(k, p, w, expand, refold);
  const int src = r.src < 0 ? kStaged : r.src;  // refused: the staged need, past the limit
  return (long long)mma_smem(k, p, w, expand, refold, src, 1);
}
int rs_gf_planes_smem_limit() { return kMaxSmem; }

// C = A . B over GF(2^w) with the (expand, refold) formulation.
//   opA: operator fragments, opF: F fragments (refold dot; else unused).
//   B: (k, m) uint8 (w=4, 8) or uint16 (w=16), row-major.  C: (p, m) of
//   B's type, or for refold none the (p*w, m) int32 accumulators.  tile:
//   columns per block, a positive multiple of kSumStepCols.  pinned != 0:
//   every block reads block 0.  Refold sum runs gf_planes_sum_kernel, dot
//   gf_planes_dot_kernel, none gf_planes_none_kernel (opA and opF packed
//   for them).  An instance not in the source returns
//   cudaErrorInvalidValue.
int rs_gf_planes(const void* opA, const void* opF, const void* B, void* C,
                 int k, int p, long long m, int tile, int w, int expand,
                 int refold, int pinned, void* stream) {
  if (k <= 0 || p <= 0 || m < 0 || tile <= 0 || tile % kSumStepCols) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RS_CALL_MMA(WW, E, R)                                           \
  if (w == WW && expand == E && refold == R)                            \
    return launch_mma<WW, E, R>(opA, opF, B, C, k, p, m, tile, pinned, s);
#define RS_CALL_W8(E) RS_CALL_MMA(8, E, kSum) RS_CALL_MMA(8, E, kDot) RS_CALL_MMA(8, E, kNone)
#define RS_CALL_W16(E) RS_CALL_MMA(16, E, kSum) RS_CALL_MMA(16, E, kDot) RS_CALL_MMA(16, E, kNone)
#define RS_CALL_W4(E) RS_CALL_MMA(4, E, kSum) RS_CALL_MMA(4, E, kDot) RS_CALL_MMA(4, E, kNone)
  RS_SUM_EXPANDS(RS_CALL_W8)
  RS_WIDE_EXPANDS(RS_CALL_W16)
  RS_NARROW_EXPANDS(RS_CALL_W4)
#undef RS_CALL_W4
#undef RS_CALL_W16
#undef RS_CALL_W8
#undef RS_CALL_MMA
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
