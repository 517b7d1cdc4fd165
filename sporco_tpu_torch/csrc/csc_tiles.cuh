// Tile code shared by the packed-state ConvBPDN kernels written by hand
// for Hopper (csc_iter.cu, pgm_iter.cu): masked ragged edges, no atomics.
//
//   adj_tile       one 128x128 tile of A = G2 @ Wa in fp32 FFMA, each
//                  output summed over k in order (8x8 outputs per thread,
//                  k-tiles of 8 in two shared-memory buffers); the
//                  caller's epilogue updates the state elements of its own
//                  tile.
//   fwd_pair       R1 = P @ Wf and R2 = Q @ Wf over k = C on the tensor
//                  cores (wgmma), 64x128 tiles, where (P, Q) = stage(A, B)
//                  elementwise as their fragments load, so each Wf tile
//                  serves both products.
//   block_partials one partial of each of NSUM sums per block, reduced
//                  in a fixed order.
//   sums_kernel    one block reduces the block partials in a fixed
//                  order, in double: the sums do not change from run to
//                  run, which the stopping tests need.
//
// Why the adjoint stays on FFMA.  Summed over k in order with one
// rounding per term, A is bit for bit the A of cuBLAS's fp32 product,
// which the plain version (and the kernel's tests) compute.  csc_iter's
// Un = us*U + AX - Yn cancels from A's magnitude down to the
// threshold's, so any A that differs from cuBLAS's by an ulp here and
// there moves Un by about 1e-5 of its scale at the headline problem,
// even the correctly rounded one (chip_smoke.py's kernel phase measures
// both, `adjoint`).  At k = 256 the adjoint is a third of the operations.
//
// The forward pair's arithmetic.  Each operand x is split into three
// bf16 terms with round-to-nearest, x1 = bf16(x), x2 = bf16(x - x1),
// x3 = bf16(x - x1 - x2) (split_bf16_3 of the JAX package; the
// differences are exact in fp32, and x1 + x2 + x3 = x for every normal
// x).  Of the nine products of the terms the six of order <= 2 are kept
// (a3b1, a2b2, a1b3, a2b1, a1b2, a1b1: the dropped ones are below 2^-24
// of a1b1), issued smallest first by wgmma (bf16 in, fp32 out) into one
// chain per product and 16-deep k step, which starts from zero.  The
// chain's result is added into the output's fp32 sum with ordinary FADDs
// (promotion), so the tensor core's own accumulation, which truncates,
// meets the large term once a k step, and the sum over k rounds as an
// fp32 sum rounds.  (Chains over a 32-deep k-tile ran 0.005-0.009 ms
// faster, but moved the elastic-net solve 1.6e-6 from its generic solve's
// objective; one chain over the whole sum is 1.4e-5 from float64.)
// The state operands are split in registers as each warp loads its
// fragments (wgmma takes A from registers; a warpgroup owns its rows, so
// each element is split once per column half); Wf, constant over a
// solve, comes split by the caller (split_weight in ops/csc_iter.py) and
// is read by wgmma from shared memory.
//
// The forward tiles.  A block has two warpgroups, one per 64-column half
// of the 64x128 block tile; a warp covers 16 rows of both products.  The
// tile's shape sets the bytes the blocks pull from L2 for their products:
// the state rows are read once per 128 columns, each Wf column once per
// 64 rows (671 MB a call at the headline shape).  A ring of F_STAGES
// k-tiles of 32 is fed by cp.async: the fp32 state rows (16-byte chunks
// swizzled so the fragment loads are free of bank conflicts) and the
// three bf16 planes of the Wf tile in wgmma's 128-byte-swizzled
// MN-major layout.  One __syncthreads per k-tile; the next F_AHEAD
// k-tiles load during its products, and its second k step's fragments
// are split while the first step's products run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block of adj_tile and sums_kernel

constexpr int A_BM = 128;  // adj_tile: rows of the state
constexpr int A_BN = 128;  // columns (state channels)
constexpr int A_BK = 8;    // depth (taps)

constexpr int F_NT = 256;  // fwd_pair: threads per block (8 warps)
constexpr int F_BM = 64;   // rows of the state
constexpr int F_BN = 128;  // columns (taps)
constexpr int F_BK = 32;   // depth (state channels) of a k-tile
constexpr int F_WN = 64;   // columns of a warp
constexpr int F_NF = F_WN / 8;     // n-fragments of 8 columns per warp
constexpr int F_STAGES = 3;        // k-tiles in the cp.async ring
constexpr int F_AHEAD = F_STAGES - 1;  // of them loading during the mma
static_assert(F_BK == 32, "fwd_pair's loop runs two k steps a k-tile");
constexpr int F_A_BYTES = 2 * F_BM * F_BK * 4;  // fp32 state, two arrays
constexpr int F_B_BYTES = 3 * F_BK * F_BN * 2;  // bf16 planes of Wf
constexpr int F_B_HALF = F_BK * F_WN * 2;       // one plane, 64 columns
constexpr int F_STAGE_BYTES = F_A_BYTES + F_B_BYTES;
// the ring, and room to align it to the 1024-byte swizzle atoms
constexpr int F_SMEM = F_STAGES * F_STAGE_BYTES + 1024;
// The split Wf is (3, Cp, Tp) bf16 with Cp = C rounded up to F_BK and
// Tp = T rounded up to SPLIT_COLS (one 16-byte chunk), zero-padded.
constexpr int SPLIT_COLS = 8;

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int64_t round_up(int64_t a, int64_t b) {
  return ceil_div(a, b) * b;
}

// Elements k..k+3 of a row of length n (zero past its end); one 16-byte
// load when allowed and in bounds.
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int64_t k, int64_t n, bool vec) {
  if (vec && k + 3 < n) return *reinterpret_cast<const float4*>(row + k);
  float4 v;
  v.x = k < n ? row[k] : 0.f;
  v.y = k + 1 < n ? row[k + 1] : 0.f;
  v.z = k + 2 < n ? row[k + 2] : 0.f;
  v.w = k + 3 < n ? row[k + 3] : 0.f;
  return v;
}

// State row of this thread's output row i (0..7) in the 128-row tile at
// row0: rows ty*4 .. ty*4+3, then 64 + ty*4 .. 64 + ty*4+3.
__device__ __forceinline__ int64_t adj_row(int64_t row0, int ty, int i) {
  return row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
}

// acc[i][h*4 + j] = A[adj_row(i), col0 + h*64 + tx*4 + j] for the tile
// (blockIdx.x, blockIdx.y) of A = G2 @ Wa, G2 (pos, T), Wa (T, C).  Each
// output is summed over k in order with fmaf; the next k-tile's loads are
// in flight during this one's products (two buffers, one barrier a
// k-tile).
__device__ __forceinline__ void adj_tile(const float* __restrict__ G2,
                                         const float* __restrict__ Wa,
                                         int64_t pos, int64_t C, int64_t T,
                                         int vec, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][A_BK][A_BM];
  __shared__ __align__(16) float Bs[2][A_BK][A_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t row0 = (int64_t)blockIdx.x * A_BM;
  const int64_t col0 = (int64_t)blockIdx.y * A_BN;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // loader roles: A tile row ar, depth ak..ak+3; B tile depth bk,
  // columns bc..bc+3
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bc = (tid & 31) * 4;
  const int64_t grow = row0 + ar;
  auto load = [&](int64_t k0, float4& av, float4& bv) {
    av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < pos) av = load4(G2 + grow * T, k0 + ak, T, vec);
    bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + bk < T) bv = load4(Wa + (k0 + bk) * C, col0 + bc, C, vec);
  };
  auto store = [&](int buf, const float4& av, const float4& bv) {
    As[buf][ak + 0][ar] = av.x;
    As[buf][ak + 1][ar] = av.y;
    As[buf][ak + 2][ar] = av.z;
    As[buf][ak + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) = bv;
  };

  float4 av, bv;
  load(0, av, bv);
  store(0, av, bv);
  __syncthreads();
  int buf = 0;
  for (int64_t k0 = 0; k0 < T; k0 += A_BK, buf ^= 1) {
    const bool more = k0 + A_BK < T;
    if (more) load(k0 + A_BK, av, bv);
#pragma unroll
    for (int kk = 0; kk < A_BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1, av, bv);
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or `bytes` of them, the rest zero) from global to shared.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared-memory descriptor of a wgmma operand stored MN-major with
// the 128-byte swizzle: atoms of 8 k-rows of 64 bf16 (128 bytes, 16-byte
// chunks permuted by k & 7), 1024 bytes apart along k; `addr` is the
// first row's, 1024-byte aligned.
__device__ __forceinline__ uint64_t mn_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4)          // start address
         | ((uint64_t)(F_B_HALF >> 4) << 16)         // next atom along n
         | ((uint64_t)(1024 >> 4) << 32)             // next 8 k-rows
         | (1ull << 62);                             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma results above the wait,
// or writes of its accumulators into a run of wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a @ B on the warpgroup's 64x64x16 tile: a the warp's 16 rows
// in mma.m16n8k16 A-fragment order, B (16 x 64, bf16) by its descriptor,
// fp32 out; d[4j + e] is row g + 8 (e >> 1), column 8j + 2t + (e & 1) of
// the warp's rows.  The first of a chain writes d (scale-d 0) and does
// not read it, so no other instruction defines d while the chain runs.
#define SPORCO_WGMMA_64X64(SCALE_D)                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE_D ", 0;\n"                     \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

__device__ __forceinline__ void wgmma_first(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(SPORCO_WGMMA_64X64("0")
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ void wgmma_acc(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(SPORCO_WGMMA_64X64("1")
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// (lo, hi) rounded to nearest bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// The three-term split of the pair (lo, hi) (lo in the low half, as the
// lower k index of a fragment register): p0 + p1 + p2 = (lo, hi).
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = bf16x2_rn(lo, hi);
  const float rl = lo - bf16_lo(p0), rh = hi - bf16_hi(p0);
  p1 = bf16x2_rn(rl, rh);
  p2 = bf16x2_rn(rl - bf16_lo(p1), rh - bf16_hi(p1));
}

// Offset in floats of element (r, k) of a state tile of F_BK columns: the
// 16-byte chunks of row r are permuted by (r & 3) << 1, so that the
// fragment loads of a half-warp (rows g..g+3, one pair of chunks each)
// fall in distinct banks.
__device__ __forceinline__ int a_off(int r, int k) {
  return r * F_BK + (((k >> 2) ^ ((r & 3) << 1)) << 2) + (k & 3);
}

// Offset in bf16 of the chunk of 8 columns c8 in row k of one 64-column
// half of a Wf plane: rows of 128 bytes, chunks permuted by k & 7 (the
// 128-byte swizzle wgmma reads, free of bank conflicts for cp.async).
__device__ __forceinline__ int b_off(int k, int c8) {
  return k * F_WN + ((c8 ^ (k & 7)) << 3);
}

// The A fragments of k-step kk of a ring slot, staged and split:
// af[product][term][register], register j holding rows r + 8 (j & 1),
// columns 2t + 8 (j >> 1) and the next one, r = (warp & 3)*16 + g.
template <class Stage>
__device__ __forceinline__ void fwd_frags(const unsigned char* slot, int kk,
                                          Stage stage,
                                          uint32_t (&af)[2][3][4]) {
  const float* sA = reinterpret_cast<const float*>(slot);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, r = (warp & 3) * 16 + (lane >> 2);
  float v[2][8];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(
          sA + s * F_BM * F_BK +
          a_off(r + 8 * (j & 1), kk * 16 + 2 * t + 8 * (j >> 1)));
      v[s][2 * j] = x.x;
      v[s][2 * j + 1] = x.y;
    }
  stage(v);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split3(v[s][2 * j], v[s][2 * j + 1], af[s][0][j], af[s][1][j],
             af[s][2][j]);
}

// Issue the six products of k-step kk of a ring slot for both products
// into the chains c[s], each from zero, smallest first; the warpgroup
// warp >> 2 multiplies by its 64-column half of the Wf terms.
__device__ __forceinline__ void fwd_issue(const unsigned char* slot, int kk,
                                          const uint32_t (&af)[2][3][4],
                                          float (&c)[2][32]) {
  const uint32_t sB = smem_addr(slot + F_A_BYTES) +
                      (threadIdx.x >> 7) * F_B_HALF + kk * 16 * F_WN * 2;
  uint64_t bd[3];  // term p at plane p's two halves further on
#pragma unroll
  for (int p = 0; p < 3; ++p) bd[p] = mn_sw128_desc(sB + p * 2 * F_B_HALF);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    wgmma_first(c[s], af[s][2], bd[0]);
    wgmma_acc(c[s], af[s][1], bd[1]);
    wgmma_acc(c[s], af[s][0], bd[2]);
    wgmma_acc(c[s], af[s][1], bd[0]);
    wgmma_acc(c[s], af[s][0], bd[1]);
    wgmma_acc(c[s], af[s][0], bd[0]);
  }
  wgmma_commit();
}

// Wait for the chains in flight and add them into the fp32 sums: acc[s]
// [f][e] is row (warp & 3)*16 + g + 8 (e >> 1), column (warp >> 2)*64 +
// f*8 + 2t + (e & 1) of product s.
__device__ __forceinline__ void fwd_promote(float (&c)[2][32],
                                            float (&acc)[2][F_NF][4]) {
  wgmma_wait();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    fence_operands(c[s]);
#pragma unroll
    for (int f = 0; f < F_NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][f][e] += c[s][4 * f + e];
  }
}

// R1 = P @ Wf and R2 = Q @ Wf, (P, Q) = stage(A, B) elementwise, for the
// 64x128 tile (blockIdx.x, blockIdx.y) of the (pos, T) outputs; A and B
// are (pos, C), Wf is given by its split Wf3 (3, Cp, Tp).  `smem` holds
// F_SMEM bytes of dynamic shared memory.  `vec`: C and T are multiples of
// 4 and A, B, R1, R2 16-byte aligned.
template <class Stage>
__device__ __forceinline__ void fwd_pair(unsigned char* smem,
                                         const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const uint16_t* __restrict__ Wf3,
                                         float* __restrict__ R1,
                                         float* __restrict__ R2,
                                         int64_t pos, int64_t C, int64_t T,
                                         int vec, Stage stage) {
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * F_BM;
  const int64_t col0 = (int64_t)blockIdx.y * F_BN;
  const int64_t Cp = round_up(C, F_BK), Tp = round_up(T, SPLIT_COLS);
  smem += (1024 - (smem_addr(smem) & 1023)) & 1023;  // the atoms' alignment
  const int nk = static_cast<int>(Cp / F_BK);

  // loader roles, the same every k-tile: 16-byte chunk c of state rows
  // lr + 32 i (i = 0, 1) of both arrays, and chunk cw of rows lw + 16 i
  // (i = 0, 1) of each Wf plane
  const int lr = tid >> 3, c = tid & 7;
  const int lw = tid >> 4, cw = tid & 15;
  const float* a_src = A + (row0 + lr) * C + c * 4;
  const float* b_src = B + (row0 + lr) * C + c * 4;
  const uint16_t* w_src = Wf3 + (int64_t)lw * Tp + col0 + cw * 8;
  const bool w_ok = col0 + cw * 8 < Tp;
  int row_ok = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_ok |= (row0 + lr + 32 * i < pos) << i;
  const int a_dst = a_off(lr, c * 4);  // + 32 i rows: same swizzle
  // + 16 i rows: same swizzle
  const int w_dst = (cw >> 3) * (F_B_HALF / 2) + b_off(lw, cw & 7);

  auto load = [&](int kt) {
    unsigned char* slot = smem + (kt % F_STAGES) * F_STAGE_BYTES;
    float* sA = reinterpret_cast<float*>(slot);
    uint16_t* sB = reinterpret_cast<uint16_t*>(slot + F_A_BYTES);
    const int64_t k0 = (int64_t)kt * F_BK;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* src = (s ? b_src : a_src) + k0;
      const float* base = s ? B : A;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t dst =
            smem_addr(sA + s * F_BM * F_BK + a_dst + 32 * i * F_BK);
        const float* gp = src + 32 * i * C;
        const bool rok = (row_ok >> i) & 1;
        if (vec) {
          const bool ok = rok && k0 + c * 4 < C;
          cp_async16(dst, ok ? gp : base, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = rok && k0 + c * 4 + e < C;
            cp_async4(dst + 4 * e, ok ? gp + e : base, ok ? 4 : 0);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cp_async16(smem_addr(sB + p * F_BK * F_BN + w_dst + 16 * i * F_WN),
                   w_ok ? w_src + (p * Cp + k0 + 16 * i) * Tp : Wf3,
                   w_ok ? 16 : 0);
  };

  float acc[2][F_NF][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < F_NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][f][e] = 0.f;

  // F_AHEAD k-tiles load while the tensor cores run k-tile kt
#pragma unroll
  for (int s = 0; s < F_AHEAD; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  // One chain per product and 16-deep k step, promoted before the next
  // step's; the second step's fragments are split while the first step's
  // products run.
  float ch[2][32];
  uint32_t af0[2][3][4], af1[2][3][4];
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<F_AHEAD - 1>();
    __syncthreads();  // k-tile kt landed; the products of kt - 1 are done
    if (kt + F_AHEAD < nk) load(kt + F_AHEAD);
    cp_async_commit();
    const unsigned char* slot = smem + (kt % F_STAGES) * F_STAGE_BYTES;
    fwd_frags(slot, 0, stage, af0);
    fwd_issue(slot, 0, af0, ch);
    fwd_frags(slot, 1, stage, af1);
    fwd_promote(ch, acc);
    fwd_issue(slot, 1, af1, ch);
    fwd_promote(ch, acc);
  }
  cp_async_wait<0>();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float* __restrict__ R = s ? R2 : R1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + (warp & 3) * 16 + g + 8 * h;
      if (r >= pos) continue;
#pragma unroll
      for (int f = 0; f < F_NF; ++f) {
        const int64_t col = col0 + (warp >> 2) * F_WN + f * 8 + 2 * t;
        const float v0 = acc[s][f][2 * h], v1 = acc[s][f][2 * h + 1];
        if (vec && col + 1 < T) {
          *reinterpret_cast<float2*>(R + r * T + col) = make_float2(v0, v1);
        } else {
          if (col < T) R[r * T + col] = v0;
          if (col + 1 < T) R[r * T + col + 1] = v1;
        }
      }
    }
  }
}

// Write this block's partial of each of the NSUM per-thread sums s to
// part[(blockIdx.y * gridDim.x + blockIdx.x) * NSUM + q].
template <int NSUM>
__device__ __forceinline__ void block_partials(const float (&s)[NSUM],
                                               float* __restrict__ part) {
  __shared__ float red[NSUM][NT / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    float v = s[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[q][warp] = v;
  }
  __syncthreads();
  if (tid < NSUM) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += red[tid][w];
    const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    part[blk * NSUM + tid] = v;
  }
}

template <int NSUM>
__global__ void __launch_bounds__(NT)
sums_kernel(const float* __restrict__ part, int64_t nblk,
            float* __restrict__ sums) {
  __shared__ double red[NT];
  const int tid = threadIdx.x;
  for (int q = 0; q < NSUM; ++q) {
    double v = 0.0;
    for (int64_t b = tid; b < nblk; b += NT) v += part[b * NSUM + q];
    red[tid] = v;
    __syncthreads();
    for (int h = NT / 2; h > 0; h >>= 1) {
      if (tid < h) red[tid] += red[tid + h];
      __syncthreads();
    }
    if (tid == 0) sums[q] = (float)red[0];
    __syncthreads();
  }
}

}  // namespace
