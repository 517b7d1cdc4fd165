// Tile code shared by the packed-state ConvBPDN kernels written by hand
// for Hopper (csc_iter.cu, pgm_iter.cu): plain fp32 FFMA tiles with fp32
// accumulation, masked ragged edges, no atomics.
//
//   adj_tile       one 128x128 tile of A = G2 @ Wa (8x8 outputs per
//                  thread, k-tiles of 8 in shared memory); the caller's
//                  epilogue updates the state elements of its own tile.
//   fwd_pair       R1 = P @ Wf and R2 = Q @ Wf over k = C in one pass,
//                  64x64 tiles, where (P, Q) = stage(A, B) elementwise
//                  while the state tiles are staged in shared memory, so
//                  each Wf tile is loaded once for both products.
//   block_partials one partial of each of NSUM sums per block, reduced
//                  in a fixed order.
//   sums_kernel    one block reduces the block partials in a fixed
//                  order, in double: the sums do not change from run to
//                  run, which the stopping tests need.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block of every kernel

constexpr int A_BM = 128;  // adj_tile: rows of the state
constexpr int A_BN = 128;  // columns (state channels)
constexpr int A_BK = 8;    // depth (taps)

constexpr int F_BM = 64;   // fwd_pair: rows of the state
constexpr int F_BN = 64;   // columns (taps)
constexpr int F_BK = 16;   // depth (state channels)

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

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
// (blockIdx.x, blockIdx.y) of A = G2 @ Wa, G2 (pos, T), Wa (T, C).
__device__ __forceinline__ void adj_tile(const float* __restrict__ G2,
                                         const float* __restrict__ Wa,
                                         int64_t pos, int64_t C, int64_t T,
                                         int vec, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[A_BK][A_BM];
  __shared__ __align__(16) float Bs[A_BK][A_BN];

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

  for (int64_t k0 = 0; k0 < T; k0 += A_BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < pos) av = load4(G2 + grow * T, k0 + ak, T, vec);
    As[ak + 0][ar] = av.x;
    As[ak + 1][ar] = av.y;
    As[ak + 2][ar] = av.z;
    As[ak + 3][ar] = av.w;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + bk < T) bv = load4(Wa + (k0 + bk) * C, col0 + bc, C, vec);
    *reinterpret_cast<float4*>(&Bs[bk][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < A_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
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

// R1 = P @ Wf and R2 = Q @ Wf, (P, Q) = stage(A, B) elementwise, for the
// 64x64 tile (blockIdx.x, blockIdx.y) of the (pos, T) outputs; A and B
// are (pos, C), Wf is (C, T).
template <class Stage>
__device__ __forceinline__ void fwd_pair(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const float* __restrict__ Wf,
                                         float* __restrict__ R1,
                                         float* __restrict__ R2,
                                         int64_t pos, int64_t C, int64_t T,
                                         int vec, Stage stage) {
  __shared__ __align__(16) float Ps[F_BK][F_BM];
  __shared__ __align__(16) float Qs[F_BK][F_BM];
  __shared__ __align__(16) float Ws[F_BK][F_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t row0 = (int64_t)blockIdx.x * F_BM;
  const int64_t col0 = (int64_t)blockIdx.y * F_BN;

  float a1[4][4], a2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a1[i][j] = a2[i][j] = 0.f;

  // loader roles: state tile row ar, depth ak..ak+3; weight tile depth
  // wk, columns wc..wc+3
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int wk = tid >> 4, wc = (tid & 15) * 4;
  const int64_t grow = row0 + ar;

  for (int64_t k0 = 0; k0 < C; k0 += F_BK) {
    float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f), y4 = x4;
    if (grow < pos) {
      x4 = load4(A + grow * C, k0 + ak, C, vec);
      y4 = load4(B + grow * C, k0 + ak, C, vec);
    }
    const float xa[4] = {x4.x, x4.y, x4.z, x4.w};
    const float ya[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) stage(xa[q], ya[q], Ps[ak + q][ar],
                                      Qs[ak + q][ar]);
    float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + wk < C) w4 = load4(Wf + (k0 + wk) * T, col0 + wc, T, vec);
    *reinterpret_cast<float4*>(&Ws[wk][wc]) = w4;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[kk][ty * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&Qs[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float qv[4] = {q.x, q.y, q.z, q.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a1[i][j] = fmaf(pv[i], wv[j], a1[i][j]);
          a2[i][j] = fmaf(qv[i], wv[j], a2[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= pos) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx * 4 + j;
      if (c >= T) break;
      R1[r * T + c] = a1[i][j];
      R2[r * T + c] = a2[i][j];
    }
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
