// One fused ConvBPDN FISTA (PGM) iteration over the packed polyphase
// state, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `pgm_iter` of sporco_tpu/ops/pallas_csc_iter.py
// (`_pgm_kernel`, launched by `_pgm_call`).  Given the rolled gradient
// operand G2 (pos, T), the extrapolation point Y and the previous
// iterate Xprv (pos, C) and the polyphase weights Wa (T, C) and
// Wf (C, T), Wf given as its bf16 split Wf3 (see csc_tiles.cuh), it
// computes, with products as accurate as fp32 sums:
//
//     A   = G2 @ Wa
//     V   = Y - rL * A                      (rL = 1/L)
//     X   = soft(V, thr)                    (optionally >= 0)
//     Yn  = X + beta * (X - Xprv)
//     R1  = Yn @ Wf,  RX = X @ Wf
//
// and the two sums ||X - Y||^2 (with the old Y: the fixed-point
// residual) and sum |X| * wl1.  X overwrites Xprv and Yn overwrites Y in
// place.  `thr` and `wl1` are scalars or (C,) vectors.  The scalars that
// change from one iteration to the next (thr's scalar, rL, beta) and the
// flag `live` come from a float32 block in device memory, `scal` =
// [live, thr_s, rL, beta] (see csc_iter.cu): where live is 0 no kernel
// writes anything (Xprv, Y, R1, RX, the sums) and the launch is not
// counted.  wl1's scalar and nonneg are passed by value.
//
// What bounds it.  At the headline problem (512x512 image, 64 8x8
// filters) pos = 4096, C = 4096, T = 256: three products of
// 4096 x 256 x 4096, 25.8 GFLOP per call, against about 0.29 GB that
// must move (read G2, Y, Xprv, Wa, Wf; write X, Yn, R1, RX).  In fp32
// FFMA at 67 TFLOP/s the products take 0.385 ms against 0.086 ms for the
// bytes: the kernel is bound by operations.  R1 feeds a residual that
// cancels near convergence and needs products as accurate as fp32 sums:
// the forward pair runs on the tensor cores as six bf16 products of
// three-term splits, 103 GFLOP at 989 TFLOP/s: 0.104 ms; the adjoint
// stays fp32 FFMA (0.128 ms), the tile csc_iter needs.
//
// Design (the tiles are in csc_tiles.cuh, shared with csc_iter.cu):
//   1. pgm_main: a 128x128-tile SGEMM of G2 @ Wa (8x8 outputs per
//      thread, k-tiles of 8 in shared memory) whose epilogue runs the
//      FISTA update on its own tile of Y and Xprv.  Each element is read
//      and written by one thread, and no other block reads it, so the
//      in-place update is safe.  Each block writes one partial of each
//      sum to a scratch buffer; there are no float atomics, so the sums
//      (which the stopping test reads) do not change from run to run.
//   2. pgm_fwd: R1 and RX on the tensor cores in one pass over k = C,
//      64x128 tiles of 8 warps, loading each Wf tile once for both; 128
//      blocks fill the card in one wave.  A row of R1 needs all C
//      channels of the updated Yn, so it follows pgm_main on the stream.
//      pgm_fwd<true> is the opt-in "mixed" form: R1 as one bf16 product.
//   3. sums_kernel<2>: one block reduces the per-block partials in a fixed
//      order, in double.
// Ragged edges are masked, so any pos, C and T are accepted.  The
// launch function returns cudaGetLastError() after each launch.

#include "csc_tiles.cuh"

namespace {

constexpr int NSUM = 2;

struct Epi {
  float rL, beta;
  int nonneg;
};

// The elementwise FISTA update of one state element; accumulates the two
// sums into s.
__device__ __forceinline__ void update(const Epi& p, float a, float y,
                                       float xp, float th, float w,
                                       float& x, float& yn, float* s) {
  const float v = y - p.rL * a;
  const float t = fabsf(v) - th;
  const float m = (t > 0.f || t != t) ? t : 0.f;  // max(t, 0), NaN kept
  x = v != 0.f ? copysignf(m, v) : 0.f;
  if (p.nonneg && x < 0.f) x = 0.f;
  yn = x + p.beta * (x - xp);
  const float d = x - y;
  s[0] += d * d;
  s[1] += fabsf(x) * w;
}

__global__ void __launch_bounds__(NT, 2)
pgm_main(const float* __restrict__ G2, float* __restrict__ Y,
         float* __restrict__ Xp, const float* __restrict__ Wa,
         const float* __restrict__ thr_v, const float* __restrict__ wl1_v,
         float wl1_s, const float* __restrict__ scal, int nonneg,
         float* __restrict__ part, int64_t pos, int64_t C, int64_t T,
         int vec) {
  // the scalar block, read once, kept in shared memory (as iter_main)
  __shared__ float sc[4];
  if (threadIdx.x < 4) sc[threadIdx.x] = scal[threadIdx.x];
  __syncthreads();
  if (sc[0] == 0.f) return;
  float acc[8][8];
  adj_tile(G2, Wa, pos, C, T, vec, acc);
  const Epi p{sc[2], sc[3], nonneg};
  const float thr_s = sc[1];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = (int64_t)blockIdx.x * A_BM;
  const int64_t col0 = (int64_t)blockIdx.y * A_BN;
  float s[NSUM] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = adj_row(row0, ty, i);
    if (r >= pos) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = col0 + h * 64 + tx * 4;
      const int64_t idx = r * C + c;
      if (vec && c + 3 < C) {
        const float4 y4 = *reinterpret_cast<const float4*>(Y + idx);
        const float4 xp4 = *reinterpret_cast<const float4*>(Xp + idx);
        const float4 th4 =
            thr_v ? *reinterpret_cast<const float4*>(thr_v + c)
                  : make_float4(thr_s, thr_s, thr_s, thr_s);
        const float4 w4 =
            wl1_v ? *reinterpret_cast<const float4*>(wl1_v + c)
                  : make_float4(wl1_s, wl1_s, wl1_s, wl1_s);
        float4 x4, yn4;
        update(p, acc[i][h * 4 + 0], y4.x, xp4.x, th4.x, w4.x, x4.x,
               yn4.x, s);
        update(p, acc[i][h * 4 + 1], y4.y, xp4.y, th4.y, w4.y, x4.y,
               yn4.y, s);
        update(p, acc[i][h * 4 + 2], y4.z, xp4.z, th4.z, w4.z, x4.z,
               yn4.z, s);
        update(p, acc[i][h * 4 + 3], y4.w, xp4.w, th4.w, w4.w, x4.w,
               yn4.w, s);
        *reinterpret_cast<float4*>(Xp + idx) = x4;
        *reinterpret_cast<float4*>(Y + idx) = yn4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= C) break;
          float x, yn;
          update(p, acc[i][h * 4 + j], Y[idx + j], Xp[idx + j],
                 thr_v ? thr_v[c + j] : thr_s,
                 wl1_v ? wl1_v[c + j] : wl1_s, x, yn, s);
          Xp[idx + j] = x;
          Y[idx + j] = yn;
        }
      }
    }
  }
  block_partials<NSUM>(s, part);
}

// R1 stages Yn, RX stages X.
struct StageSame {
  __device__ __forceinline__ void operator()(float (&)[2][8]) const {}
};

// MIXED: R1 as one bf16 product (the opt-in "mixed" precision).
template <bool MIXED>
__global__ void __launch_bounds__(F_NT, 1)
pgm_fwd(const float* __restrict__ Yn, const float* __restrict__ X,
        const uint16_t* __restrict__ Wf3, float* __restrict__ R1,
        float* __restrict__ RX, const float* __restrict__ scal,
        int64_t pos, int64_t C, int64_t T, int vec) {
  if (!launch_live(scal)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_pair<MIXED>(smem, Yn, X, Wf3, R1, RX, pos, C, T, vec, StageSame());
}

template <bool MIXED>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* Yn,
                       const float* X, const uint16_t* Wf3, float* R1,
                       float* RX, const float* scal, int64_t pos, int64_t C,
                       int64_t T, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      pgm_fwd<MIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  pgm_fwd<MIXED><<<grid, F_NT, F_SMEM, st>>>(Yn, X, Wf3, R1, RX, scal, pos,
                                             C, T, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of floats of scratch the launch needs for the block partials.
int64_t pgm_iter_scratch_floats(int64_t pos, int64_t C) {
  return ceil_div(pos, A_BM) * ceil_div(C, A_BN) * NSUM;
}

// Launch the three kernels on `stream`.  Wf3 is the bf16 split of Wf,
// (3, round_up(C, 32), round_up(T, 8)), zero-padded.  `scal` is the
// float32 block [live, thr_s, rL, beta] in device memory; `cnt` (may be
// null) an int32 counter that gains 1 if live.  thr_v / wl1_v may be
// null, in which case the scalars thr_s / wl1_s apply to every
// channel.  `vec` allows 16-byte accesses: the caller sets it only when C
// and T are multiples of 4 and every pointer is 16-byte aligned.  `mixed`
// computes R1 as one bf16 product (RX keeps its six).  Returns a
// cudaError_t.
int pgm_iter_launch(const float* G2, float* Y, float* Xp, const float* Wa,
                    const uint16_t* Wf3, const float* thr_v,
                    const float* wl1_v, float wl1_s, const float* scal,
                    int nonneg, int vec, int mixed, float* R1, float* RX,
                    float* part, float* sums, int* cnt, int64_t pos,
                    int64_t C, int64_t T, void* stream) {
  if (pos <= 0 || C <= 0 || T <= 0 || !scal)
    return (int)cudaErrorInvalidValue;
  const int64_t g1x = ceil_div(pos, A_BM), g1y = ceil_div(C, A_BN);
  const int64_t g2x = ceil_div(pos, F_BM), g2y = ceil_div(T, F_BN);
  if (g1x > 0x7fffffff || g2x > 0x7fffffff || g1y > 65535 || g2y > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  pgm_main<<<dim3((unsigned)g1x, (unsigned)g1y), NT, 0, st>>>(
      G2, Y, Xp, Wa, thr_v, wl1_v, wl1_s, scal, nonneg, part, pos, C, T,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 g2((unsigned)g2x, (unsigned)g2y);
  err = mixed ? launch_fwd<true>(g2, st, Y, Xp, Wf3, R1, RX, scal, pos, C,
                                 T, vec)
              : launch_fwd<false>(g2, st, Y, Xp, Wf3, R1, RX, scal, pos, C,
                                  T, vec);
  if (err != cudaSuccess) return (int)err;

  sums_kernel<NSUM><<<1, NT, 0, st>>>(part, g1x * g1y, sums, scal, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
