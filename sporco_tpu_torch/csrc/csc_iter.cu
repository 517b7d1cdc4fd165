// One fused ConvBPDN ADMM iteration over the packed polyphase state,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `csc_iter` of sporco_tpu/ops/pallas_csc_iter.py
// (`_iter_kernel`, launched by `_iter_call`).  Given the rolled adjoint
// operand G2 (pos, T), the state Y, U (pos, C) and the polyphase weights
// Wa (T, C) and Wf (C, T), Wf given as its bf16 split Wf3 (see
// csc_tiles.cuh), it computes, with products as accurate as fp32 sums:
//
//     A   = G2 @ Wa
//     PX  = scale * (Y - us*U) + A
//     AX  = rlx * PX + (1 - rlx) * Y
//     Yn  = soft(AX + us*U, thr)            (optionally >= 0)
//     Un  = us*U + AX - Yn
//     R1  = (Yn - Un) @ Wf,  R2 = Un @ Wf
//
// and the six sums ||PX-Yn||^2, ||Yn-Y||^2, ||PX||^2, ||Yn||^2, ||Un||^2,
// sum |wl1*PX|.  Yn and Un overwrite Y and U in place; PX is stored only
// when the caller passes a buffer for it.  `thr` and `wl1` are scalars or
// (C,) vectors.  The scalars that change from one iteration to the next
// (thr's scalar, us, scale) and the flag `live` come from a float32
// block in device memory, `scal` = [live, thr_s, us, scale], so that the
// fused driver's loop can run as a captured CUDA graph; where live is 0
// no kernel writes anything (Y, U, PX, R1, R2, the sums) and the launch
// is not counted.  rlx, wl1's scalar and nonneg, fixed over a solve, are
// passed by value.
//
// What bounds it.  At the headline problem (512x512 image, 64 8x8
// filters) pos = 4096, C = 4096, T = 256: three products of
// 4096 x 256 x 4096, 25.8 GFLOP per call, against about 0.29 GB that
// must move (read G2, Y, U, Wa, Wf; write Yn, Un, R1, R2).  In fp32 FFMA
// at 67 TFLOP/s the products take 0.385 ms against 0.087 ms for the
// bytes: the kernel is bound by operations.  The forward pair (two of
// the three products) runs on the tensor cores as six bf16 products of
// three-term splits, as accurate as fp32 sums, 103 GFLOP at
// 989 TFLOP/s: 0.104 ms; the adjoint stays fp32 FFMA, 0.128 ms, because
// Un cancels down to the threshold's magnitude and needs A bit for bit
// as an fp32 sum in order gives it (csc_tiles.cuh says why).
//
// Design (the tiles are in csc_tiles.cuh, shared with pgm_iter.cu):
//   1. iter_main: a 128x128-tile SGEMM of G2 @ Wa (8x8 outputs per
//      thread, k-tiles of 8 in shared memory, each output summed over k
//      in order) whose epilogue runs the elementwise update on its own
//      tile of Y and U.  Each element is read and written by one thread,
//      and no other block reads it, so the in-place update is safe.  Each
//      block writes one partial of each sum to a scratch buffer; there
//      are no float atomics, so the sums do not change from run to run.
//   2. iter_fwd: R1 and R2 on the tensor cores in one pass over k = C,
//      64x128 tiles of 8 warps, forming Yn - Un and Un as their fragments
//      load, so each Wf tile serves both; a ring of three k-tiles fed by
//      cp.async.  The 128 blocks, one per SM, fill the card in one wave
//      with the whole 4096-deep sum in each block: no split-k, no
//      reduction.  iter_fwd<true> is the opt-in "mixed" form: R1 as one
//      bf16 product of the operands rounded to nearest (fwd_passes = 1
//      of the JAX package), 7 tensor-core products a k step instead of
//      12; the default iter_fwd<false> is the code it was before.
//   3. sums_kernel<6>: one block reduces the per-block partials in a fixed
//      order, in double.
// Ragged edges are masked, so any pos, C and T are accepted.  The
// launch function returns cudaGetLastError() after each launch.

#include "csc_tiles.cuh"

namespace {

constexpr int NSUM = 6;

// The update's scalars fixed over a solve, passed by value.
struct Epi {
  float rlx;
  int nonneg;
};

// Where iter_main reads the scalar block [live, thr_s, us, scale] at
// each use, so that no value stays in a register across the epilogue
// (the kernel sits at its 128-register bound, and three values held
// there spilled): the scalar-weight instantiation through the read-only
// cache from device memory, the vector one from a volatile copy in
// shared memory.  Each is the form that ptxas compiles without a spill
// for that instantiation (the other one spilled).
struct ScalGlobal {
  const float* __restrict__ g;
  __device__ __forceinline__ float operator[](int i) const {
    return __ldg(g + i);
  }
};
struct ScalShared {
  const volatile float* s;
  __device__ __forceinline__ float operator[](int i) const { return s[i]; }
};

// The elementwise ADMM update of one state element; accumulates the six
// sums into s.  Each operation rounds on its own, in the plain version's
// order (the _rn intrinsics keep nvcc from contracting a multiply and an
// add into one FMA): Un = us*U + AX - Yn cancels down to the threshold's
// size, so a PX or AX rounded once instead of twice, no less accurate,
// still moves Un by ulps of AX, and over 12288 rows (three channels
// folded) that passed 1e-5 of Un's scale against the plain version with
// A bit for bit the same.
template <class Scal>
__device__ __forceinline__ void update(const Epi& p, const Scal& sc,
                                       float a, float y, float u0,
                                       float th, float w, float& px,
                                       float& yn, float& un, float* s) {
  const float u = __fmul_rn(sc[2], u0);
  px = __fadd_rn(__fmul_rn(sc[3], __fsub_rn(y, u)), a);
  const float ax =
      __fadd_rn(__fmul_rn(p.rlx, px), __fmul_rn(1.f - p.rlx, y));
  const float axu = __fadd_rn(ax, u);
  const float t = fabsf(axu) - th;
  const float m = (t > 0.f || t != t) ? t : 0.f;  // max(t, 0), NaN kept
  yn = axu != 0.f ? copysignf(m, axu) : 0.f;
  if (p.nonneg && yn < 0.f) yn = 0.f;
  un = __fsub_rn(axu, yn);
  const float d = px - yn, e = yn - y;
  s[0] += d * d;
  s[1] += e * e;
  s[2] += px * px;
  s[3] += yn * yn;
  s[4] += un * un;
  s[5] += fabsf(px) * w;
}

// The product and the epilogue of iter_main, reading the scalar block
// through `sc`.
template <bool VW, class Scal>
__device__ __forceinline__ void iter_body(
    const float* __restrict__ G2, float* __restrict__ Y,
    float* __restrict__ U, const float* __restrict__ Wa,
    const float* __restrict__ thr_v, const float* __restrict__ wl1_v,
    float wl1_s, const Scal& sc, const Epi& p, float* __restrict__ PX,
    float* __restrict__ part, int64_t pos, int64_t C, int64_t T,
    int vec) {
  float acc[8][8];
  adj_tile(G2, Wa, pos, C, T, vec, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = (int64_t)blockIdx.x * A_BM;
  const int64_t col0 = (int64_t)blockIdx.y * A_BN;
  float s[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
        const float4 u4 = *reinterpret_cast<const float4*>(U + idx);
        const float thr_s = VW ? 0.f : sc[1];
        const float4 th4 =
            VW ? *reinterpret_cast<const float4*>(thr_v + c)
                  : make_float4(thr_s, thr_s, thr_s, thr_s);
        const float4 w4 =
            VW ? *reinterpret_cast<const float4*>(wl1_v + c)
                  : make_float4(wl1_s, wl1_s, wl1_s, wl1_s);
        float4 px4, yn4, un4;
        update(p, sc, acc[i][h * 4 + 0], y4.x, u4.x, th4.x, w4.x, px4.x,
               yn4.x, un4.x, s);
        update(p, sc, acc[i][h * 4 + 1], y4.y, u4.y, th4.y, w4.y, px4.y,
               yn4.y, un4.y, s);
        update(p, sc, acc[i][h * 4 + 2], y4.z, u4.z, th4.z, w4.z, px4.z,
               yn4.z, un4.z, s);
        update(p, sc, acc[i][h * 4 + 3], y4.w, u4.w, th4.w, w4.w, px4.w,
               yn4.w, un4.w, s);
        *reinterpret_cast<float4*>(Y + idx) = yn4;
        *reinterpret_cast<float4*>(U + idx) = un4;
        if (PX) *reinterpret_cast<float4*>(PX + idx) = px4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= C) break;
          float px, yn, un;
          update(p, sc, acc[i][h * 4 + j], Y[idx + j], U[idx + j],
                 VW ? thr_v[c + j] : sc[1],
                 VW ? wl1_v[c + j] : wl1_s, px, yn, un, s);
          Y[idx + j] = yn;
          U[idx + j] = un;
          if (PX) PX[idx + j] = px;
        }
      }
    }
  }
  block_partials<NSUM>(s, part);
}

// VW: thr and wl1 are (C,) vectors, else the scalars thr_s / wl1_s.  Two
// instantiations keep the scalar case (the main path) from holding the
// vectors' loads in registers: at 128 registers a thread (two blocks an
// SM), with the epilogue rounded as above, one kernel for both spilled.
// Each reads the scalar block its own way (ScalGlobal, ScalShared) and
// returns before any write where `live` is 0.
template <bool VW>
__global__ void __launch_bounds__(NT, 2)
iter_main(const float* __restrict__ G2, float* __restrict__ Y,
          float* __restrict__ U, const float* __restrict__ Wa,
          const float* __restrict__ thr_v, const float* __restrict__ wl1_v,
          float wl1_s, const float* __restrict__ scal, Epi p,
          float* __restrict__ PX, float* __restrict__ part, int64_t pos,
          int64_t C, int64_t T, int vec) {
  if constexpr (VW) {
    __shared__ float sc_s[4];
    if (threadIdx.x < 4) sc_s[threadIdx.x] = scal[threadIdx.x];
    __syncthreads();
    const ScalShared sc{sc_s};
    if (sc[0] == 0.f) return;
    iter_body<VW>(G2, Y, U, Wa, thr_v, wl1_v, wl1_s, sc, p, PX, part, pos,
                  C, T, vec);
  } else {
    const ScalGlobal sc{scal};
    if (sc[0] == 0.f) return;
    iter_body<VW>(G2, Y, U, Wa, thr_v, wl1_v, wl1_s, sc, p, PX, part, pos,
                  C, T, vec);
  }
}

// R1 stages Yn - Un, R2 stages Un.
struct StageDiff {
  __device__ __forceinline__ void operator()(float (&v)[2][8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[0][e] -= v[1][e];
  }
};

// MIXED: R1 as one bf16 product (the opt-in "mixed" precision).
template <bool MIXED>
__global__ void __launch_bounds__(F_NT, 1)
iter_fwd(const float* __restrict__ Yn, const float* __restrict__ Un,
         const uint16_t* __restrict__ Wf3, float* __restrict__ R1,
         float* __restrict__ R2, const float* __restrict__ scal,
         int64_t pos, int64_t C, int64_t T, int vec) {
  if (!launch_live(scal)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_pair<MIXED>(smem, Yn, Un, Wf3, R1, R2, pos, C, T, vec, StageDiff());
}

template <bool MIXED>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* Yn,
                       const float* Un, const uint16_t* Wf3, float* R1,
                       float* R2, const float* scal, int64_t pos,
                       int64_t C, int64_t T, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      iter_fwd<MIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  iter_fwd<MIXED><<<grid, F_NT, F_SMEM, st>>>(Yn, Un, Wf3, R1, R2, scal,
                                              pos, C, T, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of floats of scratch the launch needs for the block partials.
int64_t csc_iter_scratch_floats(int64_t pos, int64_t C) {
  return ceil_div(pos, A_BM) * ceil_div(C, A_BN) * NSUM;
}

// Launch the three kernels on `stream`.  Wf3 is the bf16 split of Wf,
// (3, round_up(C, 32), round_up(T, 8)), zero-padded.  `scal` is the
// float32 block [live, thr_s, us, scale] in device memory; `cnt` (may be
// null) an int32 counter that gains 1 if live.  thr_v and wl1_v are both
// (C,) vectors or both null, in which case the scalars thr_s / wl1_s
// apply to every channel; PX may be null (not stored).  With Wf3,
// R1 and R2 all null the forward pair is skipped: iter_fwd is not
// launched (the consensus CDL stage, whose dictionary changes before the
// next forward product is needed).  `vec` allows 16-byte accesses:
// the caller sets it only when C and T are multiples of 4 and every
// pointer is 16-byte aligned.  `mixed` computes R1 as one bf16 product
// (R2 keeps its six).  Returns a cudaError_t.
int csc_iter_launch(const float* G2, float* Y, float* U, const float* Wa,
                    const uint16_t* Wf3, const float* thr_v,
                    const float* wl1_v, float wl1_s, const float* scal,
                    float rlx, int nonneg, int vec, int mixed, float* PX,
                    float* R1, float* R2, float* part, float* sums,
                    int* cnt, int64_t pos, int64_t C, int64_t T,
                    void* stream) {
  const bool fwd = Wf3 != nullptr;
  if (pos <= 0 || C <= 0 || T <= 0 || !thr_v != !wl1_v ||
      !R1 != !fwd || !R2 != !fwd || !scal)
    return (int)cudaErrorInvalidValue;
  const int64_t g1x = ceil_div(pos, A_BM), g1y = ceil_div(C, A_BN);
  const int64_t g2x = ceil_div(pos, F_BM), g2y = ceil_div(T, F_BN);
  if (g1x > 0x7fffffff || g2x > 0x7fffffff || g1y > 65535 || g2y > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi p{rlx, nonneg};

  const dim3 g1((unsigned)g1x, (unsigned)g1y);
  if (thr_v)
    iter_main<true><<<g1, NT, 0, st>>>(G2, Y, U, Wa, thr_v, wl1_v, wl1_s,
                                       scal, p, PX, part, pos, C, T, vec);
  else
    iter_main<false><<<g1, NT, 0, st>>>(G2, Y, U, Wa, thr_v, wl1_v, wl1_s,
                                        scal, p, PX, part, pos, C, T,
                                        vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (fwd) {
    const dim3 g2((unsigned)g2x, (unsigned)g2y);
    err = mixed ? launch_fwd<true>(g2, st, Y, U, Wf3, R1, R2, scal, pos, C,
                                   T, vec)
                : launch_fwd<false>(g2, st, Y, U, Wf3, R1, R2, scal, pos, C,
                                    T, vec);
    if (err != cudaSuccess) return (int)err;
  }

  sums_kernel<NSUM><<<1, NT, 0, st>>>(part, g1x * g1y, sums, scal, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
