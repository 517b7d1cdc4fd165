// The ADMM iteration tail of the fused ConvBPDN driver in one pass over
// the packed state, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `admm_tail` of sporco_tpu/ops/pallas_csc_tail.py
// (`_tail_kernel`, launched by `_tail_call`).  Given the x-step result PX,
// the state PY and the scaled dual PU, all (R, C) float32 with C the
// packed channel axis, it computes per element
//
//     pu  = us * PU                       (the deferred AutoRho rescale)
//     ax  = rlx * PX + (1 - rlx) * PY
//     axu = ax + pu
//     PYn = soft(axu, thr[c])             (optionally >= 0)
//     PUn = pu + ax - PYn
//
// and the six sums ||PX-PYn||^2, ||PYn-PY||^2, ||PX||^2, ||PYn||^2,
// ||PUn||^2, sum |wl1[c]*PX|.  PYn and PUn overwrite PY and PU in place:
// each element is read and then written by the one thread that owns it.
// `thr` and `wl1` are (C,) vectors or scalars applied to every channel.
//
// What bounds it.  At the headline problem (512x512 image, 64 filters)
// R = 4096 and C = 4096: three 67.1 MB arrays in and two out, 335 MB,
// against about 26 operations per element (0.44 GFLOP).  At the H100
// SXM's 3.35 TB/s and 67 TFLOP/s that is 0.100 ms of memory traffic
// against 0.007 ms of arithmetic: the kernel is bound by bytes, so it
// touches each element once, with 16-byte loads and stores where the
// layout allows.
//
// Design (simple first):
//   1. tail_main: a grid-stride loop over groups of four elements (one
//      float4 of each array; the scalar path masks a ragged C or an
//      unaligned buffer), a fixed grid of at most TAIL_BLOCKS blocks.
//      Each thread accumulates its six sums in double (products in
//      double too); each block reduces its threads' sums in a fixed order
//      and writes one partial of each.
//   2. tail_sums: one block reduces the block partials in a fixed order,
//      in double, to six float32 values.  There are no float atomics, so
//      the sums do not change from run to run, which the stopping test
//      needs.
// Any R >= 1 and C >= 1 are accepted.  The launch function returns
// cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NSUM = 6;
constexpr int64_t TAIL_BLOCKS = 1056;  // 8 resident blocks on each of 132 SMs

struct Tail {
  float rlx, rlx1, us;
  int nonneg;
};

// The tail of one element; accumulates the six sums into s.  Every
// operation rounds on its own (the _rn intrinsics are never contracted
// into FMAs), in the order of the plain version's torch kernels, so PYn
// and PUn equal the plain version's bit for bit: PUn = pu + ax - PYn
// cancels to the size of thr while ax is of the size of PX, so one
// contracted rounding of ax would show in PUn magnified by |PX| / thr.
__device__ __forceinline__ void tail1(const Tail& p, float px, float py,
                                      float u0, float th, float w,
                                      float& yn, float& un, double* s) {
  const float pu = __fmul_rn(p.us, u0);
  const float ax = __fadd_rn(__fmul_rn(p.rlx, px), __fmul_rn(p.rlx1, py));
  const float axu = __fadd_rn(ax, pu);
  const float t = __fsub_rn(fabsf(axu), th);
  const float m = (t > 0.f || t != t) ? t : 0.f;  // max(t, 0), NaN kept
  yn = axu != 0.f ? copysignf(m, axu) : 0.f;
  if (p.nonneg && yn < 0.f) yn = 0.f;
  un = __fsub_rn(__fadd_rn(pu, ax), yn);
  const double d = __fsub_rn(px, yn), e = __fsub_rn(yn, py);
  const double x = px, y = yn, u = un;
  s[0] += d * d;
  s[1] += e * e;
  s[2] += x * x;
  s[3] += y * y;
  s[4] += u * u;
  s[5] += fabs(x) * (double)w;
}

__global__ void __launch_bounds__(NT)
tail_main(const float* __restrict__ PX, float* __restrict__ PY,
          float* __restrict__ PU, const float* __restrict__ thr_v,
          float thr_s, const float* __restrict__ wl1_v, float wl1_s,
          Tail p, double* __restrict__ part, int64_t n, int64_t C,
          int vec) {
  double s[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t stride = (int64_t)gridDim.x * NT;
  const int64_t ngroup = (n + 3) / 4;
  for (int64_t g = (int64_t)blockIdx.x * NT + threadIdx.x; g < ngroup;
       g += stride) {
    const int64_t i = 4 * g;
    if (vec) {
      // C % 4 == 0: the four elements share a row, columns c..c+3
      const int64_t c = i % C;
      const float4 x4 = *reinterpret_cast<const float4*>(PX + i);
      const float4 y4 = *reinterpret_cast<const float4*>(PY + i);
      const float4 u4 = *reinterpret_cast<const float4*>(PU + i);
      const float4 th4 = thr_v
          ? *reinterpret_cast<const float4*>(thr_v + c)
          : make_float4(thr_s, thr_s, thr_s, thr_s);
      const float4 w4 = wl1_v
          ? *reinterpret_cast<const float4*>(wl1_v + c)
          : make_float4(wl1_s, wl1_s, wl1_s, wl1_s);
      float4 yn4, un4;
      tail1(p, x4.x, y4.x, u4.x, th4.x, w4.x, yn4.x, un4.x, s);
      tail1(p, x4.y, y4.y, u4.y, th4.y, w4.y, yn4.y, un4.y, s);
      tail1(p, x4.z, y4.z, u4.z, th4.z, w4.z, yn4.z, un4.z, s);
      tail1(p, x4.w, y4.w, u4.w, th4.w, w4.w, yn4.w, un4.w, s);
      *reinterpret_cast<float4*>(PY + i) = yn4;
      *reinterpret_cast<float4*>(PU + i) = un4;
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j) {
        const int64_t c = (i + j) % C;
        float yn, un;
        tail1(p, PX[i + j], PY[i + j], PU[i + j],
              thr_v ? thr_v[c] : thr_s, wl1_v ? wl1_v[c] : wl1_s, yn, un,
              s);
        PY[i + j] = yn;
        PU[i + j] = un;
      }
    }
  }

  // the block's partials: warps by shuffle, then warp 0's lanes in order
  __shared__ double red[NSUM][NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    double v = s[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[q][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += red[threadIdx.x][w];
    part[(int64_t)blockIdx.x * NSUM + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(NT)
tail_sums(const double* __restrict__ part, int64_t nblk,
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

int64_t tail_blocks(int64_t n) {
  const int64_t need = ((n + 3) / 4 + NT - 1) / NT;
  return need < TAIL_BLOCKS ? need : TAIL_BLOCKS;
}

}  // namespace

extern "C" {

// Number of doubles of scratch the launch needs for the block partials
// of an array of n elements.
int64_t csc_tail_scratch_doubles(int64_t n) {
  return tail_blocks(n) * NSUM;
}

// Launch the two kernels on `stream`.  PY and PU are overwritten with
// PYn and PUn.  thr_v / wl1_v may be null, in which case the scalars
// thr_s / wl1_s apply to every channel.  `vec` allows 16-byte accesses:
// the caller sets it only when C is a multiple of 4 and every pointer is
// 16-byte aligned.  Returns a cudaError_t.
int csc_tail_launch(const float* PX, float* PY, float* PU,
                    const float* thr_v, float thr_s, const float* wl1_v,
                    float wl1_s, float rlx, float us, int nonneg, int vec,
                    double* part, float* sums, int64_t R, int64_t C,
                    void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n = R * C;
  const int64_t nblk = tail_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tail p{rlx, 1.f - rlx, us, nonneg};

  tail_main<<<(unsigned)nblk, NT, 0, st>>>(PX, PY, PU, thr_v, thr_s, wl1_v,
                                           wl1_s, p, part, n, C,
                                           vec && C % 4 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  tail_sums<<<1, NT, 0, st>>>(part, nblk, sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
