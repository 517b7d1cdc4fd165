// Batched 2-D real FFT and its inverse on planar (separate real and
// imaginary) float32 planes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels `rfft2_planar` and `irfft2_planar` of
// sporco_tpu/ops/pallas_fft.py (`_fwd_kernel_high/_exact`,
// `_inv_kernel_high/_exact`).  For B planes of N0 x N1 float32 values:
//
//     rfft2_planar:   x (B, N0, N1)  ->  yr, yi (B, N0, K1),  K1 = N1/2 + 1
//                     numpy.fft.rfftn over the last two axes;
//     irfft2_planar:  yr, yi (B, N0, K1), N1  ->  x (B, N0, N1)
//                     numpy.fft.irfftn(., s=(N0, N1)): the inverse c2c on
//                     axis 0 first, then the c2r on axis 1, which drops the
//                     imaginary part of columns 0 and N1/2 after the c2c
//                     (the input need not be Hermitian);
//     irfft2_spectrum:  the same from one complex64 array y (B, N0, K1)
//                     (interleaved real and imaginary parts).
//
// Shapes: N0 in {128, 256, 512} (a power of two), N1 even, 2 <= N1 <= 2048;
// the caller flattens lead dimensions into B.  The twiddle tables are built
// on the host in float64 and passed in as float32 (2, N): cos(2 pi k / N)
// in the first row, sin(2 pi k / N) in the second.  Everything is fp32;
// no fast-math intrinsic is used.
//
// What bounds it.  At the ConvBPDN x-step's size (B = 64 planes of
// 512 x 512) each transform must read 67.1 MB and write 67.4 MB (or the
// reverse): 134.5 MB, 0.040 ms at 3.35 TB/s.  Its arithmetic, about
// 2.5 N log2 N operations for N real points, is under 1 GFLOP: 0.011 ms at
// 67 TFLOP/s.  The transform is bound by memory traffic, and each of its
// two passes below moves those bytes once more: 0.040 ms a pass at best.
//
// The forward transform, for a power-of-two N1 (the main path's):
//   1. rows (axis 1), `fft_rows_r2c_pow2`: each real row of N1 values is
//      read as M = N1/2 complex values z[n] = x[2n] + i x[2n+1], one float2
//      load per point, coalesced (a scalar-load path takes input that is
//      not 8-byte aligned).  A complex FFT of length M runs in registers:
//      each thread holds 16 points (M for M < 16) and runs radix-16 (or
//      the remaining smaller radix) butterflies there, Stockham order, so
//      no bit-reversal scatter; threads exchange through shared memory
//      padded by one float2 in 16, which makes every exchange free of bank
//      conflicts.  A warp owns whole rows up to M = 512 and then syncs
//      with __syncwarp() alone; M = 256 (N1 = 512) is two register passes
//      and one exchange.  Then the post-pass, one pair (k, M - k) per
//      thread, k = 0..M/2, with E = (Z[k] + conj Z[M-k]) / 2 and
//      O = -i (Z[k] - conj Z[M-k]) / 2:
//          X[k] = E + W_N1^k O,   X[M-k] = conj(E - W_N1^k O),
//      written back in place in shared memory.  A block's RB rows are
//      RB K1 consecutive floats of yr and of yi, 16-byte aligned (RB is a
//      multiple of 4), so the block stores them with float4 stores (scalar
//      stores where an output is not 16-byte aligned).  The length-M FFT
//      takes its twiddles W_M^m from tw1[2m] (staged in shared memory per
//      pass), the post-pass from tw1[k].  Any other even N1 takes a direct
//      DFT against the twiddle table (`dft_rows_r2c`).
//   2. columns (axis 0), `fft_cols_pow2`, in place on yr, yi: one block
//      per strip of 32 consecutive columns of the flattened (plane,
//      column) index, so no strip is ragged but the last, and a warp reads
//      128 bytes of a row; the strips run in reverse order, so the first
//      blocks find the planes the row pass wrote last still in L2.  Each
//      column's threads hold 32 points each (N0 = 512: 32 x 16) or 16
//      (128 = 16 x 8, 256 = 16 x 16) and run the same register Stockham
//      passes, the first reading device memory and the last writing it:
//      one exchange through shared memory, laid out [row][column] so that
//      each half-warp touches 16 consecutive columns, with no bank
//      conflicts and no padding.
// The inverse transform, for a power-of-two N1, mirrors the forward:
//   1. columns (axis 0), `fft_cols_pow2` with sign +1, from the input into
//      a scratch array: the input is either a planar pair or one complex64
//      array (interleaved real and imaginary parts, one float2 load a
//      point), so the dispatch hands a complex spectrum over without a
//      copy; the scratch is one interleaved complex array.
//   2. rows (axis 1), `fft_rows_c2r_pow2`: a block's RB rows, RB K1
//      consecutive complex values of the scratch, come into shared memory
//      in the padded row layout with 16-byte loads.  The pre-pass, one
//      pair (k, M - k) per thread, k = 0..M/2, drops the imaginary parts
//      of bins 0 and M (the input need not be Hermitian) and forms, with
//      E = (X[k] + conj X[M-k]) / 2 and O = W_N1^-k (X[k] - conj X[M-k]) / 2,
//          Z[k] = E + i O,   Z[M-k] = conj E + i conj O,
//      in place.  The length-M inverse complex FFT of Z runs in registers
//      as the forward's does (sign +1, the staged twiddles conjugated), and
//      its last pass writes each point z[n] as one float2 (x[2n],
//      x[2n+1]) times the scale 2 / (N0 N1): coalesced, with no shared
//      memory round trip.  The rows run in block order: the column pass
//      wrote the first planes last, so they are read back from L2 first.
// Any other even N1 takes a direct c2r sum per output point
// (`dft_rows_c2r`).
// The intermediate of either transform makes one round trip through
// device memory (or L2).  Blocks that need more than 48 KB of shared
// memory are allowed it with cudaFuncSetAttribute before their launch; the
// launch functions return cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block of the row passes
constexpr int ROW_ELEMS = 2048;   // row elements per block, DFT rows
constexpr int RMAX = 16;          // points per thread, row passes
constexpr int CS = 32;            // columns per strip of the column pass

// ---------------------------------------------------------------------------
// Register FFT building blocks

__host__ __device__ constexpr int log2c(int n) {
  return n <= 1 ? 0 : 1 + log2c(n >> 1);
}

__host__ __device__ constexpr int brevc(int u, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((u >> b) & 1) << (bits - 1 - b);
  return r;
}

// cos(2 pi k / 32) for any k
__host__ __device__ constexpr float cos32(int k) {
  switch (k & 31) {
    case 0: return 1.f;
    case 8: case 24: return 0.f;
    case 16: return -1.f;
    case 1: case 31: return 0.98078528040323043f;
    case 15: case 17: return -0.98078528040323043f;
    case 2: case 30: return 0.92387953251128674f;
    case 14: case 18: return -0.92387953251128674f;
    case 3: case 29: return 0.83146961230254524f;
    case 13: case 19: return -0.83146961230254524f;
    case 4: case 28: return 0.70710678118654757f;
    case 12: case 20: return -0.70710678118654757f;
    case 5: case 27: return 0.55557023301960229f;
    case 11: case 21: return -0.55557023301960229f;
    case 6: case 26: return 0.38268343236508984f;
    case 10: case 22: return -0.38268343236508984f;
    case 7: case 25: return 0.19509032201612833f;
    case 9: case 23: return -0.19509032201612833f;
    default: return 0.f;
  }
}

__host__ __device__ constexpr float sin32(int k) { return cos32(k + 24); }

// index of a float2 in a padded shared-memory row: one pad in 16
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a * exp(SIGN 2 pi i t / n), n dividing 32; t and n are constants once
// the loops around the call are unrolled, so the branch folds away
template <int SIGN>
__device__ __forceinline__ float2 mulw(float2 a, int t, int n) {
  const int k = (t * (32 / n)) & 31;
  if (k == 0) return a;
  if (k == 16) return make_float2(-a.x, -a.y);
  if (k == 8) return make_float2(-SIGN * a.y, SIGN * a.x);
  if (k == 24) return make_float2(SIGN * a.y, -SIGN * a.x);
  const float c = cos32(k), s = SIGN * sin32(k);
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// In-register DFT of length RP (a power of two up to 32) with the kernel
// exp(SIGN 2 pi i / RP), radix-2 decimation in frequency, stage by stage:
// the result for frequency u is left in a[brevc(u, log2 RP)].
template <int RP, int HALF, int SIGN>
__device__ __forceinline__ void dif_stages(float2 (&a)[RP]) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int s = 0; s < RP; s += 2 * HALF) {
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const float2 x = a[s + t], y = a[s + t + HALF];
        a[s + t] = cadd(x, y);
        a[s + t + HALF] = mulw<SIGN>(csub(x, y), t, 2 * HALF);
      }
    }
    dif_stages<RP, HALF / 2, SIGN>(a);
  }
}

// the integers 0 .. N-1 as a type, Ints<0, ..., N-1>
template <int... U>
struct Ints {};
template <int N, int... U>
struct MakeInts : MakeInts<N - 1, N - 1, U...> {};
template <int... U>
struct MakeInts<0, U...> {
  using type = Ints<U...>;
};

// v[q + U Q] = a[brevc(U)] for each U: the DFT's outputs in natural order
template <int Q, int RP, int R, int... U>
__device__ __forceinline__ void put_natural(float2 (&v)[R], int q,
                                            const float2 (&a)[RP],
                                            Ints<U...>) {
  ((v[q + U * Q] = a[brevc(U, log2c(RP))]), ...);
}

// Pass P of a length-2^L Stockham FFT in which each of T = 2^L / R
// threads holds R points: every pass but the last has radix R, the last
// the remaining factor.
template <int L, int R, int P>
struct Pass {
  static constexpr int LR = log2c(R);
  static constexpr int COUNT = L == 0 ? 0 : (L + LR - 1) / LR;
  static constexpr int NS = 1 << (P * LR);           // span done so far
  static constexpr int RP = 1 << (L - P * LR < LR ? L - P * LR : LR);
  static constexpr bool LAST = P + 1 == COUNT;
};

// One Stockham pass, in place on the thread's points.  Before it,
// v[q + u Q] (Q = R / RP) is input u of the thread's butterfly
// b = j + q T, the point data[b + u M / RP] of the sequence; each input
// u > 0 is multiplied by W_{NS RP}^{k u}, k = b mod NS, from `twf(k, u)`.
// After it, v[q + u Q] is output u of that butterfly, which
// `store_pass` puts at (b / NS) NS RP + k + u NS.
template <int R, int RP, int NS, int T, int SIGN, class TwF>
__device__ __forceinline__ void stockham_pass(float2 (&v)[R], int j,
                                              TwF twf) {
  constexpr int Q = R / RP;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float2 a[RP];
#pragma unroll
    for (int u = 0; u < RP; ++u) a[u] = v[q + u * Q];
    if constexpr (NS > 1) {
      const int k = (j + q * T) & (NS - 1);
#pragma unroll
      for (int u = 1; u < RP; ++u) a[u] = cmul(a[u], twf(k, u));
    }
    dif_stages<RP, RP / 2, SIGN>(a);
    put_natural<Q>(v, q, a, typename MakeInts<RP>::type{});
  }
}

template <int R, int RP, int NS, int T, class WrF>
__device__ __forceinline__ void store_pass(const float2 (&v)[R], int j,
                                           WrF wr) {
  constexpr int Q = R / RP;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int b = j + q * T;
    const int k = b & (NS - 1);
    const int base = (b - k) * RP + k;
#pragma unroll
    for (int u = 0; u < RP; ++u) wr(base + u * NS, v[q + u * Q]);
  }
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// complex element i of an interleaved array re (IL) or of the planar
// pair (re, im)
template <bool IL>
__device__ __forceinline__ float2 load_c(const float* re, const float* im,
                                         int64_t i) {
  if constexpr (IL) {
    return reinterpret_cast<const float2*>(re)[i];
  } else {
    return make_float2(re[i], im[i]);
  }
}

template <bool IL>
__device__ __forceinline__ void store_c(float* re, float* im, int64_t i,
                                        float2 v) {
  if constexpr (IL) {
    reinterpret_cast<float2*>(re)[i] = v;
  } else {
    re[i] = v.x;
    im[i] = v.y;
  }
}

// ---------------------------------------------------------------------------
// Row passes, power-of-two N1 = 2^(L+1): real data packed as M = N1/2
// complex points

template <int L>
struct RowCfg {
  static constexpr int M = 1 << L;                   // complex points
  static constexpr int N1 = 2 * M;
  static constexpr int K1 = M + 1;
  static constexpr int R = M < RMAX ? M : RMAX;      // points per thread
  static constexpr int T = M / R;                    // threads per row
  static constexpr int RB = NT / T;                  // rows per block
  // padded row stride, with a spare slot for X[M] at pad(M); a multiple
  // of 16 float2 past pad(M) keeps the exchanges free of bank conflicts
  static constexpr int S = L >= 5 ? pad(M) + 16 : L == 4 ? 19 : M + 1;
  static constexpr int G = T <= 32 ? 32 : NT;        // threads sharing rows
  static constexpr int RG = G / T;                   // rows per such group
  static constexpr int COUNT = Pass<L, R, 0>::COUNT;
};

// offset of pass P's twiddles in the shared table: pass p > 0 holds
// W_{NS RP}^{k u} at (u - 1) NS + k
template <int L, int P>
__host__ __device__ constexpr int tw_offset() {
  if constexpr (P <= 1) {
    return 0;
  } else {
    using Pp = Pass<L, RowCfg<L>::R, P - 1>;
    return tw_offset<L, P - 1>() + Pp::NS * (Pp::RP - 1);
  }
}

// entries of the whole table
template <int L>
__host__ __device__ constexpr int tw_entries() {
  return tw_offset<L, RowCfg<L>::COUNT>();
}

// the length-M FFT's twiddles W_M^m of kernel exp(SIGN 2 pi i / M), staged
template <int L, int SIGN, int P>
__device__ __forceinline__ void row_twiddles(float2* twp, const float* tw) {
  using C = RowCfg<L>;
  if constexpr (P < C::COUNT) {
    if constexpr (P > 0) {
      using Pp = Pass<L, C::R, P>;
      constexpr int n = Pp::NS * (Pp::RP - 1);
      constexpr int step = C::M / (Pp::NS * Pp::RP);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int u = e / Pp::NS + 1, k = e % Pp::NS;
        const int m = 2 * k * u * step;               // W_M^(k u step)
        twp[tw_offset<L, P>() + e] =
            make_float2(tw[m], SIGN * tw[C::N1 + m]);
      }
    }
    row_twiddles<L, SIGN, P + 1>(twp, tw);
  }
}

// The length-M FFT of a row from its points v (point j + T i in v[i]):
// every pass but the last exchanges through the row zs of shared memory,
// the last hands output point idx to `out(idx, value)`.
template <int L, int SIGN, int P, class OutF>
__device__ __forceinline__ void row_passes(float2 (&v)[RowCfg<L>::R],
                                           float2* zs, const float2* twp,
                                           int j, OutF out) {
  using C = RowCfg<L>;
  if constexpr (P < C::COUNT) {
    using Pp = Pass<L, C::R, P>;
    if constexpr (P > 0) {
      group_sync<C::G>();
#pragma unroll
      for (int i = 0; i < C::R; ++i) v[i] = zs[pad(j + C::T * i)];
      group_sync<C::G>();
    }
    const float2* t = twp + tw_offset<L, P>();
    stockham_pass<C::R, Pp::RP, Pp::NS, C::T, SIGN>(
        v, j, [=](int k, int u) { return t[(u - 1) * Pp::NS + k]; });
    if constexpr (Pp::LAST) {
      store_pass<C::R, Pp::RP, Pp::NS, C::T>(v, j, out);
    } else {
      store_pass<C::R, Pp::RP, Pp::NS, C::T>(
          v, j, [=](int idx, float2 val) { zs[pad(idx)] = val; });
      row_passes<L, SIGN, P + 1>(v, zs, twp, j, out);
    }
  }
}

// The fused drivers' device loop (sporco_tpu_torch/ops/device_loop.py)
// launches the transforms of an iteration that may be dead (run after
// convergence, inside a replayed CUDA graph).  `gate` (null: always live)
// is the loop's flag `live` in device memory: every block reads it first
// and returns before any write where it is 0.  `cnt` (null: not counted)
// is the loop's int32 launch counter, which the last kernel of a live
// launch advances by 1.
__device__ __forceinline__ bool gate_dead(const float* gate) {
  return gate != nullptr && __ldg(gate) == 0.f;
}

__device__ __forceinline__ void gate_count(int* cnt) {
  if (cnt != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *cnt += 1;
}

// rows of shared memory in the padded layout: element e of a block's
// RB K1 consecutive values is row e / K1, bin e mod K1
template <int L>
__device__ __forceinline__ float2& row_slot(float2* smem, int e) {
  using C = RowCfg<L>;
  const int r = e / C::K1;
  return smem[r * C::S + pad(e - r * C::K1)];
}

template <int L>
__global__ void __launch_bounds__(NT)
fft_rows_r2c_pow2(const float* __restrict__ x, float* __restrict__ yr,
                  float* __restrict__ yi, const float* __restrict__ tw,
                  int64_t rows, const float* __restrict__ gate) {
  if (gate_dead(gate)) return;
  using C = RowCfg<L>;
  extern __shared__ float2 smem2[];
  float2* twp = smem2 + C::RB * C::S;
  row_twiddles<L, -1, 0>(twp, tw);
  const int rl = threadIdx.x / C::T, j = threadIdx.x % C::T;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * C::RB;
  const int64_t row = row0 + rl;
  float2 v[C::R];
  if (row < rows) {
    const float* xr = x + row * C::N1 + 2 * j;
    if ((reinterpret_cast<uintptr_t>(x) & 7) == 0) {
#pragma unroll
      for (int i = 0; i < C::R; ++i)
        v[i] = __ldg(reinterpret_cast<const float2*>(xr + 2 * C::T * i));
    } else {
#pragma unroll
      for (int i = 0; i < C::R; ++i)
        v[i] = make_float2(__ldg(xr + 2 * C::T * i),
                           __ldg(xr + 2 * C::T * i + 1));
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::R; ++i) v[i] = make_float2(0.f, 0.f);
  }
  float2* zs = smem2 + rl * C::S;
  __syncthreads();                                    // the twiddle table
  if constexpr (C::COUNT == 0) {
    zs[0] = v[0];
  } else {
    row_passes<L, -1, 0>(v, zs, twp, j,
                         [=](int idx, float2 val) { zs[pad(idx)] = val; });
  }
  group_sync<C::G>();
  // post-pass: the group's rows, one (k, M - k) pair per thread, in
  // place: X[k] and X[M - k] replace Z[k] and Z[M - k], X[M] goes to the
  // row's spare slot pad(M)
  constexpr int P2 = C::M / 2 + 1;
  const int gl = threadIdx.x % C::G, gi = threadIdx.x / C::G;
  float2* gz = smem2 + gi * C::RG * C::S;
  for (int f = gl; f < C::RG * P2; f += C::G) {
    const int r = f / P2, k = f - r * P2;
    float2* zr = gz + r * C::S;
    const float2 zk = zr[pad(k & (C::M - 1))];
    const float2 zm = zr[pad((C::M - k) & (C::M - 1))];
    const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
    const float ox = 0.5f * (zk.y + zm.y), oy = 0.5f * (zm.x - zk.x);
    const float c = __ldg(tw + k), s = __ldg(tw + C::N1 + k);
    const float wx = c * ox + s * oy, wy = c * oy - s * ox;   // W_N1^k O
    zr[pad(k)] = make_float2(ex + wx, ey + wy);
    if (2 * k != C::M) zr[pad(C::M - k)] = make_float2(ex - wx, wy - ey);
  }
  __syncthreads();
  // the block's rows are RB K1 consecutive floats of yr and of yi: float4
  // stores where both start 16-byte aligned (K1 odd, RB a multiple of 4)
  const int nr = static_cast<int>(
      min(static_cast<int64_t>(C::RB), rows - row0));
  const int n = nr * C::K1;
  float* oyr = yr + row0 * C::K1;
  float* oyi = yi + row0 * C::K1;
  auto at = [&](int e) { return row_slot<L>(smem2, e); };
  int e0 = 0;
  if (((reinterpret_cast<uintptr_t>(oyr) | reinterpret_cast<uintptr_t>(oyi))
       & 15) == 0) {
    for (int q = threadIdx.x; q < n / 4; q += NT) {
      const float2 a = at(4 * q), b = at(4 * q + 1), c = at(4 * q + 2),
                   d = at(4 * q + 3);
      reinterpret_cast<float4*>(oyr)[q] = make_float4(a.x, b.x, c.x, d.x);
      reinterpret_cast<float4*>(oyi)[q] = make_float4(a.y, b.y, c.y, d.y);
    }
    e0 = n / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += NT) {
    const float2 a = at(e);
    oyr[e] = a.x;
    oyi[e] = a.y;
  }
}

// Inverse row pass: the interleaved half-spectrum rows s of the column
// pass -> real rows x, times `scale`.
template <int L>
__global__ void __launch_bounds__(NT)
fft_rows_c2r_pow2(const float* __restrict__ s, float* __restrict__ x,
                  const float* __restrict__ tw, int64_t rows, float scale,
                  const float* __restrict__ gate, int* __restrict__ cnt) {
  if (gate_dead(gate)) return;
  gate_count(cnt);
  using C = RowCfg<L>;
  extern __shared__ float2 smem2[];
  float2* twp = smem2 + C::RB * C::S;
  row_twiddles<L, 1, 0>(twp, tw);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * C::RB;
  // the block's rows are RB K1 consecutive complex values: 16-byte loads
  // where aligned (a row of the last block past `rows` is left unset; its
  // results are not stored)
  const int nr = static_cast<int>(
      min(static_cast<int64_t>(C::RB), rows - row0));
  const int n = nr * C::K1;
  const float* src = s + 2 * row0 * C::K1;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int q = threadIdx.x; q < n / 2; q += NT) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src) + q);
      row_slot<L>(smem2, 2 * q) = make_float2(a.x, a.y);
      row_slot<L>(smem2, 2 * q + 1) = make_float2(a.z, a.w);
    }
    e0 = n / 2 * 2;
  }
  for (int e = e0 + threadIdx.x; e < n; e += NT)
    row_slot<L>(smem2, e) = make_float2(__ldg(src + 2 * e),
                                        __ldg(src + 2 * e + 1));
  __syncthreads();                        // the rows and the twiddle table
  // pre-pass: the group's rows, one (k, M - k) pair per thread, in place:
  // Z[k] and Z[M - k] replace X[k] and X[M - k] (X[M] is read from the
  // row's spare slot pad(M) and not replaced)
  constexpr int P2 = C::M / 2 + 1;
  const int gl = threadIdx.x % C::G, gi = threadIdx.x / C::G;
  float2* gz = smem2 + gi * C::RG * C::S;
  for (int f = gl; f < C::RG * P2; f += C::G) {
    const int r = f / P2, k = f - r * P2;
    float2* zr = gz + r * C::S;
    float2 xk = zr[pad(k)];
    float2 xm = zr[pad(C::M - k)];
    if (k == 0) {                          // bins 0 and M: real parts only
      xk.y = 0.f;
      xm.y = 0.f;
    }
    const float ex = 0.5f * (xk.x + xm.x), ey = 0.5f * (xk.y - xm.y);
    const float dx = 0.5f * (xk.x - xm.x), dy = 0.5f * (xk.y + xm.y);
    const float c = __ldg(tw + k), sn = __ldg(tw + C::N1 + k);
    const float ox = c * dx - sn * dy, oy = c * dy + sn * dx;  // W_N1^-k D
    zr[pad(k)] = make_float2(ex - oy, ey + ox);
    if (k != 0 && 2 * k != C::M)
      zr[pad(C::M - k)] = make_float2(ex + oy, ox - ey);
  }
  group_sync<C::G>();
  const int rl = threadIdx.x / C::T, j = threadIdx.x % C::T;
  const int64_t row = row0 + rl;
  float2* zs = smem2 + rl * C::S;
  float2 v[C::R];
#pragma unroll
  for (int i = 0; i < C::R; ++i) v[i] = zs[pad(j + C::T * i)];
  // z[idx] = x[2 idx] + i x[2 idx + 1]: one float2 store a point
  float2* xo = reinterpret_cast<float2*>(x + row * C::N1);
  const bool live = row < rows;
  auto out = [=](int idx, float2 val) {
    if (live) xo[idx] = make_float2(val.x * scale, val.y * scale);
  };
  if constexpr (C::COUNT == 0) {
    out(0, v[0]);
  } else {
    group_sync<C::G>();                    // the loads, before pass 0 stores
    row_passes<L, 1, 0>(v, zs, twp, j, out);
  }
}

// ---------------------------------------------------------------------------
// Column pass (axis 0), N0 = 2^L0: c2c with the kernel exp(SIGN 2 pi i /
// N0), from (in_r, in_i) into (out_r, out_i), in place when they are the
// same; an interleaved complex array (IN_IL, OUT_IL) is passed as its
// first pointer, the second unused.  ncols = B K1 columns of the
// flattened (plane, column) index.

template <int L0>
struct ColCfg {
  static constexpr int N0 = 1 << L0;
  static constexpr int R = L0 >= 9 ? 32 : 16;        // points per thread
  static constexpr int T = N0 / R;                   // threads per column
  static constexpr int NTC = CS * T;                 // threads per block
  static constexpr int COUNT = Pass<L0, R, 0>::COUNT;
};

template <int L0, int SIGN, bool OUT_IL, int P>
__device__ __forceinline__ void col_passes(float2 (&v)[ColCfg<L0>::R], float2* sm,
                                           const float* tw, int j, int c,
                                           float* out_r, float* out_i,
                                           int64_t base, int k1, bool live) {
  using C = ColCfg<L0>;
  using Pp = Pass<L0, C::R, P>;
  if constexpr (P > 0) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::R; ++i) v[i] = sm[(j + C::T * i) * CS + c];
    if constexpr (!Pp::LAST) __syncthreads();
  }
  constexpr int step = C::N0 / (Pp::NS * Pp::RP);
  stockham_pass<C::R, Pp::RP, Pp::NS, C::T, SIGN>(
      v, j, [=](int k, int u) {
        const int m = k * u * step;                   // W_N0^m
        return make_float2(__ldg(tw + m), SIGN * __ldg(tw + C::N0 + m));
      });
  if constexpr (Pp::LAST) {
    if (live) {
      store_pass<C::R, Pp::RP, Pp::NS, C::T>(
          v, j, [=](int idx, float2 val) {
            store_c<OUT_IL>(out_r, out_i,
                            base + static_cast<int64_t>(idx) * k1, val);
          });
    }
  } else {
    store_pass<C::R, Pp::RP, Pp::NS, C::T>(
        v, j, [=](int idx, float2 val) { sm[idx * CS + c] = val; });
    col_passes<L0, SIGN, OUT_IL, P + 1>(v, sm, tw, j, c, out_r, out_i, base,
                                        k1, live);
  }
}

template <int L0, int SIGN, bool IN_IL, bool OUT_IL>
__global__ void __launch_bounds__(ColCfg<L0>::NTC)
fft_cols_pow2(const float* in_r, const float* in_i, float* out_r,
              float* out_i, const float* __restrict__ tw, int64_t ncols,
              int k1, const float* __restrict__ gate, int* __restrict__ cnt) {
  if (gate_dead(gate)) return;
  gate_count(cnt);
  using C = ColCfg<L0>;
  extern __shared__ float2 smem2[];
  const int c = threadIdx.x % CS, j = threadIdx.x / CS;
  // strips in reverse order: the forward's row pass wrote the last planes
  // last, so they are the ones still in L2
  const int64_t g = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * CS + c;
  const bool live = g < ncols;
  const int64_t plane = g / k1;
  const int64_t base = plane * C::N0 * k1 + (g - plane * k1);
  float2 v[C::R];
  if (live) {
    const int64_t g0 = base + static_cast<int64_t>(j) * k1;
    const int64_t step = static_cast<int64_t>(C::T) * k1;
#pragma unroll
    for (int i = 0; i < C::R; ++i)
      v[i] = load_c<IN_IL>(in_r, in_i, g0 + i * step);
  } else {
#pragma unroll
    for (int i = 0; i < C::R; ++i) v[i] = make_float2(0.f, 0.f);
  }
  col_passes<L0, SIGN, OUT_IL, 0>(v, smem2, tw, j, c, out_r, out_i, base,
                                  k1, live);
}

// ---------------------------------------------------------------------------
// Row passes for any other even N1: direct sums against the twiddle table

__device__ __forceinline__ void load_twiddles(float* twc, float* tws,
                                              const float* tw, int n,
                                              int count) {
  for (int m = threadIdx.x; m < count; m += blockDim.x) {
    twc[m] = tw[m];
    tws[m] = tw[n + m];
  }
}

// Row pass, forward, any other even n1: a direct DFT per output bin.
__global__ void __launch_bounds__(NT)
dft_rows_r2c(const float* x, float* yr, float* yi, const float* tw,
             int64_t rows, int n1, int rb, const float* __restrict__ gate) {
  if (gate_dead(gate)) return;
  extern __shared__ float sm[];
  float* twc = sm;
  float* tws = twc + n1;
  float* xs = tws + n1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<int64_t>(rb), rows - row0));
  const int k1 = (n1 >> 1) + 1;
  load_twiddles(twc, tws, tw, n1, n1);
  for (int t = threadIdx.x; t < nr * n1; t += blockDim.x)
    xs[t] = x[row0 * n1 + t];
  __syncthreads();
  for (int t = threadIdx.x; t < nr * k1; t += blockDim.x) {
    const int r = t / k1, k = t % k1;
    const float* xr = xs + r * n1;
    float ar = 0.f, ai = 0.f;
    int m = 0;                              // (j k) mod n1
    for (int j = 0; j < n1; ++j) {
      const float v = xr[j];
      ar = fmaf(v, twc[m], ar);
      ai = fmaf(-v, tws[m], ai);
      m += k;
      if (m >= n1) m -= n1;
    }
    const int64_t g = (row0 + r) * k1 + k;
    yr[g] = ar;
    yi[g] = ai;
  }
}

// Row pass, inverse, any other even n1: x[j] = scale * sum_k w_k
// (Zr_k cos(2 pi k j / n1) - Zi_k sin(2 pi k j / n1)), w = 1, 2, ..., 2, 1,
// from the interleaved scratch z.
__global__ void __launch_bounds__(NT)
dft_rows_c2r(const float* z, float* x, const float* tw, int64_t rows, int n1,
             int rb, float scale, const float* __restrict__ gate,
             int* __restrict__ cnt) {
  if (gate_dead(gate)) return;
  gate_count(cnt);
  extern __shared__ float sm[];
  float* twc = sm;
  float* tws = twc + n1;
  const int half = n1 >> 1;
  const int k1 = half + 1;
  float* sr = tws + n1;
  float* si = sr + rb * k1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<int64_t>(rb), rows - row0));
  load_twiddles(twc, tws, tw, n1, n1);
  for (int t = threadIdx.x; t < nr * k1; t += blockDim.x) {
    const int k = t % k1;
    const bool edge = k == 0 || k == half;
    const float w = edge ? 1.f : 2.f;
    const float2 v = reinterpret_cast<const float2*>(z)[row0 * k1 + t];
    sr[t] = w * v.x;
    si[t] = edge ? 0.f : w * v.y;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nr * n1; t += blockDim.x) {
    const int r = t / n1, j = t % n1;
    const float* ar = sr + r * k1;
    const float* ai = si + r * k1;
    float acc = 0.f;
    int m = 0;                              // (k j) mod n1
    for (int k = 0; k < k1; ++k) {
      acc = fmaf(ar[k], twc[m], acc);
      acc = fmaf(-ai[k], tws[m], acc);
      m += j;
      if (m >= n1) m -= n1;
    }
    x[row0 * n1 + t] = acc * scale;
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

bool shape_ok(int64_t B, int n0, int n1) {
  return B > 0 && pow2(n0) && n0 >= 128 && n0 <= 512 && n1 >= 2
         && n1 <= 2048 && n1 % 2 == 0;
}

int rows_per_block(int n1) { return n1 >= ROW_ELEMS ? 1 : ROW_ELEMS / n1; }

unsigned row_blocks(int64_t rows, int rb) {
  return static_cast<unsigned>((rows + rb - 1) / rb);
}

// Allow `kernel` `smem` bytes of dynamic shared memory (needed above
// 48 KB), then launch it.
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), unsigned grid, int block,
                   size_t smem, cudaStream_t st, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, st>>>(args...);
  return cudaGetLastError();
}

// Call f(RowLog<L>{}) for the L of a power-of-two n1 = 2^(L+1), 2..2048.
template <int L>
struct RowLog {
  static constexpr int value = L;
};

template <int L = 0, class F>
cudaError_t with_row_log(int n1, F f) {
  if constexpr (L > 10) {
    return cudaErrorInvalidValue;
  } else {
    return n1 == 2 << L ? f(RowLog<L>{}) : with_row_log<L + 1>(n1, f);
  }
}

cudaError_t rows_r2c_pow2(const float* x, float* yr, float* yi,
                          const float* tw1, int64_t rows, int n1,
                          const float* gate, cudaStream_t st) {
  return with_row_log(n1, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    using C = RowCfg<L>;
    const size_t smem = sizeof(float2) * (C::RB * C::S + tw_entries<L>());
    return launch(fft_rows_r2c_pow2<L>, row_blocks(rows, C::RB), NT, smem,
                  st, x, yr, yi, tw1, rows, gate);
  });
}

cudaError_t rows_c2r_pow2(const float* s, float* x, const float* tw1,
                          int64_t rows, int n1, float scale,
                          const float* gate, int* cnt, cudaStream_t st) {
  return with_row_log(n1, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    using C = RowCfg<L>;
    const size_t smem = sizeof(float2) * (C::RB * C::S + tw_entries<L>());
    return launch(fft_rows_c2r_pow2<L>, row_blocks(rows, C::RB), NT, smem,
                  st, s, x, tw1, rows, scale, gate, cnt);
  });
}

template <int L0, int SIGN, bool IN_IL, bool OUT_IL>
cudaError_t launch_cols_t(const float* in_r, const float* in_i, float* out_r,
                          float* out_i, const float* tw0, int64_t ncols,
                          int k1, const float* gate, int* cnt,
                          cudaStream_t st) {
  using C = ColCfg<L0>;
  const size_t smem = sizeof(float2) * C::N0 * CS;
  const unsigned grid = static_cast<unsigned>((ncols + CS - 1) / CS);
  return launch(fft_cols_pow2<L0, SIGN, IN_IL, OUT_IL>, grid, C::NTC, smem,
                st, in_r, in_i, out_r, out_i, tw0, ncols, k1, gate, cnt);
}

template <int SIGN, bool IN_IL, bool OUT_IL>
cudaError_t launch_cols(const float* in_r, const float* in_i, float* out_r,
                        float* out_i, const float* tw0, int64_t B, int n0,
                        int k1, const float* gate, int* cnt,
                        cudaStream_t st) {
  const int64_t ncols = B * k1;
  switch (n0) {
    case 128:
      return launch_cols_t<7, SIGN, IN_IL, OUT_IL>(
          in_r, in_i, out_r, out_i, tw0, ncols, k1, gate, cnt, st);
    case 256:
      return launch_cols_t<8, SIGN, IN_IL, OUT_IL>(
          in_r, in_i, out_r, out_i, tw0, ncols, k1, gate, cnt, st);
    case 512:
      return launch_cols_t<9, SIGN, IN_IL, OUT_IL>(
          in_r, in_i, out_r, out_i, tw0, ncols, k1, gate, cnt, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The inverse from the planar pair (yr, yi) or, IN_IL, the interleaved
// complex array yr, through the scratch s of 2 B n0 (n1/2+1) floats.
template <bool IN_IL>
int irfft2(const float* yr, const float* yi, float* x, float* s,
           const float* tw0, const float* tw1, int64_t B, int n0, int n1,
           const float* gate, int* cnt, void* stream) {
  if (!shape_ok(B, n0, n1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k1 = n1 / 2 + 1;
  const int64_t rows = B * n0;
  cudaError_t err = launch_cols<1, IN_IL, true>(yr, yi, s, nullptr, tw0, B,
                                                n0, k1, gate, nullptr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / (static_cast<double>(n0) * n1));
  if (pow2(n1)) {
    // the packed half-length transform is unnormalised: twice the scale
    return static_cast<int>(
        rows_c2r_pow2(s, x, tw1, rows, n1, 2.f * scale, gate, cnt, st));
  }
  const int rb = rows_per_block(n1);
  const size_t smem =
      sizeof(float) * (2 * n1 + 2 * static_cast<size_t>(rb) * k1);
  dft_rows_c2r<<<row_blocks(rows, rb), NT, smem, st>>>(s, x, tw1, rows, n1,
                                                      rb, scale, gate, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, n0, n1) -> yr, yi (B, n0, n1/2+1); tw0 (2, n0), tw1 (2, n1).
// Each launch takes the device loop's `gate` and `cnt` (both may be null;
// see gate_dead).
int rfft2_planar_launch(const float* x, float* yr, float* yi,
                        const float* tw0, const float* tw1, int64_t B,
                        int n0, int n1, const float* gate, int* cnt,
                        void* stream) {
  if (!shape_ok(B, n0, n1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = B * n0;
  cudaError_t err;
  if (pow2(n1)) {
    err = rows_r2c_pow2(x, yr, yi, tw1, rows, n1, gate, st);
  } else {
    const int rb = rows_per_block(n1);
    const size_t smem = sizeof(float) * (2 * n1 + static_cast<size_t>(rb) * n1);
    dft_rows_r2c<<<row_blocks(rows, rb), NT, smem, st>>>(x, yr, yi, tw1,
                                                         rows, n1, rb, gate);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cols<-1, false, false>(
      yr, yi, yr, yi, tw0, B, n0, n1 / 2 + 1, gate, cnt, st));
}

// yr, yi (B, n0, n1/2+1) -> x (B, n0, n1), through the scratch s of
// 2 B n0 (n1/2+1) floats; the inputs are not modified.
int irfft2_planar_launch(const float* yr, const float* yi, float* x,
                         float* s, const float* tw0, const float* tw1,
                         int64_t B, int n0, int n1, const float* gate,
                         int* cnt, void* stream) {
  return irfft2<false>(yr, yi, x, s, tw0, tw1, B, n0, n1, gate, cnt, stream);
}

// The same from one complex64 array y (B, n0, n1/2+1) of interleaved real
// and imaginary parts, 8-byte aligned.
int irfft2_spectrum_launch(const float* y, float* x, float* s,
                           const float* tw0, const float* tw1, int64_t B,
                           int n0, int n1, const float* gate, int* cnt,
                           void* stream) {
  if (reinterpret_cast<uintptr_t>(y) & 7)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return irfft2<true>(y, nullptr, x, s, tw0, tw1, B, n0, n1, gate, cnt,
                      stream);
}

}  // extern "C"
