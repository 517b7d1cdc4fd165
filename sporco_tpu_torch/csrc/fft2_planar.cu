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
//                     (the input need not be Hermitian).
//
// Shapes: N0 in {128, 256, 512} (a power of two), N1 even, 2 <= N1 <= 2048;
// the caller flattens lead dimensions into B.  The twiddle tables are built
// on the host in float64 and passed in as float32 (2, N): cos(2 pi k / N)
// in the first row, sin(2 pi k / N) in the second.  Everything is fp32.
//
// What bounds it.  At the ConvBPDN x-step's size (B = 64 planes of
// 512 x 512) each transform must read 67.1 MB and write 67.4 MB (or the
// reverse): 0.040 ms at 3.35 TB/s.  Its arithmetic, about 5 N log2 N
// operations per complex point, is under 2 GFLOP: 0.03 ms at 67 TFLOP/s.
// The transform is bound by memory traffic.
//
// Design (simple first).  The TPU kernel splits the 128-point DFTs into
// MXU matmuls around a radix-R Cooley-Tukey split; that structure is the
// MXU's.  Here two passes run through shared memory:
//   1. rows (axis 1): one block per group of rows.  A power-of-two N1 is
//      loaded as a complex sequence (imaginary part 0) in bit-reversed
//      order and transformed by an in-place radix-2 FFT; the first K1 bins
//      are stored.  Any other even N1 takes a direct DFT against the
//      twiddle table indexed by (j k) mod N1.
//   2. columns (axis 0): one block per strip of COLS columns of one plane,
//      an in-place radix-2 FFT of length N0 for each column.
// The forward pass writes the row spectra into the outputs and transforms
// the columns in place; the inverse runs the columns into a scratch pair,
// then the rows: the Hermitian extension of each row (imaginary parts of
// bins 0 and N1/2 set to 0) through an inverse complex FFT, or a direct
// c2r sum with the weights 1, 2, ..., 2, 1, scaled by 1/(N0 N1).
// The intermediate makes one round trip through device memory, about
// twice the bound's traffic; keeping it on chip and the half-length
// real-FFT packing are later work.  The launch functions return
// cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int COLS = 8;           // columns per block of the column pass
constexpr int ROW_ELEMS = 2048;   // row elements per block of the row pass

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// In-place radix-2 decimation-in-time FFT of `nseq` sequences of length
// n = 2^logn held in shared memory in bit-reversed order: element e of
// sequence q is at q*ss + e*es.  twc/tws hold cos/sin(2 pi m / n) for
// m < n/2; sign is -1 for the forward and +1 for the inverse transform.
// SEQ_FAST maps neighbouring threads to neighbouring sequences (the
// column layout), else to neighbouring butterflies of one sequence.
template <bool SEQ_FAST>
__device__ void smem_fft(float* re, float* im, int n, int logn, int nseq,
                         int ss, int es, const float* twc, const float* tws,
                         float sign) {
  const int nb = n >> 1;
  const int total = nseq * nb;
  for (int s = 0; s < logn; ++s) {
    const int h = 1 << s;
    const int tsh = logn - 1 - s;          // W_n^(j n / 2h)
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int q = SEQ_FAST ? t % nseq : t / nb;
      const int b = SEQ_FAST ? t / nseq : t % nb;
      const int j = b & (h - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const int p0 = q * ss + i0 * es;
      const int p1 = p0 + h * es;
      const int m = j << tsh;
      const float wr = twc[m], wi = sign * tws[m];
      const float xr = re[p1], xi = im[p1];
      const float vr = xr * wr - xi * wi;
      const float vi = xr * wi + xi * wr;
      const float ur = re[p0], ui = im[p0];
      re[p0] = ur + vr;
      im[p0] = ui + vi;
      re[p1] = ur - vr;
      im[p1] = ui - vi;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_twiddles(float* twc, float* tws,
                                              const float* tw, int n,
                                              int count) {
  for (int m = threadIdx.x; m < count; m += blockDim.x) {
    twc[m] = tw[m];
    tws[m] = tw[n + m];
  }
}

// Column pass: c2c of length n0 along axis 0 of (n0, k1) planes, from
// (in_r, in_i) into (out_r, out_i); in place when they are the same.
__global__ void __launch_bounds__(NT)
fft_cols(const float* in_r, const float* in_i, float* out_r, float* out_i,
         const float* tw, int n0, int logn0, int k1, float sign) {
  extern __shared__ float sm[];
  float* twc = sm;
  float* tws = twc + (n0 >> 1);
  float* re = tws + (n0 >> 1);
  float* im = re + n0 * COLS;
  const int strips = (k1 + COLS - 1) / COLS;
  const int64_t plane = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * COLS;
  const int nc = min(COLS, k1 - c0);
  const int64_t base = plane * n0 * k1 + c0;
  load_twiddles(twc, tws, tw, n0, n0 >> 1);
  for (int t = threadIdx.x; t < n0 * COLS; t += blockDim.x) {
    const int c = t % COLS, r = t / COLS;
    const int p = bitrev(r, logn0) * COLS + c;
    float vr = 0.f, vi = 0.f;
    if (c < nc) {
      const int64_t g = base + static_cast<int64_t>(r) * k1 + c;
      vr = in_r[g];
      vi = in_i[g];
    }
    re[p] = vr;
    im[p] = vi;
  }
  __syncthreads();
  smem_fft<true>(re, im, n0, logn0, COLS, 1, COLS, twc, tws, sign);
  for (int t = threadIdx.x; t < n0 * COLS; t += blockDim.x) {
    const int c = t % COLS, r = t / COLS;
    if (c < nc) {
      const int64_t g = base + static_cast<int64_t>(r) * k1 + c;
      out_r[g] = re[t];
      out_i[g] = im[t];
    }
  }
}

// Row pass, forward, power-of-two n1: rb rows per block.
__global__ void __launch_bounds__(NT)
fft_rows_r2c(const float* x, float* yr, float* yi, const float* tw,
             int64_t rows, int n1, int logn1, int rb) {
  extern __shared__ float sm[];
  float* twc = sm;
  float* tws = twc + (n1 >> 1);
  float* re = tws + (n1 >> 1);
  float* im = re + rb * n1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<int64_t>(rb), rows - row0));
  const int k1 = (n1 >> 1) + 1;
  load_twiddles(twc, tws, tw, n1, n1 >> 1);
  for (int t = threadIdx.x; t < rb * n1; t += blockDim.x) {
    const int r = t / n1, j = t % n1;
    const int p = r * n1 + bitrev(j, logn1);
    re[p] = r < nr ? x[(row0 + r) * n1 + j] : 0.f;
    im[p] = 0.f;
  }
  __syncthreads();
  smem_fft<false>(re, im, n1, logn1, rb, n1, 1, twc, tws, -1.f);
  for (int t = threadIdx.x; t < rb * k1; t += blockDim.x) {
    const int r = t / k1, k = t % k1;
    if (r < nr) {
      const int64_t g = (row0 + r) * k1 + k;
      yr[g] = re[r * n1 + k];
      yi[g] = im[r * n1 + k];
    }
  }
}

// Row pass, forward, any other even n1: a direct DFT per output bin.
__global__ void __launch_bounds__(NT)
dft_rows_r2c(const float* x, float* yr, float* yi, const float* tw,
             int64_t rows, int n1, int rb) {
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

// Row pass, inverse, power-of-two n1: the Hermitian extension of each
// half-spectrum row through an inverse complex FFT, real part scaled.
__global__ void __launch_bounds__(NT)
fft_rows_c2r(const float* zr, const float* zi, float* x, const float* tw,
             int64_t rows, int n1, int logn1, int rb, float scale) {
  extern __shared__ float sm[];
  float* twc = sm;
  float* tws = twc + (n1 >> 1);
  float* re = tws + (n1 >> 1);
  float* im = re + rb * n1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<int64_t>(rb), rows - row0));
  const int half = n1 >> 1;
  const int k1 = half + 1;
  load_twiddles(twc, tws, tw, n1, half);
  for (int t = threadIdx.x; t < rb * n1; t += blockDim.x) {
    const int r = t / n1, j = t % n1;
    float vr = 0.f, vi = 0.f;
    if (r < nr) {
      const int k = j <= half ? j : n1 - j;
      const int64_t g = (row0 + r) * k1 + k;
      vr = zr[g];
      vi = (k == 0 || k == half) ? 0.f : zi[g];
      if (j > half) vi = -vi;
    }
    const int p = r * n1 + bitrev(j, logn1);
    re[p] = vr;
    im[p] = vi;
  }
  __syncthreads();
  smem_fft<false>(re, im, n1, logn1, rb, n1, 1, twc, tws, 1.f);
  for (int t = threadIdx.x; t < nr * n1; t += blockDim.x)
    x[row0 * n1 + t] = re[t] * scale;
}

// Row pass, inverse, any other even n1: x[j] = scale * sum_k w_k
// (Zr_k cos(2 pi k j / n1) - Zi_k sin(2 pi k j / n1)), w = 1, 2, ..., 2, 1.
__global__ void __launch_bounds__(NT)
dft_rows_c2r(const float* zr, const float* zi, float* x, const float* tw,
             int64_t rows, int n1, int rb, float scale) {
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
    sr[t] = w * zr[row0 * k1 + t];
    si[t] = edge ? 0.f : w * zi[row0 * k1 + t];
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

cudaError_t launch_cols(const float* in_r, const float* in_i, float* out_r,
                        float* out_i, const float* tw0, int64_t B, int n0,
                        int k1, float sign, cudaStream_t st) {
  const int strips = (k1 + COLS - 1) / COLS;
  const size_t smem = sizeof(float) * (n0 + 2 * n0 * COLS);
  fft_cols<<<static_cast<unsigned>(B * strips), NT, smem, st>>>(
      in_r, in_i, out_r, out_i, tw0, n0, ilog2(n0), k1, sign);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, n0, n1) -> yr, yi (B, n0, n1/2+1); tw0 (2, n0), tw1 (2, n1).
int rfft2_planar_launch(const float* x, float* yr, float* yi,
                        const float* tw0, const float* tw1, int64_t B,
                        int n0, int n1, void* stream) {
  if (!shape_ok(B, n0, n1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = B * n0;
  const int rb = rows_per_block(n1);
  if (pow2(n1)) {
    const size_t smem = sizeof(float) * (n1 + 2 * static_cast<size_t>(rb) * n1);
    fft_rows_r2c<<<row_blocks(rows, rb), NT, smem, st>>>(
        x, yr, yi, tw1, rows, n1, ilog2(n1), rb);
  } else {
    const size_t smem = sizeof(float) * (2 * n1 + static_cast<size_t>(rb) * n1);
    dft_rows_r2c<<<row_blocks(rows, rb), NT, smem, st>>>(x, yr, yi, tw1,
                                                         rows, n1, rb);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_cols(yr, yi, yr, yi, tw0, B, n0, n1 / 2 + 1, -1.f, st));
}

// yr, yi (B, n0, n1/2+1) -> x (B, n0, n1), through the scratch pair sr, si
// of the input's shape; the inputs are not modified.
int irfft2_planar_launch(const float* yr, const float* yi, float* x,
                         float* sr, float* si, const float* tw0,
                         const float* tw1, int64_t B, int n0, int n1,
                         void* stream) {
  if (!shape_ok(B, n0, n1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k1 = n1 / 2 + 1;
  cudaError_t err = launch_cols(yr, yi, sr, si, tw0, B, n0, k1, 1.f, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = B * n0;
  const int rb = rows_per_block(n1);
  const float scale = static_cast<float>(1.0 / (static_cast<double>(n0) * n1));
  if (pow2(n1)) {
    const size_t smem = sizeof(float) * (n1 + 2 * static_cast<size_t>(rb) * n1);
    fft_rows_c2r<<<row_blocks(rows, rb), NT, smem, st>>>(
        sr, si, x, tw1, rows, n1, ilog2(n1), rb, scale);
  } else {
    const size_t smem =
        sizeof(float) * (2 * n1 + 2 * static_cast<size_t>(rb) * k1);
    dft_rows_c2r<<<row_blocks(rows, rb), NT, smem, st>>>(sr, si, x, tw1,
                                                         rows, n1, rb, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
