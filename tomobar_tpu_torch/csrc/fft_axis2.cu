// F: the length-n DFT along axis -2 of a split-complex float32 pair
// (Z, n, L), unnormalised, n = B*C with 1 < B <= 8 and C <= 1024.
//
// Replaces (file, function): tomobar_tpu/ops/fft_real.py, the inner
// `kernel` of _fft_axis2_fused.  It computes what that kernel computes --
// the Bailey four-step
//     X[k1 + B*k2] = DFT_C[n2 -> k2]( T[k1, n2] * DFT_B[n1 -> k1]( x[n1*C + n2] ) )
// with T[k1, n2] = exp(s*2i*pi*k1*n2/n) -- but not block by block: the
// Pallas kernel holds whole (n, 256)-lane strips in VMEM and does the
// C-point DFT as a dense (C, C) MXU matmul, which has no counterpart on a
// card whose block holds at most 227 KB of shared memory.
//
// Design.  One block owns one output row set k1 (all k2 < C) for kCols = 8
// neighbouring columns l of one batch z.  It
//   1. reads x[n1*C + n2, l] for every n1 < B and forms row k1 of the
//      B-point DFT times the twiddle T[k1, n2] (the block's share of the
//      B step: each output needs B loads, so the B step costs no extra
//      pass through device memory);
//   2. runs the C-point DFT in shared memory as self-sorting (Stockham)
//      stages of radix 4, 2, 3, 5, then any remaining prime, ping-ponging
//      two C x kCols buffers; stage t computes
//          Y_t[k, m] = sum_{r<q} w^(r*k*R_t) Y_{t-1}[k mod L_{t-1}, m + R_t r]
//      (Y_t[k, m] is the L_t-point DFT of the stride-R_t subsequence at
//      offset m, stored at k*R_t + m), one output per thread item;
//   3. writes X[k1 + B*k2, l], the k1/k2 interleave.
// Blocks run k1 fastest, so the B blocks reading the same x tile are
// scheduled together and share it through L2.  All tables (DFT_B, T and
// the C-stage roots w^j = exp(s*2i*pi*j/C)) are float64 on the host cast
// to float32; no library FFT, GEMM or tensor-core path is used.
//
// What bounds it on an H100: each column element is read once from device
// memory (B times from L2) and written once, 16 bytes per complex element
// in and out; in between, shared-memory traffic of about sum(q) loads per
// element and stage barriers.  At C = 1024 a block needs 136 KB of shared
// memory, so one block (16 warps) runs per SM: latency of the stage
// barriers, not device memory, is the expected limit of this first design.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 8;  // neighbouring columns l per block (32-byte rows)
constexpr int kMaxB = 8;
constexpr int kMaxC = 1024;

// radix of the next Stockham stage for a remaining length `rem`
__device__ __forceinline__ int next_radix(int rem) {
  if (rem % 4 == 0) return 4;
  if (rem % 2 == 0) return 2;
  if (rem % 3 == 0) return 3;
  if (rem % 5 == 0) return 5;
  for (int p = 7; p * p <= rem; p += 2)
    if (rem % p == 0) return p;
  return rem;
}

__global__ void __launch_bounds__(kThreads)
fft_axis2_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim,
                 const float* __restrict__ tables, int B, int C, int L,
                 int n_tiles) {
  extern __shared__ float smem[];
  float* w_re = smem;  // C-stage roots
  float* w_im = w_re + C;
  float* a_re = w_im + C;  // ping-pong buffers, [pos][col]
  float* a_im = a_re + C * kCols;
  float* b_re = a_im + C * kCols;
  float* b_im = b_re + C * kCols;

  const float* db_re = tables;  // DFT_B (B, B)
  const float* db_im = db_re + B * B;
  const float* t_re = db_im + B * B;  // T (B, C)
  const float* t_im = t_re + B * C;
  const float* c_re = t_im + B * C;  // roots (C)
  const float* c_im = c_re + C;

  const int k1 = blockIdx.x % B;
  const long long rest = blockIdx.x / B;
  const int l0 = static_cast<int>(rest % n_tiles) * kCols;
  const long long z = rest / n_tiles;
  const long long base = z * B * C * static_cast<long long>(L);
  const int items = C * kCols;

  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    w_re[j] = c_re[j];
    w_im[j] = c_im[j];
  }

  // 1. row k1 of the B-point DFT, times the twiddle
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int col = it % kCols;
    const int n2 = it / kCols;
    const int l = l0 + col;
    float zr = 0.0f, zi = 0.0f;
    if (l < L) {
      float yr = 0.0f, yi = 0.0f;
      for (int n1 = 0; n1 < B; ++n1) {
        const long long off = base + static_cast<long long>(n1 * C + n2) * L + l;
        const float xr = re[off], xi = im[off];
        const float cr = db_re[k1 * B + n1], ci = db_im[k1 * B + n1];
        yr += cr * xr - ci * xi;
        yi += cr * xi + ci * xr;
      }
      const float tr = t_re[k1 * C + n2], ti = t_im[k1 * C + n2];
      zr = yr * tr - yi * ti;
      zi = yr * ti + yi * tr;
    }
    a_re[it] = zr;
    a_im[it] = zi;
  }
  __syncthreads();

  // 2. the C-point DFT, Stockham stages
  float *src_re = a_re, *src_im = a_im, *dst_re = b_re, *dst_im = b_im;
  int Lp = 1, R = C;
  while (R > 1) {
    const int q = next_radix(R);
    const int Rt = R / q;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int col = it % kCols;
      const int pos = it / kCols;
      const int k = pos / Rt;
      const int m = pos - k * Rt;
      const int src0 = (k % Lp) * R + m;
      float sr = 0.0f, si = 0.0f;
      for (int r = 0; r < q; ++r) {
        const int w = (r * k * Rt) % C;  // r*k*Rt < q*C <= 2^20
        const int idx = (src0 + r * Rt) * kCols + col;
        const float vr = src_re[idx], vi = src_im[idx];
        const float cr = w_re[w], ci = w_im[w];
        sr += cr * vr - ci * vi;
        si += cr * vi + ci * vr;
      }
      dst_re[it] = sr;
      dst_im[it] = si;
    }
    __syncthreads();
    float* t = src_re; src_re = dst_re; dst_re = t;
    t = src_im; src_im = dst_im; dst_im = t;
    Lp *= q;
    R = Rt;
  }

  // 3. X[k1 + B*k2] = Y[k2]
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int col = it % kCols;
    const int k2 = it / kCols;
    const int l = l0 + col;
    if (l < L) {
      const long long off = base + static_cast<long long>(k1 + B * k2) * L + l;
      ore[off] = src_re[it];
      oim[off] = src_im[it];
    }
  }
}

}  // namespace

extern "C" int tt_fft_axis2(const float* re, const float* im, float* ore,
                            float* oim, const float* tables, int Z, int B,
                            int C, int L, cudaStream_t stream) {
  if (B < 2 || B > kMaxB || C < 2 || C > kMaxC || Z < 0 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(Z) * n_tiles * B;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 + 4 * kCols) * static_cast<size_t>(C);
  cudaError_t err = cudaFuncSetAttribute(
      fft_axis2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_axis2_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      re, im, ore, oim, tables, B, C, L, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
