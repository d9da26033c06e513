// G: Gaussian gridding of the polar spectra of FOURIER_INV onto the
// (2n, 2n) Cartesian frequency grid (USFFT STEP2).
//
// Replaces (file, function): tomobar_tpu/ops/usfft_pallas.py
// _grid_kernel_astack (G1, the default schedule) and _grid_kernel (G0, the
// one-dot-per-angle schedule).  Both compute one sum, the one of the XLA
// scatter oracle tomobar_tpu/ops/usfft.py usfft_grid:
//     x0 = min(c cos(theta), 0.5 - 1e-5),  y0 = min(-c sin(theta), 0.5 - 1e-5),
//     c = (r - n/2)/n,
//     f[p, mod(l1 + n, 2n), mod(l0 + n, 2n)] += g[p, a, r] * coeff0 *
//         exp(coeff1 * ((l0/2n - x0)^2 + (l1/2n - y0)^2))
// over the (2m+1)^2 footprint l0 = floor(2n x0) - m .. + m (and l1 likewise).
// The Pallas kernels recast it as banded MXU matmuls over 128-row blocks of
// the grid with per-angle window arithmetic, which has no counterpart here.
//
// Design: the reference CUDA design (tomobar's fft_us_kernels.cu scatter):
// one thread per polar sample (a, r).  It computes the sample position and
// each tap's weight once -- the weights do not depend on the z-pair -- and
// applies it to up to kPairs z-pairs held in registers, both channels,
// with atomicAdd (compiled to RED: the return value is unused).
// Neighbouring threads are neighbouring samples on one polar line, so one
// warp's atomics land on neighbouring grid cells.  Position and weight
// arithmetic is rounded step by step (__f*_rn, no FMA contraction) in the
// oracle's order.
//
// Precision.  Every angle's DC and near-DC samples reach the same centre
// cells (about 1e4 terms per cell at the flagship), and an fp32 running sum
// there, in run-dependent atomic order, lost 3.3e-5 of the grid's max on an
// H100.  Away from the centre a cell at radius rho sees ~6300/rho angles, so
// the terms per cell fall off fast.  So the centre square of half-width R
// (grid rows and columns [n-R, n+R)) accumulates in a separate float64 grid
// that the wrapper rounds to float32 once, and every other cell in fp32.
// R = 0 is all fp32, R = n all fp64.
//
// What bounds it on an H100: the atomics.  At the flagship (1801 angles x
// 2560 samples, m = 5, 4 z-pairs) a call issues 1801*2560*121*4*2 = 4.5e9
// reductions, nearly all fp32 into an 840 MB grid that does not fit the
// 50 MB L2 (the fp64 centre square does); the exp per tap
// (4.6e6 * 121 = 5.6e8) is small beside them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;  // z-pairs per register batch

__device__ __forceinline__ int wrap(int v, int two_n) {
  const int r = v % two_n;
  return r < 0 ? r + two_n : r;
}

__global__ void __launch_bounds__(kThreads)
usfft_grid_kernel(const float* __restrict__ g_re, const float* __restrict__ g_im,
                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  float* __restrict__ f_re, float* __restrict__ f_im,
                  double* __restrict__ c_re, double* __restrict__ c_im, int nz2,
                  int nproj, int n, int m, int R, float coeff0, float coeff1,
                  float clamp) {
  const long long ns = static_cast<long long>(nproj) * n;
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const int a = static_cast<int>(s / n);
  const int r = static_cast<int>(s - static_cast<long long>(a) * n);
  const int two_n = 2 * n;
  const float two_n_f = static_cast<float>(two_n);
  const float c = __fdiv_rn(__fsub_rn(static_cast<float>(r),
                                      0.5f * static_cast<float>(n)),
                            static_cast<float>(n));
  const float x0 = fminf(__fmul_rn(c, cos_t[a]), clamp);
  const float y0 = fminf(__fmul_rn(-c, sin_t[a]), clamp);
  const int e0 = static_cast<int>(floorf(__fmul_rn(two_n_f, x0))) - m;
  const int e1 = static_cast<int>(floorf(__fmul_rn(two_n_f, y0))) - m;
  const long long plane = static_cast<long long>(two_n) * two_n;
  const int c0 = n - R;  // first row/column of the fp64 centre square
  const long long cplane = 4LL * R * R;

  for (int p0 = 0; p0 < nz2; p0 += kPairs) {
    float gr[kPairs], gi[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const bool live = p0 + j < nz2;
      gr[j] = live ? g_re[(p0 + j) * ns + s] : 0.0f;
      gi[j] = live ? g_im[(p0 + j) * ns + s] : 0.0f;
    }
    for (int i1 = 0; i1 <= 2 * m; ++i1) {
      const int l1 = e1 + i1;
      const float w1 = __fsub_rn(__fdiv_rn(static_cast<float>(l1), two_n_f), y0);
      const float w11 = __fmul_rn(w1, w1);
      const int idx1 = wrap(l1 + n, two_n);
      const bool centre_row = static_cast<unsigned>(idx1 - c0) < static_cast<unsigned>(2 * R);
      const long long row = static_cast<long long>(idx1) * two_n;
      const long long crow = static_cast<long long>(idx1 - c0) * (2 * R);
      for (int i0 = 0; i0 <= 2 * m; ++i0) {
        const int l0 = e0 + i0;
        const float w0 = __fsub_rn(__fdiv_rn(static_cast<float>(l0), two_n_f), x0);
        const float w = __fmul_rn(
            coeff0, expf(__fmul_rn(coeff1, __fadd_rn(__fmul_rn(w0, w0), w11))));
        const int idx0 = wrap(l0 + n, two_n);
        if (centre_row && static_cast<unsigned>(idx0 - c0) < static_cast<unsigned>(2 * R)) {
          const long long cell = crow + (idx0 - c0);
#pragma unroll
          for (int j = 0; j < kPairs; ++j) {
            if (p0 + j < nz2) {
              atomicAdd(c_re + (p0 + j) * cplane + cell,
                        static_cast<double>(__fmul_rn(gr[j], w)));
              atomicAdd(c_im + (p0 + j) * cplane + cell,
                        static_cast<double>(__fmul_rn(gi[j], w)));
            }
          }
        } else {
          const long long cell = row + idx0;
#pragma unroll
          for (int j = 0; j < kPairs; ++j) {
            if (p0 + j < nz2) {
              atomicAdd(f_re + (p0 + j) * plane + cell, __fmul_rn(gr[j], w));
              atomicAdd(f_im + (p0 + j) * plane + cell, __fmul_rn(gi[j], w));
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int tt_usfft_grid(const float* g_re, const float* g_im,
                             const float* cos_t, const float* sin_t,
                             float* f_re, float* f_im, double* c_re,
                             double* c_im, int nz2, int nproj, int n, int m,
                             int R, float coeff0, float coeff1, float clamp,
                             cudaStream_t stream) {
  const long long ns = static_cast<long long>(nproj) * n;
  if (R < 0 || R > n) return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0 || nz2 == 0) return 0;
  const long long blocks = (ns + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  usfft_grid_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      g_re, g_im, cos_t, sin_t, f_re, f_im, c_re, c_im, nz2, nproj, n, m, R,
      coeff0, coeff1, clamp);
  return static_cast<int>(cudaGetLastError());
}
