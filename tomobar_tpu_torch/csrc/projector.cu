// Parallel-beam projector pair as four CUDA kernels (gather form).
//
// The operator is the two-pass shear/resample pair of the JAX package's
// Pallas kernels (tomobar_tpu/ops/projector_pallas.py), per driven-angle
// group:
//
//   FP_a = Resample_a(ShearSum_a(vol))        K1 then K2
//   BP_a = ShearSum_a^T(Resample_a^T(sino))   K3 then K4 (exact transposes)
//
// Replaces (file, function):
//   K1 shear_fp_kernel    <- projector_pallas.py _shear_fp_kernel
//   K2 resample_fp_kernel <- projector_pallas.py _resample_fp_kernel
//   K3 resample_bp_kernel <- projector_pallas.py _resample_bp_kernel
//   K4 unshear_bp_kernel  <- projector_pallas.py _unshear_bp_kernel
//
// Design.  One thread owns one output element and gathers its taps, so no
// kernel needs atomics and every result is deterministic.  The TPU kernels
// scattered with lane rolls and banded MXU matmuls (bf16x3 operand split);
// here every tap is an fp32 load and an fp32 multiply-add.  The y-driven
// angle group runs the same kernels with the volume's y and x axes swapped
// through strides (K1) or index mapping (K4), so no transpose is made.
//
// What bounds them on an H100.  K1 and K4 are gathers with a long inner
// loop: K1 issues two loads per image row for each (angle, slice, u)
// output and K4 two loads per angle for each voxel, and every load is
// reused by many outputs, so both are bound by L1/L2 load bandwidth and
// issue rate, not by HBM traffic.  K2 and K3 read at most two taps per
// output and are bound by HBM traffic on their inputs and outputs.  The
// design keeps neighbouring threads on neighbouring u (K1, K3), t (K2) or
// x (K4), so the loads and stores of a warp coalesce; the swapped K1
// reads a column per row and leans on L1 to reuse its sectors.
//
// Float semantics follow the Pallas kernels: the row shift is
// shift = beta * (r - cy) in fp32, o = U0 - floor(shift), f = shift - floor;
// detector positions are pos = (U0 + gamma) + alpha * t in fp32.  Every
// multiply and add is rounded on its own (the __f*_rn intrinsics stop nvcc
// from contracting them into FMAs) and sums run in the plain versions'
// order, so K2 and K3 compute bit-identical hat weights and stay exact
// transposes, and each kernel can be held to its plain version tightly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void row_shift(float beta, int r, float cy, int U0,
                                          int& o, float& f) {
  const float shift = __fmul_rn(beta, __fsub_rn(static_cast<float>(r), cy));
  const float kf = floorf(shift);
  f = __fsub_rn(shift, kf);
  o = U0 - static_cast<int>(kf);
}

__device__ __forceinline__ float det_pos(float base, float alpha, int t) {
  return __fadd_rn(base, __fmul_rn(alpha, static_cast<float>(t)));
}

// (1-f) a + f b with every product and sum rounded on its own (no FMA), in
// the order the plain PyTorch versions evaluate it
__device__ __forceinline__ float lerp_taps(float f, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

__device__ __forceinline__ float hat(float pos, int u) {
  return fmaxf(0.f, 1.f - fabsf(__fsub_rn(pos, static_cast<float>(u))));
}

// K1: s[a, z, u] = sum_r (1-f) row_r[u-o] + f row_r[u-o+1], rows zero
// outside [0, row_len).  Row r of slice z is vol[z*sz + r*sr + c*sc].
__global__ void shear_fp_kernel(const float* __restrict__ vol,
                                const float* __restrict__ beta,
                                float* __restrict__ s, int A, int nz,
                                int n_rows, int row_len, long long sz,
                                long long sr, long long sc, int U0, int LU) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(A) * nz * LU) return;
  const int u = static_cast<int>(idx % LU);
  const long long az = idx / LU;
  const int z = static_cast<int>(az % nz);
  const int a = static_cast<int>(az / nz);
  const float b = beta[a];
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  const float* vz = vol + z * sz;
  float acc = 0.f;
  for (int r = 0; r < n_rows; ++r) {
    int o;
    float f;
    row_shift(b, r, cy, U0, o, f);
    const int j = u - o;
    if (j < -1 || j >= row_len) continue;
    const float* row = vz + r * sr;
    // j = -1 is the f * row[0] tap (the Pallas kernel's wrapped roll lane)
    const float v0 = j >= 0 ? row[j * sc] : 0.f;
    const float v1 = j + 1 < row_len ? row[(j + 1) * sc] : 0.f;
    acc = __fadd_rn(acc, lerp_taps(f, v0, v1));
  }
  s[idx] = acc;
}

// K2: p[z, a, t] = |alpha| (hat(pos - i) s[i] + hat(pos - i - 1) s[i+1]),
// i = floor(pos); the output is already in sinogram layout (nz, A, det_x).
__global__ void resample_fp_kernel(const float* __restrict__ s,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ gamma,
                                   float* __restrict__ p, int A, int nz,
                                   int LU, int det_x, int U0) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(nz) * A * det_x) return;
  const int t = static_cast<int>(idx % det_x);
  const long long za = idx / det_x;
  const int a = static_cast<int>(za % A);
  const int z = static_cast<int>(za / A);
  const float al = alpha[a];
  const float aa = fabsf(al);
  const float pos = det_pos(__fadd_rn(static_cast<float>(U0), gamma[a]), al, t);
  const int i = static_cast<int>(floorf(pos));
  const float* line = s + (static_cast<long long>(a) * nz + z) * LU;
  const float s0 = (i >= 0 && i < LU) ? line[i] : 0.f;
  const float s1 = (i + 1 >= 0 && i + 1 < LU) ? line[i + 1] : 0.f;
  p[idx] = __fadd_rn(__fmul_rn(__fmul_rn(aa, hat(pos, i)), s0),
                     __fmul_rn(__fmul_rn(aa, hat(pos, i + 1)), s1));
}

// K3: q[a, z, u] = |alpha| sum_{t < det_x} p[z, a, t] hat(pos_t - u).  Since
// |alpha| >= 1, at most two t have |pos_t - u| < 1; they lie within one of
// tc = (u - U0 - gamma) / alpha, and four candidates cover rounding.  u
// outside the angle's live range gets an exact zero.
__global__ void resample_bp_kernel(const float* __restrict__ p,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ gamma,
                                   float* __restrict__ q, int A, int nz,
                                   int LU, int det_x, int U0) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(A) * nz * LU) return;
  const int u = static_cast<int>(idx % LU);
  const long long az = idx / LU;
  const int z = static_cast<int>(az % nz);
  const int a = static_cast<int>(az / nz);
  const float al = alpha[a];
  const float aa = fabsf(al);
  const float base = __fadd_rn(static_cast<float>(U0), gamma[a]);
  const int t0 = static_cast<int>(floorf((static_cast<float>(u) - base) / al)) - 1;
  const float* row = p + (static_cast<long long>(z) * A + a) * det_x;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = t0 + k;
    if (t < 0 || t >= det_x) continue;
    const float w = hat(det_pos(base, al, t), u);
    if (w > 0.f) acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(aa, w), row[t]));
  }
  q[idx] = acc;
}

// K4: vol[z, Y, X] (+)= sum_a (1-f) q[a, z, o+col] + f q[a, z, o+col-1]
// with (row, col) = (Y, X), or (X, Y) for the swapped (y-driven) group.
__global__ void unshear_bp_kernel(const float* __restrict__ q,
                                  const float* __restrict__ beta,
                                  float* __restrict__ vol, int A, int nz,
                                  int ny, int nx, int LU, int U0, int swap,
                                  int accumulate) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(nz) * ny * nx) return;
  const int X = static_cast<int>(idx % nx);
  const long long zy = idx / nx;
  const int Y = static_cast<int>(zy % ny);
  const int z = static_cast<int>(zy / ny);
  const int row = swap ? X : Y;
  const int col = swap ? Y : X;
  const float cy = 0.5f * static_cast<float>((swap ? nx : ny) - 1);
  float acc = 0.f;
  for (int a = 0; a < A; ++a) {
    int o;
    float f;
    row_shift(beta[a], row, cy, U0, o, f);
    const float* line = q + (static_cast<long long>(a) * nz + z) * LU;
    const int u = o + col;
    const float q0 = (u >= 0 && u < LU) ? line[u] : 0.f;
    const float q1 = (u >= 1 && u - 1 < LU) ? line[u - 1] : 0.f;
    acc = __fadd_rn(acc, lerp_taps(f, q0, q1));
  }
  vol[idx] = accumulate ? __fadd_rn(vol[idx], acc) : acc;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tt_shear_fp(const float* vol, const float* beta, float* s, int A, int nz,
                int n_rows, int row_len, int sz, int sr, int sc, int U0,
                int LU, cudaStream_t stream) {
  const long long n = static_cast<long long>(A) * nz * LU;
  if (n == 0) return 0;
  shear_fp_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      vol, beta, s, A, nz, n_rows, row_len, sz, sr, sc, U0, LU);
  return static_cast<int>(cudaGetLastError());
}

int tt_resample_fp(const float* s, const float* alpha, const float* gamma,
                   float* p, int A, int nz, int LU, int det_x, int U0,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(nz) * A * det_x;
  if (n == 0) return 0;
  resample_fp_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      s, alpha, gamma, p, A, nz, LU, det_x, U0);
  return static_cast<int>(cudaGetLastError());
}

int tt_resample_bp(const float* p, const float* alpha, const float* gamma,
                   float* q, int A, int nz, int LU, int det_x, int U0,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(A) * nz * LU;
  if (n == 0) return 0;
  resample_bp_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      p, alpha, gamma, q, A, nz, LU, det_x, U0);
  return static_cast<int>(cudaGetLastError());
}

int tt_unshear_bp(const float* q, const float* beta, float* vol, int A,
                  int nz, int ny, int nx, int LU, int U0, int swap,
                  int accumulate, cudaStream_t stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n == 0) return 0;
  unshear_bp_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      q, beta, vol, A, nz, ny, nx, LU, U0, swap, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
