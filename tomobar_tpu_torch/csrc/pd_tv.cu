// One Chambolle-Pock (primal-dual) TV iteration per launch.
//
// Replaces (file, function): tomobar_tpu/ops/pd_tv_pallas.py
// _pd_tv_stream_kernel with its _level_update.  Semantics are those of
// tomobar_tpu/regularisers.py PD_TV: dual ascent on forward differences
// (reflect at the far edge, d[n-1] = u[n-2] - u[n-1]), iso (joint ball) or
// aniso (per-component) projection, divergence by backward differences that
// take the neighbour before index 0 as zero, relaxed primal step, optional
// non-negativity of the primal centre.
//
// Design.  One thread owns voxel (z, y, x).  It recomputes the projected
// new duals at its own voxel and at its x-1, y-1 and z-1 neighbours from
// the old u and duals, which is all the divergence needs; this is the
// "recompute the neighbour duals" design of the reference CUDA kernel the
// Pallas kernel cites, and it needs no second pass and no grid-wide sync.
// Inputs and outputs are separate buffers (the caller ping-pongs them),
// because neighbouring threads still read the old duals.  The Pallas
// kernel's K-iteration row wavefront and thin-slab z padding manage VMEM
// and sublanes and have no counterpart here.
//
// What bounds it on an H100: HBM traffic.  Each iteration reads data, u and
// the old duals and writes u and the new duals once per voxel, with a few
// flops per byte; the neighbour re-reads hit L1/L2.  The design keeps x on
// neighbouring threads so every stream is coalesced; bf16 duals
// (half_precision) cut the dual traffic in half.
//
// Products and sums are rounded one by one (__f*_rn, no FMA contraction)
// in the order of the plain PyTorch version.  nz == 1 is the 2D case: no z
// difference and no third dual.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

struct Shape {
  int nz, ny, nx;
  long long sy, sz;  // strides of y and z in elements
};

// projected new dual (q1, q2, q3) at voxel (z, y, x)
template <typename D>
__device__ __forceinline__ void new_dual(const float* __restrict__ u,
                                         const D* __restrict__ p1,
                                         const D* __restrict__ p2,
                                         const D* __restrict__ p3,
                                         const Shape& sh, int z, int y, int x,
                                         float sigma, bool iso, float& q1,
                                         float& q2, float& q3) {
  const long long i = z * sh.sz + y * sh.sy + x;
  const float uc = u[i];
  const float dx = (x == sh.nx - 1 ? u[i - 1] : u[i + 1]) - uc;
  const float dy = (y == sh.ny - 1 ? u[i - sh.sy] : u[i + sh.sy]) - uc;
  q1 = __fadd_rn(load(p1, i), __fmul_rn(sigma, dx));
  q2 = __fadd_rn(load(p2, i), __fmul_rn(sigma, dy));
  const bool three = sh.nz > 1;
  q3 = 0.f;
  if (three) {
    const float dz = (z == sh.nz - 1 ? u[i - sh.sz] : u[i + sh.sz]) - uc;
    q3 = __fadd_rn(load(p3, i), __fmul_rn(sigma, dz));
  }
  if (iso) {
    float denom = __fadd_rn(__fmul_rn(q1, q1), __fmul_rn(q2, q2));
    if (three) denom = __fadd_rn(denom, __fmul_rn(q3, q3));
    const float scale = denom > 1.f ? rsqrtf(fmaxf(denom, 1e-30f)) : 1.f;
    q1 *= scale;
    q2 *= scale;
    q3 *= scale;
  } else {
    q1 = q1 / fmaxf(fabsf(q1), 1.f);
    q2 = q2 / fmaxf(fabsf(q2), 1.f);
    q3 = q3 / fmaxf(fabsf(q3), 1.f);
  }
}

template <typename D>
__global__ void pd_tv_iter_kernel(const float* __restrict__ data,
                                  const float* __restrict__ u,
                                  const D* __restrict__ p1,
                                  const D* __restrict__ p2,
                                  const D* __restrict__ p3,
                                  float* __restrict__ u_out,
                                  D* __restrict__ p1_out,
                                  D* __restrict__ p2_out,
                                  D* __restrict__ p3_out, Shape sh,
                                  float sigma, float tau, float lt,
                                  float theta, int iso, int nonneg) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= sh.nz * sh.sz) return;
  const int x = static_cast<int>(idx % sh.nx);
  const int y = static_cast<int>((idx / sh.nx) % sh.ny);
  const int z = static_cast<int>(idx / sh.sz);
  const bool is_iso = iso != 0;

  float a1, a2, a3, b1, b2, b3;
  new_dual(u, p1, p2, p3, sh, z, y, x, sigma, is_iso, a1, a2, a3);
  float div = a1;
  if (x > 0) {
    new_dual(u, p1, p2, p3, sh, z, y, x - 1, sigma, is_iso, b1, b2, b3);
    div = a1 - b1;
  }
  float d2 = a2;
  if (y > 0) {
    new_dual(u, p1, p2, p3, sh, z, y - 1, x, sigma, is_iso, b1, b2, b3);
    d2 = a2 - b2;
  }
  div += d2;
  if (sh.nz > 1) {
    float d3 = a3;
    if (z > 0) {
      new_dual(u, p1, p2, p3, sh, z - 1, y, x, sigma, is_iso, b1, b2, b3);
      d3 = a3 - b3;
    }
    div += d3;
  }

  float uc = u[idx];
  if (nonneg) uc = fmaxf(uc, 0.f);
  const float un =
      __fadd_rn(__fadd_rn(uc, __fmul_rn(tau, div)), __fmul_rn(lt, data[idx])) /
      (1.f + lt);
  u_out[idx] = __fadd_rn(un, __fmul_rn(theta, un - uc));
  store(p1_out, idx, a1);
  store(p2_out, idx, a2);
  if (sh.nz > 1) store(p3_out, idx, a3);
}

template <typename D>
int launch(const float* data, const float* u, const void* p1, const void* p2,
           const void* p3, float* u_out, void* p1_out, void* p2_out,
           void* p3_out, Shape sh, float sigma, float tau, float lt,
           float theta, int iso, int nonneg, cudaStream_t stream) {
  const long long n = sh.nz * sh.sz;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  pd_tv_iter_kernel<D><<<blocks, kThreads, 0, stream>>>(
      data, u, static_cast<const D*>(p1), static_cast<const D*>(p2),
      static_cast<const D*>(p3), u_out, static_cast<D*>(p1_out),
      static_cast<D*>(p2_out), static_cast<D*>(p3_out), sh, sigma, tau, lt,
      theta, iso, nonneg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tt_pd_tv_iter(const float* data, const float* u, const void* p1,
                             const void* p2, const void* p3, float* u_out,
                             void* p1_out, void* p2_out, void* p3_out, int nz,
                             int ny, int nx, float sigma, float tau, float lt,
                             float theta, int iso, int nonneg, int bf16,
                             cudaStream_t stream) {
  if (static_cast<long long>(nz) * ny * nx == 0) return 0;
  const Shape sh{nz, ny, nx, nx, static_cast<long long>(nx) * ny};
  if (bf16)
    return launch<__nv_bfloat16>(data, u, p1, p2, p3, u_out, p1_out, p2_out,
                                 p3_out, sh, sigma, tau, lt, theta, iso,
                                 nonneg, stream);
  return launch<float>(data, u, p1, p2, p3, u_out, p1_out, p2_out, p3_out, sh,
                       sigma, tau, lt, theta, iso, nonneg, stream);
}
