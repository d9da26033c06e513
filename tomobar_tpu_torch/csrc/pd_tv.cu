// Several Chambolle-Pock (primal-dual) TV iterations per launch, on tiles
// whose state lives in shared memory and registers.
//
// Replaces (file, function): tomobar_tpu/ops/pd_tv_pallas.py
// _pd_tv_stream_kernel with its _level_update: K iterations per pass over
// the volume, only the first level read from and the last level written to
// device memory.  Semantics are those of tomobar_tpu/regularisers.py PD_TV:
// dual ascent on forward differences (reflect at the far edge,
// d[n-1] = u[n-2] - u[n-1]), iso (joint ball) or aniso (per-component)
// projection, divergence by backward differences that take the neighbour
// before index 0 as zero, relaxed primal step, optional non-negativity of
// the primal centre.  With bfloat16 duals the duals are rounded after every
// iteration, inside a launch too.
//
// What bounds it on an H100.  One iteration per launch moves data, u and
// three duals in and u and three duals out, 36 bytes per voxel, and is
// bound by HBM traffic.  The function itself needs far less: a prox of n
// iterations must read data and write u once.  So the design keeps the
// state on the SM for K iterations and pays for that with a halo:
//
//  * Temporal blocking on tiles.  A block owns an output tile and loads it
//    with a halo of K voxels on each side in x and y (and in z where z is
//    cut into chunks).  An iteration widens the dependence cone by one voxel
//    in each direction (a new dual at i reads u at i and i + 1, a new u at i
//    the new duals at i and i - 1), so after K iterations the inner tile is
//    still exact; what lies outside the cone is garbage and is never stored.
//    The boundary rules are on global indices, at every level, and only
//    redirect a read to the neighbour on the other side, so a voxel of the
//    volume never reads one outside it.
//  * The state stays on the SM.  A thread owns the column (all ZC slices of
//    the chunk) of CY rows of the tile, kPDThreadsY rows apart, at one x.
//    u and the first two duals live in shared memory, where the x and y
//    neighbours read them; the third dual and data live in the thread's
//    registers, and the z neighbours are its own registers (a column of u is
//    read once per step).  ZC * CY = 16 voxels per thread in 512 threads: a
//    32 x 32-column tile of 8 slices takes 100 KB and 64 registers a thread,
//    so two blocks share an SM and one loads while the other computes.
//  * Two steps per iteration, each voxel's dual projected once.  Step 1:
//    every thread computes its new duals from u (x + 1 and y + 1 are its
//    neighbours') and overwrites its own first two in shared memory.
//    Barrier.  Step 2: it computes its new u from its own new duals and
//    those at x - 1 and y - 1 and overwrites its own u.  Barrier.  In a step
//    a thread writes only what no other thread reads in that step.
//  * A tile with its halo is 32 columns (one warp along x, so every global
//    and shared-memory access of a warp is a run of consecutive floats) by
//    kPDThreadsY * CY rows, for 1, 2, 4, 8 or 16 slices a thread.  More
//    than 16 slices are cut into chunks of 16 with a halo in z as well, and
//    then kPDKz iterations are fused instead of kPDK.
//  * The first launch of a prox takes u from data and the duals as zero,
//    the last one writes no duals: the wrapper neither clears nor reads
//    them.  The iteration count of a launch is a run-time argument, so a
//    count that K does not divide ends with a shorter launch of this kernel.
//
// Input and output buffers are separate (the caller ping-pongs them): a
// tile's halo is its neighbours' inner tile.
//
// On an NVIDIA H100 80GB HBM3 at 700 W one prox of 20 iterations on
// 8 x 2560^2 takes 6.4 ms (five launches) against 23.0 ms with one
// iteration per launch, and 0.76 against 2.17 ms on one 2560^2 slice.  The
// 24 x 24 inner tile of a 32 x 32 tile costs 1.78 times the loads and the
// arithmetic; K = 3 and 5 took 7.6 and 7.4 ms.  With the whole state in
// registers (one block of 1024 threads per SM, which loads, computes and
// stores in turn) it took 7.0 ms, and there K = 3, 5, 7, 10 took 8.2, 7.7,
// 9.3, 19.3 ms and 32 x 16 tiles, two blocks per SM, 12.9 ms.  Neither
// fewer instructions (no boundary selects, a one-instruction rsqrt, a
// three-instruction division: 6.3-6.5 ms) nor skipping the rows that have
// left the cone (slower: the others wait at the barriers) nor an L2
// prefetch of a later tile (slower) moved it: the launch waits on latency,
// at about 40-60% of the HBM rate.
//
// Products and sums are rounded one by one (__f*_rn, no FMA contraction)
// in the order of the plain PyTorch version.  nz == 1 is the 2D case: no z
// difference and no third dual.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPDK = 4;        // iterations per launch
constexpr int kPDKz = 2;       // iterations per launch when z is cut into chunks
constexpr int kPDV = 16;       // voxels per thread
constexpr int kPDThreadsY = 16;  // thread rows of a block
constexpr int kPDZMax = 16;    // slices a thread can hold
constexpr int kPDPad = 64;     // floats around each shared-memory array

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}
// the value a dual has after it was stored as D and read back
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Args {
  const float* data;
  const float* u_in;
  const void* p_in[3];
  float* u_out;
  void* p_out[3];
  int nz, ny, nx;
  int zi;     // slices a z-chunk stores (nz when there is one chunk)
  int iters;  // iterations of this launch = width of the halo
  float sigma, tau, lt, theta;
  int iso, nonneg, first, last;
};

// Thread (x, y) of block (bx, by, bz): tile column lx = x, rows
// ly = y + TYT j (j < CY), slices z < ZC of chunk bz.  Dynamic shared
// memory: su, sp1, sp2 (u and the first two duals), each
// ZC x (HY + 1) x 32 floats between pads, so that a read one row or column
// past the tile's edge stays inside.
template <typename D, int ZC, int CY, int TYT>
__global__ void __launch_bounds__(32 * TYT, 2) pd_tv_kernel(Args a) {
  extern __shared__ float pd_smem[];
  constexpr int HY = TYT * CY;            // tile rows with the halo
  constexpr int kPlane = (HY + 1) * 32;   // one slice of a shared array
  constexpr int kArray = ZC * kPlane + kPDPad;
  constexpr bool three = ZC > 1;          // nz > 1: a z difference, a third dual
  float* su = pd_smem + kPDPad;
  float* sp1 = su + kArray;
  float* sp2 = sp1 + kArray;

  const int K = a.iters;
  const int lx = threadIdx.x;
  const int gx = static_cast<int>(blockIdx.x) * (32 - 2 * K) - K + lx;
  const int gy0 = static_cast<int>(blockIdx.y) * (HY - 2 * K) - K + static_cast<int>(threadIdx.y);
  // the chunk's slices [zs, zs + zc) and the ones it stores [z_lo, z_hi), local
  const int zi0 = static_cast<int>(blockIdx.z) * a.zi;
  const int zs = a.zi < a.nz ? max(0, zi0 - K) : 0;
  const int zc = a.zi < a.nz ? min(a.nz, zi0 + a.zi + K) - zs : a.nz;
  const int z_lo = zi0 - zs;
  const int z_hi = min(a.nz, zi0 + a.zi) - zs;
  const bool x_in = gx >= 0 && gx < a.nx;
  const bool x_first = gx == 0, x_last = gx == a.nx - 1;
  const long long sy = a.nx, sz = static_cast<long long>(a.nx) * a.ny;
  const D* p_in[3] = {static_cast<const D*>(a.p_in[0]), static_cast<const D*>(a.p_in[1]),
                      static_cast<const D*>(a.p_in[2])};

  float p3[CY][ZC], dat[CY][ZC];
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    const int gy = gy0 + TYT * j;
    const bool col_in = x_in && gy >= 0 && gy < a.ny;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
      const int s = z * kPlane + (static_cast<int>(threadIdx.y) + TYT * j) * 32 + lx;
      const bool in = col_in && z < zc;
      const long long g = (zs + z) * sz + gy * sy + gx;
      dat[j][z] = in ? a.data[g] : 0.f;
      su[s] = a.first ? dat[j][z] : in ? a.u_in[g] : 0.f;
      const bool duals = in && !a.first;
      sp1[s] = duals ? load(p_in[0], g) : 0.f;
      sp2[s] = duals ? load(p_in[1], g) : 0.f;
      p3[j][z] = duals && three ? load(p_in[2], g) : 0.f;
    }
  }
  __syncthreads();

  const float den = 1.f + a.lt;
  for (int k = 0; k < K; ++k) {
    // step 1: the projected new duals of the thread's own voxels
#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const bool y_last = gy0 + TYT * j == a.ny - 1;
      const int s0 = (static_cast<int>(threadIdx.y) + TYT * j) * 32 + lx;
      float u[ZC];  // the column, for its z differences
#pragma unroll
      for (int z = 0; z < ZC; ++z) u[z] = su[z * kPlane + s0];
#pragma unroll
      for (int z = 0; z < ZC; ++z) {
        const int s = z * kPlane + s0;
        const float uc = u[z];
        const float dx = __fsub_rn(x_last ? su[s - 1] : su[s + 1], uc);
        const float dy = __fsub_rn(y_last ? su[s - 32] : su[s + 32], uc);
        // the duals as they were stored after the iteration before
        float q1 = __fadd_rn(stored(sp1[s], p_in[0]), __fmul_rn(a.sigma, dx));
        float q2 = __fadd_rn(stored(sp2[s], p_in[0]), __fmul_rn(a.sigma, dy));
        float q3 = 0.f;
        if (three) {
          const float below = z > 0 ? u[z > 0 ? z - 1 : 0] : uc;
          const float above = z + 1 < ZC ? u[z + 1 < ZC ? z + 1 : z] : uc;
          const float dz = __fsub_rn(zs + z == a.nz - 1 ? below : above, uc);
          q3 = __fadd_rn(p3[j][z], __fmul_rn(a.sigma, dz));
        }
        if (a.iso) {
          float denom = __fadd_rn(__fmul_rn(q1, q1), __fmul_rn(q2, q2));
          if (three) denom = __fadd_rn(denom, __fmul_rn(q3, q3));
          const float scale = denom > 1.f ? rsqrtf(fmaxf(denom, 1e-30f)) : 1.f;
          q1 = __fmul_rn(q1, scale);
          q2 = __fmul_rn(q2, scale);
          q3 = __fmul_rn(q3, scale);
        } else {
          q1 = __fdiv_rn(q1, fmaxf(fabsf(q1), 1.f));
          q2 = __fdiv_rn(q2, fmaxf(fabsf(q2), 1.f));
          q3 = __fdiv_rn(q3, fmaxf(fabsf(q3), 1.f));
        }
        p3[j][z] = q3;
        sp1[s] = q1;
        sp2[s] = q2;
      }
    }
    __syncthreads();
    // step 2: the new u from the new duals here and at x - 1, y - 1, z - 1
#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const bool y_first = gy0 + TYT * j == 0;
#pragma unroll
      for (int z = 0; z < ZC; ++z) {
        const int s = z * kPlane + (static_cast<int>(threadIdx.y) + TYT * j) * 32 + lx;
        const float q1 = sp1[s], q2 = sp2[s];
        float div = x_first ? q1 : __fsub_rn(q1, sp1[s - 1]);
        div = __fadd_rn(div, y_first ? q2 : __fsub_rn(q2, sp2[s - 32]));
        if (three) {
          const float below = z > 0 ? p3[j][z > 0 ? z - 1 : 0] : 0.f;
          div = __fadd_rn(div, zs + z == 0 ? p3[j][z] : __fsub_rn(p3[j][z], below));
        }
        const float uc = a.nonneg ? fmaxf(su[s], 0.f) : su[s];
        const float un = __fdiv_rn(
            __fadd_rn(__fadd_rn(uc, __fmul_rn(a.tau, div)), __fmul_rn(a.lt, dat[j][z])),
            den);
        su[s] = __fadd_rn(un, __fmul_rn(a.theta, __fsub_rn(un, uc)));
      }
    }
    // the third dual as the next iteration reads it
#pragma unroll
    for (int j = 0; j < CY; ++j) {
#pragma unroll
      for (int z = 0; z < ZC; ++z) p3[j][z] = stored(p3[j][z], p_in[0]);
    }
    __syncthreads();
  }

  // the inner tile
  if (lx < K || lx >= 32 - K || !x_in) return;
  D* p_out[3] = {static_cast<D*>(a.p_out[0]), static_cast<D*>(a.p_out[1]),
                 static_cast<D*>(a.p_out[2])};
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    const int ly = static_cast<int>(threadIdx.y) + TYT * j;
    const int gy = gy0 + TYT * j;
    if (ly < K || ly >= HY - K || gy >= a.ny) continue;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
      if (z < z_lo || z >= z_hi) continue;
      const int s = z * kPlane + ly * 32 + lx;
      const long long g = (zs + z) * sz + gy * sy + gx;
      a.u_out[g] = su[s];
      if (!a.last) {
        store(p_out[0], g, sp1[s]);
        store(p_out[1], g, sp2[s]);
        if (three) store(p_out[2], g, p3[j][z]);
      }
    }
  }
}

template <typename D, int ZC, int CY, int TYT>
int launch_tile(const Args& a, cudaStream_t stream) {
  constexpr int HY = TYT * CY;
  const int K = a.iters;
  if (K < 1 || 2 * K >= 32 || 2 * K >= HY) return static_cast<int>(cudaErrorInvalidValue);
  if (a.zi < a.nz && (a.zi < 1 || a.zi + 2 * K > ZC))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * (ZC * (HY + 1) * 32 + kPDPad) + kPDPad);
  const dim3 grid((a.nx + 32 - 2 * K - 1) / (32 - 2 * K), (a.ny + HY - 2 * K - 1) / (HY - 2 * K),
                  (a.nz + a.zi - 1) / a.zi);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      pd_tv_kernel<D, ZC, CY, TYT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pd_tv_kernel<D, ZC, CY, TYT><<<grid, dim3(32, TYT), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// iterations one launch fuses on a volume of nz slices
int fuse(int nz) { return nz <= kPDZMax ? kPDK : kPDKz; }

template <typename D>
int launch(Args a, cudaStream_t stream) {
  constexpr int T = kPDThreadsY;
  if (a.nz == 1) return launch_tile<D, 1, kPDV, T>(a, stream);
  if (a.nz == 2) return launch_tile<D, 2, kPDV / 2, T>(a, stream);
  if (a.nz <= 4) return launch_tile<D, 4, kPDV / 4, T>(a, stream);
  if (a.nz <= 8) return launch_tile<D, 8, kPDV / 8, T>(a, stream);
  if (a.nz > kPDZMax) a.zi = kPDZMax - 2 * fuse(a.nz);
  return launch_tile<D, kPDZMax, kPDV / kPDZMax, T>(a, stream);
}

}  // namespace

extern "C" {

// iterations per launch that tt_pd_tv fuses at most on nz slices
int tt_pd_tv_fuse(int nz) { return fuse(nz); }

// `iters` iterations (at most tt_pd_tv_fuse(nz)) from (u, p1, p2, p3) to
// (u_out, p*_out).  `first`: u is data and the duals are zero, u and p* are
// not read.  `last`: p*_out are not written.
int tt_pd_tv(const float* data, const float* u, const void* p1, const void* p2,
             const void* p3, float* u_out, void* p1_out, void* p2_out,
             void* p3_out, int nz, int ny, int nx, float sigma, float tau,
             float lt, float theta, int iso, int nonneg, int bf16, int iters,
             int first, int last, cudaStream_t stream) {
  if (static_cast<long long>(nz) * ny * nx == 0 || iters == 0) return 0;
  if (iters > fuse(nz)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{data, u, {p1, p2, p3}, u_out, {p1_out, p2_out, p3_out},
               nz, ny, nx, nz, iters, sigma, tau, lt, theta,
               iso, nonneg, first, last};
  if (bf16) return launch<__nv_bfloat16>(a, stream);
  return launch<float>(a, stream);
}

}  // extern "C"
