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
//    kPDThreadsY * CY rows, for 1, 2, 4 or 8 slices a thread.  tt_pd_tv
//    takes at most kPDZMax = 8 slices; the wrapper sends deeper volumes to
//    the wavefront kernel below, which is faster from 12 slices on (11.2 /
//    13.0 ms at 12 / 16 slices against a 16-slice tile's 16.9 / 18.1; at 8
//    slices 6.5 against the tile's 6.3, tools/torch_kernel_times.py, one
//    call), so the 16-slice tile is gone.
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
// at about 40-60% of the HBM rate.  Under the 64 registers of two blocks an
// SM the tiles spilled: step 1 reads a column's u as it goes (z - 1, z,
// z + 1) rather than all of it first, which took the 8-slice prox from
// 6.36-6.39 to 6.28-6.32 ms without spills (tools/torch_kernel_times.py, two
// calls).
//
// Products and sums are rounded one by one (__f*_rn, no FMA contraction)
// in the order of the plain PyTorch version.  nz == 1 is the 2D case: no z
// difference and no third dual.
//
// The deep-stack kernel (pd_tv_wave_kernel, more than kPDZMax slices).
// The tile kernel held at most 16 slices a thread; above that it cut z
// into chunks of 16 that kept 12 and fused only 2 iterations a launch, and
// at the north star's 20 x 2560^2 one prox of 20 iterations took 37.4 ms,
// 5.7 times the 8-slice prox for 2.5 times the voxels.
// This kernel is the TPU kernel's y-streaming wavefront, thought through
// again for the SM:
//
//  * A block owns an x-strip of W = 32 kPDWX columns (with a halo of K on
//    each side) and a z-slab, one slice a warp row: all of a volume of up
//    to 32 slices (no halo in z), else slabs of 32 that keep 32 - 2K.  It
//    walks a y-segment of kPDWRows output rows in a sequential sweep, one
//    row-plane (slab x strip) a step.  Thread (lane, w) holds columns
//    lane + 32 i of slice w of every plane.
//  * K iterations ride the sweep as levels: at step s level j computes row
//    s - j from level j - 1's rows s - j and s - j + 1, which level j - 1
//    wrote in the step before and in this one.  Level 0 is the only one
//    read from device memory (staged a row ahead with cp.async, data in a
//    ring of K + 2 rows that every level reads) and level K the only one
//    written, so a sweep moves data, u and the duals once for K
//    iterations.  A segment starts its sweep K rows early and drains K rows
//    late; the rows a level computes outside the dependence cone are never
//    stored.
//  * The state of a level is two u planes in shared memory, by row parity,
//    whose x and z neighbours the next level reads, and the level's duals
//    in registers (the next level and the divergence in y read them only at
//    the thread's own voxels).  A step of a level is the dual step, a
//    barrier (the new p1 and p3 go through shared memory to the x + 1 and
//    z + 1 neighbours), then the primal step.  Rows by parity give the
//    reflection at y = ny - 1 for free: level j never writes row ny, so the
//    plane of row ny still holds row ny - 2 when level j + 1 asks for its
//    "next" row at ny - 1.
//  * What bounds it is latency: each level step waits on a barrier and on
//    two dependent chains, so the SM needs many warps.  Up to 20 slices a
//    block has at most 20 warps and 96 registers a thread, deeper ones 32
//    and 64.  With K = 4 a 20-slice block takes 24 planes, 135 KB (32
//    slices: 209 KB), one block an SM; 46 strips x 20 segments = 920 blocks.
//    The strip's x halo costs 64 / 56 = 1.14 times the work, the segment's
//    early start 1.06, a slab's z halo 32 / 24 = 1.33.
//  * The primal step multiplies by 1 / (1 + lt) instead of dividing (one
//    rounding more than the plain version), and the zero boundary of the
//    divergence is an FMA with a factor of 0 or 1, which rounds as the
//    subtraction does.  iso/aniso is a template argument.
//
// Predicted on an H100 80GB HBM3 at 700 W, before the kernel first ran:
// one prox of 20 iterations (6 + 6 + 6 + 2) on 20 x 2560^2 8-12 ms (about
// 65 instructions a voxel and iteration, 3.4e9 of them with the halos: 6.5
// ms at the full issue rate; the sweeps move 17 GB, 5.1 ms at 3.35 TB/s),
// against 37.4 ms for the z-chunk path; on 64 x 2560^2 (3 slabs) 35-50 ms;
// on 512 x 2560^2 (the wrapper's 4 byte-budget chunks, 22 slabs each)
// 300-450 ms against 1230-1542 ms.
//
// Measured (tools/torch_kernel_times.py, two calls, each with the tree
// before this kernel; NVIDIA H100 80GB HBM3, 700 W): one prox of 20
// iterations on 20 / 64 / 512 x 2560^2 15.0-15.1 / 76.1-76.5 / 733-742 ms
// against 37.4-37.6 / 121.5-122.6 / 1163-1172 ms.  The first build (W 64, K 6, two slices a
// thread, 16 warps at most, data read from L2 at every level) was no
// faster than the z-chunk path: its registers spilled under the 512-thread
// bound, and every level waited on L2.  What moved it, each step timed in
// one call with the one before: blocks of at most 10 warps up to 20 slices
// (no spills) and data staged in the ring, 30.0 ms; the reciprocal, 25.6;
// the offset and FMA
// boundaries, 23.0; one slice a thread in 20 warps, 18.0; K 4 instead of
// 6, 16.1 (K 5: 18.0; blocks of 32 warps with 64 registers: 17.1); iso
// as a template argument (an iso-only build was 8% faster), 15.1 in the
// final call.  At 20 slices the arithmetic is 9.4% of fp32
// (bench.breakdown): the sweep still waits at every level's barrier.

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPDK = 4;        // iterations per launch
constexpr int kPDV = 16;       // voxels per thread
constexpr int kPDThreadsY = 16;  // thread rows of a block
constexpr int kPDZMax = 8;     // slices a thread can hold
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
  int iters;  // iterations of this launch = width of the halo
  float sigma, tau, lt, theta;
  int iso, nonneg, first, last;
};

// Thread (x, y) of block (bx, by): tile column lx = x, rows
// ly = y + TYT j (j < CY), slices z < nz <= ZC.  Dynamic shared
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
      const bool in = col_in && z < a.nz;
      const long long g = z * sz + gy * sy + gx;
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
      // the column's u at z - 1, z and z + 1, for its z differences, read
      // as the loop goes (with the whole column read first, the compiler
      // spilled registers of the 8-slice tile)
      float below = 0.f, uc = su[s0];
#pragma unroll
      for (int z = 0; z < ZC; ++z) {
        const int s = z * kPlane + s0;
        const float above = z + 1 < ZC ? su[s + kPlane] : uc;
        const float dx = __fsub_rn(x_last ? su[s - 1] : su[s + 1], uc);
        const float dy = __fsub_rn(y_last ? su[s - 32] : su[s + 32], uc);
        // the duals as they were stored after the iteration before
        float q1 = __fadd_rn(stored(sp1[s], p_in[0]), __fmul_rn(a.sigma, dx));
        float q2 = __fadd_rn(stored(sp2[s], p_in[0]), __fmul_rn(a.sigma, dy));
        float q3 = 0.f;
        if (three) {
          const float dz = __fsub_rn(z == a.nz - 1 ? (z > 0 ? below : uc) : above, uc);
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
        below = uc;
        uc = above;
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
          div = __fadd_rn(div, z == 0 ? p3[j][z] : __fsub_rn(p3[j][z], below));
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
      if (z >= a.nz) continue;
      const int s = z * kPlane + ly * 32 + lx;
      const long long g = z * sz + gy * sy + gx;
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
  if (K < 1 || 2 * K >= 32 || 2 * K >= HY || a.nz > ZC)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * (ZC * (HY + 1) * 32 + kPDPad) + kPDPad);
  const dim3 grid((a.nx + 32 - 2 * K - 1) / (32 - 2 * K), (a.ny + HY - 2 * K - 1) / (HY - 2 * K));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      pd_tv_kernel<D, ZC, CY, TYT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pd_tv_kernel<D, ZC, CY, TYT><<<grid, dim3(32, TYT), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
int launch(Args a, cudaStream_t stream) {
  constexpr int T = kPDThreadsY;
  if (a.nz == 1) return launch_tile<D, 1, kPDV, T>(a, stream);
  if (a.nz == 2) return launch_tile<D, 2, kPDV / 2, T>(a, stream);
  if (a.nz <= 4) return launch_tile<D, 4, kPDV / 4, T>(a, stream);
  return launch_tile<D, kPDZMax, kPDV / kPDZMax, T>(a, stream);
}

// ---- the deep-stack kernel: the y-streaming wavefront ----------------------

constexpr int kPDWK = 4;         // iterations (levels) a sweep fuses
constexpr int kPDWWarps1 = 20;   // warp rows (slices) of a block up to 20 slices
constexpr int kPDWWarps = 32;    // warp rows of the blocks of deeper volumes: slabs of 32
constexpr int kPDWX = 2;         // columns of a thread, 32 apart
constexpr int kPDWRows = 128;    // output rows of a block's y-segment

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Block (bx, by, bz): strip bx (columns x0 .. x0 + W - 1), y-segment by
// (output rows y0 .. y1 - 1), slab bz (slices z0 .. z0 + zs - 1, keeping
// zk of them), a slice a warp row, WARPS warp rows at most, K <= kPDWK
// levels, iso or aniso projection.  Dynamic shared
// memory: 3K + 12 planes of zs x W floats, each between pads of W + 1, so
// that a read one column or slice past the plane stays inside: u of levels
// 1 .. K - 1 by row parity, the staged level 0 (u, then p1, p2, p3) by row
// parity, the new p1 and p3 of the level being computed by the parity of a
// count of level steps, and data rows in a ring of K + 2 (level j reads row
// s - j at step s, and row s + 1 is staged during step s).  The volume has
// fewer than 2^31 voxels (the wrapper's z-chunks), so indices are 32-bit.
template <typename D, int WARPS, bool ISO>
__global__ void __launch_bounds__(32 * WARPS, 1) pd_tv_wave_kernel(Args a, int zs, int zk) {
  constexpr int V = kPDWX, W = 32 * kPDWX;
  extern __shared__ float pd_wave_smem[];
  const int K = a.iters, ring = K + 2;
  const int TZ = static_cast<int>(blockDim.y);
  const int PL = zs * W + 2 * (W + 1);
  const int n_planes = 3 * K + 12;
  float* const base = pd_wave_smem + W + 1;
  auto U = [&](int j, int par) { return base + (2 * (j - 1) + par) * PL; };
  auto SU = [&](int par) { return base + (2 * (K - 1) + par) * PL; };
  auto SP = [&](int par, int c) { return base + (2 * K + 3 * par + c) * PL; };
  auto X = [&](int par, int c) { return base + (2 * K + 6 + 2 * par + c) * PL; };
  auto DR = [&](int slot) { return base + (2 * K + 10 + slot) * PL; };

  const int lane = static_cast<int>(threadIdx.x), wz = static_cast<int>(threadIdx.y);
  for (int i = wz * 32 + lane; i < n_planes * PL; i += 32 * TZ) pd_wave_smem[i] = 0.f;

  const int x0 = static_cast<int>(blockIdx.x) * (W - 2 * K) - K;
  const int y0 = static_cast<int>(blockIdx.y) * kPDWRows;
  const int y1 = min(a.ny, y0 + kPDWRows);
  const int zk0 = static_cast<int>(blockIdx.z) * zk;
  const int zk1 = min(a.nz, zk0 + zk);
  const int z0 = gridDim.z == 1 ? 0 : zk0 - K;
  const int sy = a.nx, sz = a.nx * a.ny;
  const D* p_in[3] = {static_cast<const D*>(a.p_in[0]), static_cast<const D*>(a.p_in[1]),
                      static_cast<const D*>(a.p_in[2])};
  D* p_out[3] = {static_cast<D*>(a.p_out[0]), static_cast<D*>(a.p_out[1]),
                 static_cast<D*>(a.p_out[2])};

  // the thread's voxels v of a plane: column lane + 32 v, slice wz.  The
  // forward differences read the neighbour at +xo and +zo
  // (-1 and -W at the volume's far edge); the divergence subtracts fx and
  // fz times the neighbour at -1 and -W (0 at index 0: an FMA with a factor
  // of 0 or 1 rounds as the subtraction or as no term at all)
  int off[V], g0[V], xo[V], zo[V];  // g0: the (z, x) part of the index, 0 outside
  float fx[V], fz[V];
  unsigned inside = 0, keep = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int lx = lane + 32 * v, lz = wz;
    const int gx = x0 + lx, gz = z0 + lz;
    const bool in = gx >= 0 && gx < a.nx && gz >= 0 && gz < a.nz;
    off[v] = lz * W + lx;
    g0[v] = in ? gz * sz + gx : 0;
    xo[v] = gx == a.nx - 1 ? -1 : 1;
    zo[v] = gz == a.nz - 1 ? -W : W;
    fx[v] = gx == 0 ? 0.f : 1.f;
    fz[v] = gz == 0 ? 0.f : 1.f;
    inside |= unsigned(in) << v;
    keep |= unsigned(in && lx >= K && lx < W - K && gz >= zk0 && gz < zk1) << v;
  }

  // level-0 row `row`: data into its ring slot, and after the first launch
  // u and the three duals into their parity's planes (on the first launch u
  // is data and the duals are zero)
  auto stage = [&](int row, int slot) {
    const int par = row & 1;
    float* dr = DR(slot);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool in = inside >> v & 1;
      const int g = g0[v] + row * sy;  // inside the volume even where !in
      cp_async4(dr + off[v], a.data + g, in);
      if (a.first) continue;
      cp_async4(SU(par) + off[v], a.u_in + g, in);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (std::is_same<D, float>::value)
          cp_async4(SP(par, c) + off[v], p_in[c] + g, in);
        else
          SP(par, c)[off[v]] = in ? load(p_in[c], g) : 0.f;
      }
    }
    cp_async_commit();
  };

  // the sweep: steps s0 .. s1; level-0 rows up to last_row are staged
  const int s0 = max(0, y0 - K), s1 = y1 - 1 + K;
  const int last_row = min(a.ny - 1, s1);
  __syncthreads();  // the zero fill is done before any copy lands
  int slot = s0 % ring;  // data ring slot of row s
  stage(s0, slot);
  cp_async_wait_all();
  __syncthreads();

  // P[j - 1]: level j's duals at the last row it computed, unrounded (the
  // divergence in y reads them so); the next level reads them as stored
  float P[kPDWK][3][V], pend[3][V];
#pragma unroll
  for (int j = 0; j < kPDWK; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) P[j][c][v] = 0.f;
  bool pend_ok = false;
  int xpar = 0;
  const float rden = 1.f / (1.f + a.lt);

  for (int s = s0; s <= s1; ++s, slot = slot + 1 == ring ? 0 : slot + 1) {
    cp_async_wait_all();  // this thread's copies of row s have landed
#pragma unroll
    for (int j = 1; j <= kPDWK; ++j) {
      if (j > K) break;
      const int r = s - j;
      const bool act = r >= s0 && r < a.ny;  // the same for the whole block
      const int rslot = slot - j < 0 ? slot - j + ring : slot - j, nslot = r + 1 < a.ny
          ? (rslot + 1 == ring ? 0 : rslot + 1) : (rslot == 0 ? ring - 1 : rslot - 1);
      float T[3][V], cu[V];
      if (act) {
        // dual step: new p at row r from level j - 1's u at rows r and r + 1
        const int rn = r + 1 < a.ny ? r + 1 : r - 1;
        const float* uc = j > 1 ? U(j - 1, r & 1) : a.first ? DR(rslot) : SU(r & 1);
        const float* un = j > 1 ? U(j - 1, rn & 1) : a.first ? DR(nslot) : SU(rn & 1);
        float* x1 = X(xpar, 0);
        float* x3 = X(xpar, 1);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int o = off[v];
          const float c = uc[o];
          cu[v] = c;
          const float dx = __fsub_rn(uc[o + xo[v]], c);
          const float dy = __fsub_rn(un[o], c);
          const float dz = __fsub_rn(uc[o + zo[v]], c);
          float p1 = 0.f, p2 = 0.f, p3 = 0.f;
          if (j == 1) {
            if (!a.first) {
              p1 = SP(r & 1, 0)[o];
              p2 = SP(r & 1, 1)[o];
              p3 = SP(r & 1, 2)[o];
            }
          } else {
            p1 = stored(P[j - 2][0][v], p_in[0]);
            p2 = stored(P[j - 2][1][v], p_in[0]);
            p3 = stored(P[j - 2][2][v], p_in[0]);
          }
          float q1 = __fadd_rn(p1, __fmul_rn(a.sigma, dx));
          float q2 = __fadd_rn(p2, __fmul_rn(a.sigma, dy));
          float q3 = __fadd_rn(p3, __fmul_rn(a.sigma, dz));
          if (ISO) {
            const float denom = __fadd_rn(
                __fadd_rn(__fmul_rn(q1, q1), __fmul_rn(q2, q2)), __fmul_rn(q3, q3));
            const float scale = denom > 1.f ? rsqrtf(fmaxf(denom, 1e-30f)) : 1.f;
            q1 = __fmul_rn(q1, scale);
            q2 = __fmul_rn(q2, scale);
            q3 = __fmul_rn(q3, scale);
          } else {
            q1 = __fdiv_rn(q1, fmaxf(fabsf(q1), 1.f));
            q2 = __fdiv_rn(q2, fmaxf(fabsf(q2), 1.f));
            q3 = __fdiv_rn(q3, fmaxf(fabsf(q3), 1.f));
          }
          T[0][v] = q1;
          T[1][v] = q2;
          T[2][v] = q3;
          x1[o] = q1;
          x3[o] = q3;
        }
      }
      // level j - 1's new duals replace those level j has just read
      if (j >= 2 && pend_ok) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v) P[j - 2][c][v] = pend[c][v];
      }
      if (act) {
        __syncthreads();
        // primal step: the divergence of the new p (x - 1 and z - 1 from
        // the neighbours, y - 1 from this level's row before), then u
        const float* x1 = X(xpar, 0);
        const float* x3 = X(xpar, 1);
        const float* dr = DR(rslot);
        const bool out_row = j == K && r >= y0 && r < y1;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int o = off[v];
          const float q1 = T[0][v], q2 = T[1][v], q3 = T[2][v];
          float div = __fmaf_rn(-fx[v], x1[o - 1], q1);
          div = __fadd_rn(div, r == 0 ? q2 : __fsub_rn(q2, P[j - 1][1][v]));
          div = __fadd_rn(div, __fmaf_rn(-fz[v], x3[o - W], q3));
          const float ucl = a.nonneg ? fmaxf(cu[v], 0.f) : cu[v];
          const float unew = __fmul_rn(
              __fadd_rn(__fadd_rn(ucl, __fmul_rn(a.tau, div)), __fmul_rn(a.lt, dr[o])), rden);
          const float u_next = __fadd_rn(unew, __fmul_rn(a.theta, __fsub_rn(unew, ucl)));
          if (j < K) {
            U(j, r & 1)[o] = u_next;
          } else if (out_row && (keep >> v & 1)) {
            const int g = g0[v] + r * sy;
            a.u_out[g] = u_next;
            if (!a.last) {
              store(p_out[0], g, q1);
              store(p_out[1], g, q2);
              store(p_out[2], g, q3);
            }
          }
        }
        xpar ^= 1;
      }
      if (j == K) {
        if (act) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int v = 0; v < V; ++v) P[j - 1][c][v] = T[c][v];
        }
      } else {
        if (act) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int v = 0; v < V; ++v) pend[c][v] = T[c][v];
        }
        pend_ok = act;
      }
      // level 1 has read row s - 1 of level 0: its planes take row s + 1
      if (j == 1 && s + 1 <= last_row) stage(s + 1, slot + 1 == ring ? 0 : slot + 1);
    }
  }
}

template <typename D, int WARPS, bool ISO>
int launch_wave_blocks(const Args& a, int zs, int zk, int slabs, cudaStream_t stream) {
  constexpr int W = 32 * kPDWX;
  const int K = a.iters;
  const size_t smem = sizeof(float) * (3 * K + 12) * (zs * W + 2 * (W + 1));
  const dim3 grid((a.nx + W - 2 * K - 1) / (W - 2 * K), (a.ny + kPDWRows - 1) / kPDWRows, slabs);
  if (zs > WARPS || grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(pd_tv_wave_kernel<D, WARPS, ISO>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pd_tv_wave_kernel<D, WARPS, ISO><<<grid, dim3(32, zs), smem, stream>>>(a, zs, zk);
  return static_cast<int>(cudaGetLastError());
}

// a warp row a slice: one slab of up to 20 slices in blocks of at most 20
// warp rows (96 registers a thread), one of up to 32 or slabs of 32 with a
// halo of K in z in blocks of 32 (64 registers)
template <typename D, bool ISO>
int launch_wave(const Args& a, cudaStream_t stream) {
  const int K = a.iters;
  if (K < 1 || K > kPDWK || 2 * K >= 32 * kPDWX || a.nz < 2 || a.ny < 2 ||
      static_cast<long long>(a.nz) * a.ny * a.nx > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.nz <= kPDWWarps1) return launch_wave_blocks<D, kPDWWarps1, ISO>(a, a.nz, a.nz, 1, stream);
  if (a.nz <= kPDWWarps) return launch_wave_blocks<D, kPDWWarps, ISO>(a, a.nz, a.nz, 1, stream);
  const int zk = kPDWWarps - 2 * K;
  return launch_wave_blocks<D, kPDWWarps, ISO>(a, kPDWWarps, zk, (a.nz + zk - 1) / zk, stream);
}

// iterations one launch fuses on nz slices: the tile kernel's up to
// kPDZMax slices, the wavefront's above
int fuse(int nz) { return nz <= kPDZMax ? kPDK : kPDWK; }

}  // namespace

extern "C" {

// iterations per launch that the wrapper's route fuses at most on nz
// slices: tt_pd_tv's up to kPDZMax slices, tt_pd_tv_wave's above
int tt_pd_tv_fuse(int nz) { return fuse(nz); }

// `iters` iterations (at most tt_pd_tv_fuse(nz)) from (u, p1, p2, p3) to
// (u_out, p*_out) on nz <= kPDZMax slices.  `first`: u is data and the
// duals are zero, u and p* are not read.  `last`: p*_out are not written.
int tt_pd_tv(const float* data, const float* u, const void* p1, const void* p2,
             const void* p3, float* u_out, void* p1_out, void* p2_out,
             void* p3_out, int nz, int ny, int nx, float sigma, float tau,
             float lt, float theta, int iso, int nonneg, int bf16, int iters,
             int first, int last, cudaStream_t stream) {
  if (static_cast<long long>(nz) * ny * nx == 0 || iters == 0) return 0;
  if (nz > kPDZMax || iters > kPDK) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{data, u, {p1, p2, p3}, u_out, {p1_out, p2_out, p3_out},
               nz, ny, nx, iters, sigma, tau, lt, theta,
               iso, nonneg, first, last};
  if (bf16) return launch<__nv_bfloat16>(a, stream);
  return launch<float>(a, stream);
}

// tt_pd_tv's iterations by the y-streaming wavefront, on nz >= 2 slices and
// fewer than 2^31 voxels (the wrapper's route above kPDZMax), `iters` at
// most kPDWK
int tt_pd_tv_wave(const float* data, const float* u, const void* p1, const void* p2,
                  const void* p3, float* u_out, void* p1_out, void* p2_out,
                  void* p3_out, int nz, int ny, int nx, float sigma, float tau,
                  float lt, float theta, int iso, int nonneg, int bf16, int iters,
                  int first, int last, cudaStream_t stream) {
  if (static_cast<long long>(nz) * ny * nx == 0 || iters == 0) return 0;
  const Args a{data, u, {p1, p2, p3}, u_out, {p1_out, p2_out, p3_out},
               nz, ny, nx, iters, sigma, tau, lt, theta,
               iso, nonneg, first, last};
  if (bf16) return iso ? launch_wave<__nv_bfloat16, true>(a, stream)
                      : launch_wave<__nv_bfloat16, false>(a, stream);
  return iso ? launch_wave<float, true>(a, stream) : launch_wave<float, false>(a, stream);
}

}  // extern "C"
