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
//   K1p shear_fp_packed_kernel   <- projector_pallas.py _shear_fp_packed_kernel
//   K4p unshear_bp_packed_kernel <- projector_pallas.py _unshear_bp_packed_kernel
//   (K1p/K4p: the pair for one slice, nz == 1; see their own note below)
//
// Design.  Every kernel is a gather, so none needs atomics and every
// result is deterministic.  The TPU kernels scattered with lane rolls and
// banded MXU matmuls (bf16x3 operand split); here every tap is an fp32 load
// and an fp32 multiply-add.  In K2 and K3 one thread owns one output
// element.  K1 and K4 are built for this card (each has its own note above
// it).  The y-driven angle group runs K1 on one transposed copy of the
// volume (as the JAX package does) and K4 with y and x swapped by index
// mapping.
//
// What bounds them on an H100.  K1 and K4 do two taps of two products and
// two sums for each (angle, slice, row, u) term and read every volume or q
// element many times, so they are bound by operations (fp32 instruction
// and shared-memory load rate), not by HBM traffic.  K2 and K3 read at most
// two taps per output and are bound by HBM traffic on their inputs and
// outputs.  Neighbouring threads sit on neighbouring u (K1, K3), t (K2) or
// column (K4), so the loads of a warp coalesce.
//
// Float semantics follow the Pallas kernels: the row shift is
// shift = beta * (r - cy) in fp32, o = U0 - floor(shift), f = shift - floor;
// detector positions are pos = (U0 + gamma) + alpha * t in fp32.  Every
// multiply and add is rounded on its own (the __f*_rn intrinsics stop nvcc
// from contracting them into FMAs) and sums run in the plain versions'
// order, so K2 and K3 compute bit-identical hat weights and stay exact
// transposes, and each kernel can be held to its plain version tightly.

#include <climits>

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

// (1-f) a + f b as lerp_taps, with g = 1 - f taken once per (angle, row)
__device__ __forceinline__ float lerp_taps_g(float g, float f, float a, float b) {
  return __fadd_rn(__fmul_rn(g, a), __fmul_rn(f, b));
}

// ---------------------------------------------------------------------------
// K1: s[a, z, u] = sum_r (1-f) row_r[u-o] + f row_r[u-o+1], rows zero
// outside [0, row_len), over the n_rows driven rows of every slice,
// rows[(z * n_rows + r) * row_len + c].  The y-driven group is given the
// transposed volume, so both groups read rows that lie along memory.
//
// What bounds it.  A group of 91 angles x 8 slices x 2560 rows has
// 4.8e9 (angle, slice, row, u) terms of two products and two sums (rounded
// one by one, so no FMA): operations, 0.29 ms at the card's fp32 peak,
// against 0.07 ms for reading the volume and writing s once.  Each term also
// needs its two taps, and the shift (o, f) of its (angle, row).  A thread
// that owns one output and fetches every tap through L1 spends ~30
// instructions per term; the design below spends the two shared-memory loads
// and the four roundings, and spreads the rest over many terms.  What is
// left is the rate of shared-memory loads (two 4-byte loads per term):
//
//  * A block owns kK1Tile = 256 consecutive u of up to kK1A = 8 consecutive
//    angles (one warp each) of one slice.  A thread owns kK1U = 8 u-values
//    32 apart (a warp covers 32 consecutive ones, so its shared-memory
//    reads are conflict-free): the row shift is computed once for 8 terms,
//    and every tap is read with an immediate offset from one address per
//    row.  (Tiles of 2, 4 or 8 slices per block, which reuse the shift
//    further, were no faster: the loads, not the shift, set the pace.)
//  * The driven rows go by in bands of kK1R = 8.  For each band the block
//    stages the part of the 8 rows its taps can touch (j from u0 - max o
//    to u0 + 256 - min o over its angles) with 16-byte cp.async copies that
//    zero-fill outside the rows; the window start is rounded down to a
//    multiple of 4 so that source and destination are 16-byte aligned.  Two
//    buffers: the copies of band b + 1 are in flight while band b is
//    summed, one barrier per band.
//  * Before the loop every thread works out the windows of a few bands
//    (o_r is monotone in r, so the band's first and last row bound its
//    shifts) into shared memory, together with the first and last band whose
//    window meets the rows at all: LU is more than twice the 2561 live taps
//    of a row, so most (block, band) pairs have nothing to add and are
//    never visited.
//  * The angles of a block must shift a row by similar amounts, or the
//    window does not fit.  A driven group is a few runs of neighbouring
//    angles (the x-driven group of a 180 degree scan is [0, pi/4] and
//    [3pi/4, pi), with beta jumping from -1 to +1 between them), so angle
//    tiles never span a jump of beta larger than kK1Jump: every block finds
//    its tile's angle range by a scan of beta (up to kK1Splits jumps are
//    honoured, and the grid has that many spare tiles, which exit at once).
//  * A band whose window is still wider than kK1W (sparse angles), or any
//    band when rows are not 16-byte aligned (row_len % 4 != 0), is summed
//    from global memory with the same arithmetic.
//
// Per output the rows are summed in ascending r with lerp_taps' rounding,
// and a zero-filled tap adds +0, so K1 equals its plain version bit for bit.
// ---------------------------------------------------------------------------

constexpr int kK1U = 8;             // u-values per thread
constexpr int kK1Tile = 32 * kK1U;  // u per block
constexpr int kK1A = 8;             // angles per block, one warp each
constexpr int kK1R = 8;             // driven rows per band
constexpr int kK1W = 768;           // staged window, floats per row
constexpr int kK1Buf = kK1R * kK1W; // one window buffer, floats
constexpr int kK1Threads = 32 * kK1A;
constexpr float kK1Jump = 0.5f;     // |beta[a] - beta[a-1]| that ends an angle tile
constexpr int kK1Splits = 8;        // such jumps honoured per group

// Angle range [a0, a1) of angle tile `tile`: the angles are cut at the first
// kK1Splits jumps of beta, each run into tiles of kK1A.  Every lane of the
// calling warp returns the same range; a tile past the last one is empty.
__device__ __forceinline__ void k1_angle_tile(const float* __restrict__ beta,
                                              int A, int tile, int& a0, int& a1) {
  int start = 0, tiles_before = 0, splits = 0;
  for (int base = 0; base < A && splits < kK1Splits; base += 32) {
    const int a = base + static_cast<int>(threadIdx.x);
    const bool jump = a > 0 && a < A && fabsf(beta[a] - beta[a - 1]) > kK1Jump;
    unsigned m = __ballot_sync(0xffffffffu, jump);
    while (m != 0 && splits < kK1Splits) {
      const int j = base + __ffs(m) - 1;  // the run [start, j) ends here
      m &= m - 1;
      ++splits;
      const int n_tiles = (j - start + kK1A - 1) / kK1A;
      if (tile < tiles_before + n_tiles) {
        a0 = start + (tile - tiles_before) * kK1A;
        a1 = min(a0 + kK1A, j);
        return;
      }
      tiles_before += n_tiles;
      start = j;
    }
  }
  a0 = min(start + (tile - tiles_before) * kK1A, A);  // the last run [start, A)
  a1 = min(a0 + kK1A, A);
}

// 16-byte asynchronous copy to shared memory; bytes beyond `bytes` (0 or
// 16) are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// start the copies of band b's window (lo4, w4 from `bounds`) of slice
// `slice` (n_rows x row_len) into `dst`, laid out [row of the band][kK1W]
__device__ __forceinline__ void k1_stage(const float* __restrict__ slice,
                                         float* dst, const int* bounds, int b,
                                         int n_rows, int row_len) {
  const int w4 = bounds[2 * b + 1];
  if (w4 <= 0) return;  // skipped, or summed from global memory
  const int lo4 = bounds[2 * b];
  const int n_chunks = w4 >> 2;
  for (int i = threadIdx.y; i < kK1R; i += kK1A) {
    const int r = b * kK1R + i;
    const bool row_ok = r < n_rows;
    const float* src = slice + static_cast<long long>(row_ok ? r : 0) * row_len;
    float* d = dst + i * kK1W;
    for (int c = threadIdx.x; c < n_chunks; c += 32) {
      const int j = lo4 + 4 * c;  // j % 4 == 0 and row_len % 4 == 0
      const bool ok = row_ok && j >= 0 && j < row_len;
      cp_async16(d + 4 * c, ok ? src + j : slice, ok ? 16 : 0);
    }
  }
}

// Thread (x, y) of a block: angle a_base + y of angle tile blockIdx.y,
// slice blockIdx.z, u = u0 + x + 32 k for k < kK1U.  Dynamic shared memory:
// two window buffers of kK1Buf floats, then (lo4, w4) per band.
__global__ void __launch_bounds__(kK1Threads, 4)
shear_fp_kernel(const float* __restrict__ rows, const float* __restrict__ beta,
                float* __restrict__ s, int A, int nz, int n_rows, int row_len,
                int U0, int LU, int aligned) {
  extern __shared__ __align__(16) float k1_smem[];
  int* bounds = reinterpret_cast<int*>(k1_smem + 2 * kK1Buf);
  __shared__ int live_bands[2];  // first and last band with a tap in the rows
  __shared__ int angle_tile[2];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int u0 = blockIdx.x * kK1Tile;
  const int z = blockIdx.z;
  const float* slice = rows + static_cast<long long>(z) * n_rows * row_len;
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  const int n_bands = (n_rows + kK1R - 1) / kK1R;
  if (threadIdx.y == 0) {
    int a0, a1;
    k1_angle_tile(beta, A, blockIdx.y, a0, a1);
    if (threadIdx.x == 0) {
      angle_tile[0] = a0;
      angle_tile[1] = a1;
      live_bands[0] = n_bands;
      live_bands[1] = -1;
    }
  }
  __syncthreads();
  const int a_base = angle_tile[0];
  const int a_end = angle_tile[1];
  if (a_base >= a_end) return;  // a spare tile
  const int a = a_base + threadIdx.y;
  const bool live = a < a_end;
  const float b_a = live ? beta[a] : 0.f;

  for (int b = tid; b < n_bands; b += kK1Threads) {
    int omin = INT_MAX, omax = INT_MIN;
    for (int k = a_base; k < a_end; ++k) {
      const float bk = beta[k];
      int o;
      float f;
      row_shift(bk, b * kK1R, cy, U0, o, f);
      omin = min(omin, o);
      omax = max(omax, o);
      row_shift(bk, b * kK1R + kK1R - 1, cy, U0, o, f);
      omin = min(omin, o);
      omax = max(omax, o);
    }
    const int lo = u0 - omax;            // lowest tap j = u - o of the block
    const int hi = u0 + kK1Tile - omin;  // highest tap j + 1
    const int lo4 = lo & ~3;             // floor to a multiple of 4
    int w4 = (hi - lo4 + 4) & ~3;        // hi - lo4 + 1 rounded up to 4
    if (hi < 0 || lo >= row_len) {
      w4 = 0;  // every tap is outside the rows
    } else {
      atomicMin(&live_bands[0], b);
      atomicMax(&live_bands[1], b);
      if (!aligned || w4 > kK1W) w4 = -1;
    }
    bounds[2 * b] = lo4;
    bounds[2 * b + 1] = w4;
  }
  __syncthreads();
  const int b_first = live_bands[0];
  const int b_last = live_bands[1];

  float acc[kK1U];
#pragma unroll
  for (int k = 0; k < kK1U; ++k) acc[k] = 0.f;

  if (b_first <= b_last) k1_stage(slice, k1_smem, bounds, b_first, n_rows, row_len);
  cp_async_commit();
  for (int b = b_first; b <= b_last; ++b) {
    const int parity = (b - b_first) & 1;
    cp_async_wait_all();
    __syncthreads();  // band b has landed; band b - 1's buffer is free
    if (b < b_last)
      k1_stage(slice, k1_smem + (parity ^ 1) * kK1Buf, bounds, b + 1, n_rows, row_len);
    cp_async_commit();
    const int w4 = bounds[2 * b + 1];
    if (w4 == 0 || !live) continue;
    const int r0 = b * kK1R;
    if (w4 > 0) {
      const float* win = k1_smem + parity * kK1Buf + (u0 + threadIdx.x - bounds[2 * b]);
#pragma unroll
      for (int i = 0; i < kK1R; ++i) {
        int o;
        float f;
        row_shift(b_a, r0 + i, cy, U0, o, f);
        const float g = __fsub_rn(1.f, f);
        const float* w = win + i * kK1W - o;  // tap j of u0 + x
#pragma unroll
        for (int k = 0; k < kK1U; ++k)
          acc[k] = __fadd_rn(acc[k], lerp_taps_g(g, f, w[32 * k], w[32 * k + 1]));
      }
    } else {
      for (int i = 0; i < kK1R && r0 + i < n_rows; ++i) {
        int o;
        float f;
        row_shift(b_a, r0 + i, cy, U0, o, f);
        const float g = __fsub_rn(1.f, f);
        const int j0 = u0 + threadIdx.x - o;
        const float* row = slice + static_cast<long long>(r0 + i) * row_len;
#pragma unroll
        for (int k = 0; k < kK1U; ++k) {
          const int j = j0 + 32 * k;
          // j = -1 is the f * row[0] tap (the Pallas kernel's wrapped roll lane)
          const float v0 = (j >= 0 && j < row_len) ? row[j] : 0.f;
          const float v1 = (j + 1 >= 0 && j + 1 < row_len) ? row[j + 1] : 0.f;
          acc[k] = __fadd_rn(acc[k], lerp_taps_g(g, f, v0, v1));
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kK1U; ++k) {
      const int u = u0 + threadIdx.x + 32 * k;
      if (u < LU) s[(static_cast<long long>(a) * nz + z) * LU + u] = acc[k];
    }
  }
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

// ---------------------------------------------------------------------------
// K4: vol[z, Y, X] (+)= sum_a (1-f) q[a, z, o+col] + f q[a, z, o+col-1]
// with (row, col) = (Y, X), or (X, Y) for the swapped (y-driven) group, over
// the n_rows driven rows of row_len columns of every slice.
//
// What bounds it.  The same count of terms as K1 (a group of 91 angles x 8
// slices x 2560^2 voxels: 4.8e9 terms of two products and two sums, rounded
// one by one), 0.29 ms at the card's fp32 peak against 0.06 ms for reading q
// and writing the volume once.  A thread that owns one voxel and fetches
// both taps through L1 with a row shift of its own for every angle spends
// ~30 instructions per term.  The design below is K1's, turned round: the
// block walks the angles, not the rows.
//
//  * A block owns kK4R = 8 consecutive driven rows (one warp each) x
//    kK4C = 256 columns of Z slices (two where nz is even, else one).  A thread owns kK4J = 8 columns 32
//    apart (a warp covers 32 consecutive ones, so its shared-memory reads
//    are conflict-free) and computes the row shift once per (row, angle) for
//    all of them and for every slice of the block.
//  * The angles go by in batches of kK4AZ / Z.  For one angle the block's 8 rows
//    read one window of q: the shifts o_r of 8 consecutive rows differ by at
//    most 8 when |beta| <= 1, so kK4C + 9 values.  The block stages the
//    windows of a batch with 16-byte cp.async copies that zero-fill outside
//    [0, LU); the window start is rounded down to a multiple of 4 so that
//    source and destination are 16-byte aligned.  Two buffers: the copies of
//    batch b + 1 are in flight while batch b is summed, one barrier per
//    batch.  The threads that share an angle's copies work out its window
//    once per batch.
//  * An angle whose window does not fit (|beta| > 1, never from the
//    driven-group split), or every angle when q's lines are not 16-byte
//    aligned (LU % 4 != 0), is summed from global memory with the same
//    arithmetic.  Rows past n_rows and columns past row_len are masked.
//  * The y-driven group writes vol[z, col, row] (no transpose is made): the
//    block turns its 8 x 256 tile in shared memory and every thread stores
//    runs of 8 rows, whole 32-byte sectors, instead of 4 bytes of each.
//
// Per voxel the angles are summed in ascending order with lerp_taps'
// rounding, and a zero-filled tap adds +0, so K4 equals its plain version
// bit for bit and stays the exact transpose of K1.
//
// On an NVIDIA H100 80GB HBM3 at 700 W the two groups of an OS subset of
// the 1801 x 8 x 2560^2 flagship take 1.52 / 1.60 ms (x- / y-driven)
// against 4.58 / 4.54 ms for one thread per voxel: the two 4-byte shared-
// memory loads per term set the pace, as in K1 (1.3 ms at the full rate of
// 32 lanes per clock and SM).  One slice per block took 1.65 / 1.73 ms, four
// no less than two, 4 columns per thread 1.94 / 2.10 ms, 64 windows per
// batch (one block per SM) 2.22 / 2.41 ms, and the y-driven group's store
// without the turn 1.96 ms (2.42 against 1.73 ms when it adds into the
// volume).
// ---------------------------------------------------------------------------

constexpr int kK4R = 8;              // driven rows per block, one warp each
constexpr int kK4J = 8;              // columns per thread
constexpr int kK4C = 32 * kK4J;      // columns per block
constexpr int kK4AZ = 32;            // windows (angles x slices) staged per batch
constexpr int kK4W = kK4C + 16;      // q window per angle, floats
constexpr int kK4Threads = 32 * kK4R;
constexpr int kK4Buf = kK4AZ * kK4W;  // one window buffer, floats
constexpr int kK4Global = INT_MIN;   // base of an angle that is read from global memory
static_assert(kK4Buf >= kK4C * (kK4R + 1), "the turned tile must fit a window buffer");
static_assert(kK4Threads % kK4AZ == 0 && kK4AZ % 2 == 0 && kK4R % 4 == 0,
              "thread and store layout");

// start the copies of angle batch b's windows into `dst`, laid out
// [slice of the block][angle of the batch][kK4W], and note each angle's
// beta and window start u (base[i], or kK4Global) for the threads that sum
template <int Z>
__device__ __forceinline__ void k4_stage(const float* __restrict__ q,
                                         const float* __restrict__ beta,
                                         float* dst, float* sbeta, int* base,
                                         int b, int A, int nz, int z0, int LU,
                                         int r0, int c0, float cy, int U0,
                                         int aligned) {
  constexpr int kK4A = kK4AZ / Z;          // angles per batch
  constexpr int kPer = kK4Threads / kK4A;  // threads that share an angle
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int i = tid / kPer;
  const int a = b * kK4A + i;
  if (a >= A) return;
  const float bt = beta[a];
  int o_first, o_last;
  float f;
  row_shift(bt, r0, cy, U0, o_first, f);
  row_shift(bt, r0 + kK4R - 1, cy, U0, o_last, f);
  // taps u - 1 and u of u = o + col: from min o + c0 - 1 to max o + c0 + kK4C - 1
  const int lo4 = (min(o_first, o_last) + c0 - 1) & ~3;
  const bool fits = aligned && max(o_first, o_last) + c0 + kK4C - 1 - lo4 < kK4W;
  if (tid % kPer == 0) {
    sbeta[i] = bt;
    base[i] = fits ? lo4 : kK4Global;
  }
  if (!fits) return;
  for (int zz = 0; zz < Z; ++zz) {  // Z divides nz
    const float* line = q + (static_cast<long long>(a) * nz + z0 + zz) * LU;
    float* d = dst + (zz * kK4A + i) * kK4W;
    for (int c = tid % kPer; c < kK4W / 4; c += kPer) {
      const int u = lo4 + 4 * c;  // u % 4 == 0 and LU % 4 == 0
      const bool ok = u >= 0 && u < LU;
      cp_async16(d + 4 * c, ok ? line + u : q, ok ? 16 : 0);
    }
  }
}

// Thread (x, y) of a block: driven row r0 + y, columns c0 + x + 32 k for
// k < kK4J, slices z0 .. z0 + Z - 1.  Dynamic shared memory: two window
// buffers of kK4Buf floats (the first is reused to turn the tile of the
// y-driven group), then beta and the window start per angle of a batch,
// twice.
template <int Z>
__global__ void __launch_bounds__(kK4Threads)
unshear_bp_kernel(const float* __restrict__ q, const float* __restrict__ beta,
                  float* __restrict__ vol, int A, int nz, int ny, int nx,
                  int LU, int U0, int swap, int accumulate, int aligned,
                  int vol_aligned) {
  extern __shared__ __align__(16) float k4_smem[];
  constexpr int kK4A = kK4AZ / Z;  // angles per batch
  float* sbeta = k4_smem + 2 * kK4Buf;
  int* sbase = reinterpret_cast<int*>(sbeta + 2 * kK4A);
  const int n_rows = swap ? nx : ny;
  const int row_len = swap ? ny : nx;
  const int c0 = blockIdx.x * kK4C;
  const int r0 = blockIdx.y * kK4R;
  const int z0 = blockIdx.z * Z;
  const int row = r0 + threadIdx.y;
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  const int n_batches = (A + kK4A - 1) / kK4A;

  float acc[Z][kK4J];
#pragma unroll
  for (int zz = 0; zz < Z; ++zz)
#pragma unroll
    for (int k = 0; k < kK4J; ++k) acc[zz][k] = 0.f;

  if (n_batches > 0)
    k4_stage<Z>(q, beta, k4_smem, sbeta, sbase, 0, A, nz, z0, LU, r0, c0, cy, U0, aligned);
  cp_async_commit();
  for (int b = 0; b < n_batches; ++b) {
    const int parity = b & 1;
    cp_async_wait_all();
    __syncthreads();  // batch b has landed; batch b - 1's buffer is free
    if (b + 1 < n_batches)
      k4_stage<Z>(q, beta, k4_smem + (parity ^ 1) * kK4Buf, sbeta + (parity ^ 1) * kK4A,
               sbase + (parity ^ 1) * kK4A, b + 1, A, nz, z0, LU, r0, c0, cy, U0, aligned);
    cp_async_commit();
    const int na = min(kK4A, A - b * kK4A);
    const float* buf = k4_smem + parity * kK4Buf;
    for (int i = 0; i < na; ++i) {
      int o;
      float f;
      row_shift(sbeta[parity * kK4A + i], row, cy, U0, o, f);
      const float g = __fsub_rn(1.f, f);
      const int u = o + c0 + static_cast<int>(threadIdx.x);  // tap u of column c0 + x
      const int lo4 = sbase[parity * kK4A + i];
      if (lo4 != kK4Global) {
        const float* w = buf + i * kK4W + (u - lo4);
#pragma unroll
        for (int zz = 0; zz < Z; ++zz)
#pragma unroll
          for (int k = 0; k < kK4J; ++k)
            acc[zz][k] = __fadd_rn(acc[zz][k],
                                   lerp_taps_g(g, f, w[zz * kK4A * kK4W + 32 * k],
                                               w[zz * kK4A * kK4W + 32 * k - 1]));
      } else {
#pragma unroll
        for (int zz = 0; zz < Z; ++zz) {
          const float* line = q + (static_cast<long long>(b * kK4A + i) * nz + z0 + zz) * LU;
#pragma unroll
          for (int k = 0; k < kK4J; ++k) {
            const int uk = u + 32 * k;
            const float q0 = (uk >= 0 && uk < LU) ? line[uk] : 0.f;
            const float q1 = (uk >= 1 && uk - 1 < LU) ? line[uk - 1] : 0.f;
            acc[zz][k] = __fadd_rn(acc[zz][k], lerp_taps_g(g, f, q0, q1));
          }
        }
      }
    }
  }

  const long long slice = static_cast<long long>(ny) * nx;
  if (!swap) {
    if (row >= n_rows) return;
#pragma unroll
    for (int zz = 0; zz < Z; ++zz) {
      float* out = vol + (z0 + zz) * slice + static_cast<long long>(row) * nx;
#pragma unroll
      for (int k = 0; k < kK4J; ++k) {
        const int col = c0 + threadIdx.x + 32 * k;
        if (col < row_len) out[col] = accumulate ? __fadd_rn(out[col], acc[zz][k]) : acc[zz][k];
      }
    }
    return;
  }
  // y-driven: vol[z, col, row].  Turn the tile in shared memory, [col][row]
  // with rows padded to kK4R + 1 floats, then thread t stores the kK4R rows
  // of column c0 + t, which lie along memory.
  float* turn = k4_smem;
  const int tid = threadIdx.y * 32 + threadIdx.x;
#pragma unroll
  for (int zz = 0; zz < Z; ++zz) {
    __syncthreads();  // the last batch, or the slice before, has been read
#pragma unroll
    for (int k = 0; k < kK4J; ++k)
      turn[(threadIdx.x + 32 * k) * (kK4R + 1) + threadIdx.y] = acc[zz][k];
    __syncthreads();
    const int col = c0 + tid;
    if (col >= row_len) continue;
    float* out = vol + (z0 + zz) * slice + static_cast<long long>(col) * nx + r0;
    const float* t = turn + tid * (kK4R + 1);
    if (vol_aligned && r0 + kK4R <= n_rows) {  // nx % 4 == 0: 16-byte stores
#pragma unroll
      for (int i = 0; i < kK4R; i += 4) {
        float4 v = make_float4(t[i], t[i + 1], t[i + 2], t[i + 3]);
        float4* o4 = reinterpret_cast<float4*>(out + i);
        if (accumulate) {
          const float4 old = *o4;
          v = make_float4(__fadd_rn(old.x, v.x), __fadd_rn(old.y, v.y),
                          __fadd_rn(old.z, v.z), __fadd_rn(old.w, v.w));
        }
        *o4 = v;
      }
    } else {
      for (int i = 0; i < kK4R && r0 + i < n_rows; ++i)
        out[i] = accumulate ? __fadd_rn(out[i], t[i]) : t[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K1p / K4p: the pair for one slice (nz == 1), driven rows in bands of 8.
//
// They compute K1's and K4's sums at nz == 1 in the same order and with the
// same rounding, so each equals its plain version (and K1/K4) bit for bit
// and the nz == 1 pair stays an exact adjoint with K2/K3.  The Pallas
// kernels packed 8 image rows onto the sublanes and placed each row's two
// taps with a one-hot MXU matmul and a strided lane roll (K4p on d-rolled
// copies of q); none of that has a counterpart here.  What carries over is
// the unit of work: a band of 8 consecutive driven rows, whose shifts o_r
// differ by at most 8 for one angle (|beta| <= 1).
//
// What bounds them.  Per (row, angle, output) term both do two shared-
// memory loads and five fp32 operations; a thread that owns one output adds
// a global (L1) load pair and the row shift o, f of the (row, angle) to
// every term and takes ~30 instructions per term.  The shift is the same
// for every output of a row and an angle, so here a thread owns kPJ outputs
// 32 apart (a warp
// covers 32 consecutive ones, so shared-memory reads are conflict-free),
// computes the shift once and reuses it kPJ times.  The kernels are bound
// by issue rate; device memory sees each row band or q window once per
// block.
//
// K1p: a block owns 32 * kPJ u-values of 8 consecutive angles (one warp
// per angle).  Per band it stages in shared memory, with coalesced loads,
// the part of the 8 rows its taps can touch (j from u0 - max o to
// u0 + 32 kPJ - min o over its angles), and every tap is read from there.
// Neighbouring angles shift a row by similar amounts, so the window is a
// little wider than the u-tile; where it would exceed kP1W (a block that
// straddles the two ends of the x-driven group) that band is read from
// global memory with the same arithmetic.  Bands whose window misses the
// rows add nothing and are skipped.  The caller passes the y-driven group
// the transposed slice, so its loads coalesce like the x-driven group's
// (as K1's wrapper gives K1 the transposed volume).
//
// K4p: a block owns an 8-row x 32 kPJ4-column tile, one warp per row.
// For one angle the tile's 8 rows read one window of q of width
// 32 kPJ4 + 9 (the Pallas kernel's ten diagonals); the block stages the
// windows of kP4A angles in shared memory with coalesced loads, then sums
// from there.  A step whose shifts would not fit the window (|beta| > 1,
// never from the driven-group split) reads q from global memory instead.
// The y-driven group writes vol[col, row] (K4's index mapping), so no
// transpose is made.

constexpr int kPJ = 4;              // K1p: u-values per thread
constexpr int kP1U = 32 * kPJ;      // K1p: u per block
constexpr int kP1W = 1024;          // K1p: staged row window, floats per row
constexpr int kPJ4 = 8;             // K4p: columns per thread
constexpr int kP4C = 32 * kPJ4;     // K4p: columns per block
constexpr int kP4A = 32;            // K4p: angles staged per step
constexpr int kP4W = kP4C + 16;     // K4p: q window per angle (kP4C + 9 used)

// K1p: s[a, u] = sum_r (1-f) row_r[u-o] + f row_r[u-o+1] over the n_rows
// rows of one slice, rows[r * row_len + c] (n_rows % 8 == 0).  Thread
// (x, y) of a block: angle a_base + y, u = u0 + x + 32 k for k < kPJ.
__global__ void __launch_bounds__(256)
shear_fp_packed_kernel(const float* __restrict__ rows,
                       const float* __restrict__ beta, float* __restrict__ s,
                       int A, int n_rows, int row_len, int U0, int LU) {
  __shared__ float win[8][kP1W];
  // window bounds [lo, hi] of j per band, double-buffered by band parity
  // so that a band which is skipped needs no second barrier
  __shared__ int bounds[2][2];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int u0 = blockIdx.x * kP1U;
  const int a_base = blockIdx.y * 8;
  const int a = a_base + threadIdx.y;
  const bool live = a < A;
  const float b = live ? beta[a] : 0.f;
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  float acc[kPJ];
#pragma unroll
  for (int k = 0; k < kPJ; ++k) acc[k] = 0.f;
  for (int r0 = 0; r0 < n_rows; r0 += 8) {
    int* bd = bounds[(r0 >> 3) & 1];
    if (tid < 32) {
      // lanes 2k, 2k+1: angle a_base + k at the band's first and last row;
      // o_r is monotone in r, so they bound the band's shifts
      const int k = tid >> 1;
      int omin = INT_MAX, omax = INT_MIN;
      if (k < 8 && a_base + k < A) {
        int o;
        float f;
        row_shift(beta[a_base + k], r0 + (tid & 1) * 7, cy, U0, o, f);
        omin = omax = o;
      }
      for (int m = 16; m > 0; m >>= 1) {
        omin = min(omin, __shfl_xor_sync(0xffffffffu, omin, m));
        omax = max(omax, __shfl_xor_sync(0xffffffffu, omax, m));
      }
      if (tid == 0) {
        bd[0] = u0 - omax;         // lowest tap j = u - o of the block
        bd[1] = u0 + kP1U - omin;  // highest tap j + 1
      }
    }
    __syncthreads();
    const int lo = bd[0], hi = bd[1];
    if (hi < 0 || lo >= row_len) continue;  // every tap is outside the rows
    const int width = hi - lo + 1;
    const bool staged = width <= kP1W;
    const float* band = rows + static_cast<long long>(r0) * row_len;
    if (staged) {
      for (int k = tid; k < 8 * width; k += 256) {
        const int i = k / width;
        const int c = k - i * width;
        const int j = lo + c;
        win[i][c] = (j >= 0 && j < row_len)
                        ? band[static_cast<long long>(i) * row_len + j]
                        : 0.f;
      }
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < 8; ++i) {
        int o;
        float f;
        row_shift(b, r0 + i, cy, U0, o, f);
        const int j0 = u0 + threadIdx.x - o;  // tap j of u0 + x
        if (staged) {
          const float* w = &win[i][j0 - lo];
#pragma unroll
          for (int k = 0; k < kPJ; ++k)
            acc[k] = __fadd_rn(acc[k], lerp_taps(f, w[32 * k], w[32 * k + 1]));
        } else {
          // j = -1 is the f * row[0] tap, as in K1
          const float* row = band + static_cast<long long>(i) * row_len;
#pragma unroll
          for (int k = 0; k < kPJ; ++k) {
            const int j = j0 + 32 * k;
            const float v0 = (j >= 0 && j < row_len) ? row[j] : 0.f;
            const float v1 = (j + 1 >= 0 && j + 1 < row_len) ? row[j + 1] : 0.f;
            acc[k] = __fadd_rn(acc[k], lerp_taps(f, v0, v1));
          }
        }
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kPJ; ++k) {
      const int u = u0 + threadIdx.x + 32 * k;
      if (u < LU) s[static_cast<long long>(a) * LU + u] = acc[k];
    }
  }
}

// K4p: vol[row, col] (+)= sum_a (1-f) q[a, o+col] + f q[a, o+col-1] on one
// n x n slice (n % 8 == 0), written to vol[col, row] for the y-driven group.
// Thread (x, y) of a block: row r0 + y, col = c0 + x + 32 k for k < kPJ4.
__global__ void __launch_bounds__(256)
unshear_bp_packed_kernel(const float* __restrict__ q,
                         const float* __restrict__ beta,
                         float* __restrict__ vol, int A, int n, int LU,
                         int U0, int swap, int accumulate) {
  __shared__ float win[kP4A][kP4W];
  __shared__ float sbeta[kP4A];
  __shared__ int base[kP4A];  // u of win[ia][0]
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int c0 = blockIdx.x * kP4C;
  const int row = blockIdx.y * 8 + threadIdx.y;
  const float cy = 0.5f * static_cast<float>(n - 1);
  float acc[kPJ4];
#pragma unroll
  for (int k = 0; k < kPJ4; ++k) acc[k] = 0.f;
  for (int a0 = 0; a0 < A; a0 += kP4A) {
    const int na = min(kP4A, A - a0);
    bool too_wide = false;
    if (tid < na) {
      const float b = beta[a0 + tid];
      int o_first, o_last;
      float f;
      row_shift(b, blockIdx.y * 8, cy, U0, o_first, f);
      row_shift(b, blockIdx.y * 8 + 7, cy, U0, o_last, f);
      sbeta[tid] = b;
      base[tid] = min(o_first, o_last) + c0 - 1;
      too_wide = abs(o_last - o_first) > kP4W - kP4C - 1;
    }
    const bool wide = __syncthreads_or(too_wide);
    if (!wide) {
      for (int k = tid; k < na * kP4W; k += 256) {
        const int ia = k / kP4W;
        const int w = k - ia * kP4W;
        const int u = base[ia] + w;
        win[ia][w] = (u >= 0 && u < LU)
                         ? q[static_cast<long long>(a0 + ia) * LU + u]
                         : 0.f;
      }
    }
    __syncthreads();
    for (int ia = 0; ia < na; ++ia) {
      int o;
      float f;
      row_shift(sbeta[ia], row, cy, U0, o, f);
      const int u = o + c0 + threadIdx.x;  // tap u of column c0 + x
      if (!wide) {
        const float* w = &win[ia][u - base[ia]];
#pragma unroll
        for (int k = 0; k < kPJ4; ++k)
          acc[k] = __fadd_rn(acc[k], lerp_taps(f, w[32 * k], w[32 * k - 1]));
      } else {
        const float* line = q + static_cast<long long>(a0 + ia) * LU;
#pragma unroll
        for (int k = 0; k < kPJ4; ++k) {
          const int uk = u + 32 * k;
          const float q0 = (uk >= 0 && uk < LU) ? line[uk] : 0.f;
          const float q1 = (uk >= 1 && uk - 1 < LU) ? line[uk - 1] : 0.f;
          acc[k] = __fadd_rn(acc[k], lerp_taps(f, q0, q1));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPJ4; ++k) {
    const int col = c0 + threadIdx.x + 32 * k;
    if (col < n) {
      const long long idx = swap ? static_cast<long long>(col) * n + row
                                 : static_cast<long long>(row) * n + col;
      vol[idx] = accumulate ? __fadd_rn(vol[idx], acc[k]) : acc[k];
    }
  }
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tt_shear_fp(const float* rows, const float* beta, float* s, int A, int nz,
                int n_rows, int row_len, int U0, int LU, cudaStream_t stream) {
  if (A == 0 || nz == 0 || LU == 0) return 0;
  const int aligned =
      row_len % 4 == 0 && reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  const int n_bands = (n_rows + kK1R - 1) / kK1R;
  const size_t smem =
      sizeof(float) * 2 * kK1Buf + sizeof(int) * 2 * static_cast<size_t>(n_bands);
  // angle tiles: kK1Splits spare ones for the jumps of beta
  const dim3 grid((LU + kK1Tile - 1) / kK1Tile, (A + kK1A - 1) / kK1A + kK1Splits, nz);
  if (smem > 227 * 1024 || grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      shear_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shear_fp_kernel<<<grid, dim3(32, kK1A), smem, stream>>>(
      rows, beta, s, A, nz, n_rows, row_len, U0, LU, aligned);
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
  if (static_cast<long long>(nz) * ny * nx == 0) return 0;
  const int aligned =
      LU % 4 == 0 && reinterpret_cast<unsigned long long>(q) % 16 == 0;
  const int vol_aligned =
      nx % 4 == 0 && reinterpret_cast<unsigned long long>(vol) % 16 == 0;
  const int n_rows = swap ? nx : ny, row_len = swap ? ny : nx;
  // two slices per block where that wastes none; the row shift serves both
  const int Z = nz % 2 == 0 ? 2 : 1;
  const size_t smem = sizeof(float) * (2 * kK4Buf + 2 * kK4AZ) + sizeof(int) * 2 * kK4AZ;
  const dim3 grid((row_len + kK4C - 1) / kK4C, (n_rows + kK4R - 1) / kK4R, nz / Z);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = Z == 2 ? unshear_bp_kernel<2> : unshear_bp_kernel<1>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, dim3(32, kK4R), smem, stream>>>(
      q, beta, vol, A, nz, ny, nx, LU, U0, swap, accumulate, aligned, vol_aligned);
  return static_cast<int>(cudaGetLastError());
}

int tt_shear_fp_packed(const float* rows, const float* beta, float* s, int A,
                       int n_rows, int row_len, int U0, int LU,
                       cudaStream_t stream) {
  if (A == 0 || LU == 0) return 0;
  const dim3 grid((LU + kP1U - 1) / kP1U, (A + 7) / 8);
  shear_fp_packed_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      rows, beta, s, A, n_rows, row_len, U0, LU);
  return static_cast<int>(cudaGetLastError());
}

int tt_unshear_bp_packed(const float* q, const float* beta, float* vol, int A,
                         int n, int LU, int U0, int swap, int accumulate,
                         cudaStream_t stream) {
  if (n == 0) return 0;
  const dim3 grid((n + kP4C - 1) / kP4C, n / 8);
  unshear_bp_packed_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      q, beta, vol, A, n, LU, U0, swap, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
