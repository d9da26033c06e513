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
// and an fp32 multiply-add.  In K2 one thread owns one output element.  K1,
// K3 and K4 are built for this card (each has its own note above it).  The y-driven angle group runs K1 on one transposed copy of the
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
// transposes, and each kernel can be held to its plain version tightly
// (K1, K3, K4, K1p and K4p bit for bit).

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

__device__ __forceinline__ float hat(float pos, int u) {
  return fmaxf(0.f, 1.f - fabsf(__fsub_rn(pos, static_cast<float>(u))));
}

// (1-f) a + f b with every product and sum rounded on its own (no FMA), in
// the order the plain PyTorch versions evaluate it; g = 1 - f is taken once
// per (angle, row)
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
//  * A block owns 32 kK1U = 256 consecutive u of up to kK1A = 8 consecutive
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
// Per output the rows are summed in ascending r with lerp_taps_g's rounding,
// and a zero-filled tap adds +0, so K1 equals its plain version bit for bit.
// ---------------------------------------------------------------------------

constexpr int kK1U = 8;             // u-values per thread
constexpr int kK1A = 8;             // angles per block, one warp each
constexpr int kK1R = 8;             // driven rows per band
constexpr int kK1W = 768;           // staged window, floats per row
constexpr float kK1Jump = 0.5f;     // |beta[a] - beta[a-1]| that ends an angle tile
constexpr int kK1Splits = 8;        // such jumps honoured per group

// The shape of a block: K1 and K1p run one schedule at their own sizes.
template <int U_, int A_, int R_, int W_>
struct ShearShape {
  static constexpr int kU = U_;           // u-values per thread
  static constexpr int kTile = 32 * U_;   // u per block
  static constexpr int kA = A_;           // angles per block, one warp each
  static constexpr int kR = R_;           // driven rows per band
  static constexpr int kW = W_;           // staged window, floats per row
  static constexpr int kBuf = R_ * W_;    // one window buffer, floats
  static constexpr int kThreads = 32 * A_;
};
using K1Shape = ShearShape<kK1U, kK1A, kK1R, kK1W>;

// Angle range [a0, a1) of angle tile `tile`: the angles are cut at the first
// kK1Splits jumps of beta, each run into tiles of kA.  Every lane of the
// calling warp returns the same range; a tile past the last one is empty.
template <int kA>
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
      const int n_tiles = (j - start + kA - 1) / kA;
      if (tile < tiles_before + n_tiles) {
        a0 = start + (tile - tiles_before) * kA;
        a1 = min(a0 + kA, j);
        return;
      }
      tiles_before += n_tiles;
      start = j;
    }
  }
  a0 = min(start + (tile - tiles_before) * kA, A);  // the last run [start, A)
  a1 = min(a0 + kA, A);
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
// `slice` (n_rows x row_len) into `dst`, laid out [row of the band][kW]
template <class S>
__device__ __forceinline__ void k1_stage(const float* __restrict__ slice,
                                         float* dst, const int* bounds, int b,
                                         int n_rows, int row_len) {
  const int w4 = bounds[2 * b + 1];
  if (w4 <= 0) return;  // skipped, or summed from global memory
  const int lo4 = bounds[2 * b];
  const int n_chunks = w4 >> 2;
  for (int i = threadIdx.y; i < S::kR; i += S::kA) {
    const int r = b * S::kR + i;
    const bool row_ok = r < n_rows;
    const float* src = slice + static_cast<long long>(row_ok ? r : 0) * row_len;
    float* d = dst + i * S::kW;
    for (int c = threadIdx.x; c < n_chunks; c += 32) {
      const int j = lo4 + 4 * c;  // j % 4 == 0 and row_len % 4 == 0
      const bool ok = row_ok && j >= 0 && j < row_len;
      cp_async16(d + 4 * c, ok ? src + j : slice, ok ? 16 : 0);
    }
  }
}

// One block of the shear sum: thread (x, y) is angle a_base + y of angle
// tile `tile`, u = u0 + x + 32 k for k < kU, and sums the bands
// [band_lo, band_hi) of `slice` (n_rows x row_len) in ascending order into
// out[a * out_stride + u].  `smem`: two window buffers of kBuf floats, then
// (lo4, w4) per band of the slice.
template <class S>
__device__ __forceinline__ void shear_fp_block(
    const float* __restrict__ slice, const float* __restrict__ beta,
    float* __restrict__ out, long long out_stride, int A, int tile, int n_rows,
    int row_len, int U0, int LU, int aligned, int band_lo, int band_hi, float* smem) {
  int* bounds = reinterpret_cast<int*>(smem + 2 * S::kBuf);
  __shared__ int live_bands[2];  // first and last band with a tap in the rows
  __shared__ int angle_tile[2];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int u0 = blockIdx.x * S::kTile;
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  if (threadIdx.y == 0) {
    int a0, a1;
    k1_angle_tile<S::kA>(beta, A, tile, a0, a1);
    if (threadIdx.x == 0) {
      angle_tile[0] = a0;
      angle_tile[1] = a1;
      live_bands[0] = band_hi;
      live_bands[1] = band_lo - 1;
    }
  }
  __syncthreads();
  const int a_base = angle_tile[0];
  const int a_end = angle_tile[1];
  if (a_base >= a_end) return;  // a spare tile
  const int a = a_base + threadIdx.y;
  const bool live = a < a_end;
  const float b_a = live ? beta[a] : 0.f;

  for (int b = band_lo + tid; b < band_hi; b += S::kThreads) {
    int omin = INT_MAX, omax = INT_MIN;
    for (int k = a_base; k < a_end; ++k) {
      const float bk = beta[k];
      int o;
      float f;
      row_shift(bk, b * S::kR, cy, U0, o, f);
      omin = min(omin, o);
      omax = max(omax, o);
      row_shift(bk, b * S::kR + S::kR - 1, cy, U0, o, f);
      omin = min(omin, o);
      omax = max(omax, o);
    }
    const int lo = u0 - omax;             // lowest tap j = u - o of the block
    const int hi = u0 + S::kTile - omin;  // highest tap j + 1
    const int lo4 = lo & ~3;              // floor to a multiple of 4
    int w4 = (hi - lo4 + 4) & ~3;         // hi - lo4 + 1 rounded up to 4
    if (hi < 0 || lo >= row_len) {
      w4 = 0;  // every tap is outside the rows
    } else {
      atomicMin(&live_bands[0], b);
      atomicMax(&live_bands[1], b);
      if (!aligned || w4 > S::kW) w4 = -1;
    }
    bounds[2 * b] = lo4;
    bounds[2 * b + 1] = w4;
  }
  __syncthreads();
  const int b_first = live_bands[0];
  const int b_last = live_bands[1];

  float acc[S::kU];
#pragma unroll
  for (int k = 0; k < S::kU; ++k) acc[k] = 0.f;

  if (b_first <= b_last) k1_stage<S>(slice, smem, bounds, b_first, n_rows, row_len);
  cp_async_commit();
  for (int b = b_first; b <= b_last; ++b) {
    const int parity = (b - b_first) & 1;
    cp_async_wait_all();
    __syncthreads();  // band b has landed; band b - 1's buffer is free
    if (b < b_last)
      k1_stage<S>(slice, smem + (parity ^ 1) * S::kBuf, bounds, b + 1, n_rows, row_len);
    cp_async_commit();
    const int w4 = bounds[2 * b + 1];
    if (w4 == 0 || !live) continue;
    const int r0 = b * S::kR;
    if (w4 > 0) {
      const float* win = smem + parity * S::kBuf + (u0 + threadIdx.x - bounds[2 * b]);
#pragma unroll
      for (int i = 0; i < S::kR; ++i) {
        int o;
        float f;
        row_shift(b_a, r0 + i, cy, U0, o, f);
        const float g = __fsub_rn(1.f, f);
        const float* w = win + i * S::kW - o;  // tap j of u0 + x
#pragma unroll
        for (int k = 0; k < S::kU; ++k)
          acc[k] = __fadd_rn(acc[k], lerp_taps_g(g, f, w[32 * k], w[32 * k + 1]));
      }
    } else {
      for (int i = 0; i < S::kR && r0 + i < n_rows; ++i) {
        int o;
        float f;
        row_shift(b_a, r0 + i, cy, U0, o, f);
        const float g = __fsub_rn(1.f, f);
        const int j0 = u0 + threadIdx.x - o;
        const float* row = slice + static_cast<long long>(r0 + i) * row_len;
#pragma unroll
        for (int k = 0; k < S::kU; ++k) {
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
    for (int k = 0; k < S::kU; ++k) {
      const int u = u0 + threadIdx.x + 32 * k;
      if (u < LU) out[a * out_stride + u] = acc[k];
    }
  }
}

// K1: angle tile blockIdx.y, slice blockIdx.z, every band of the slice.
__global__ void __launch_bounds__(K1Shape::kThreads, 4)
shear_fp_kernel(const float* __restrict__ rows, const float* __restrict__ beta,
                float* __restrict__ s, int A, int nz, int n_rows, int row_len,
                int U0, int LU, int aligned) {
  extern __shared__ __align__(16) float k1_smem[];
  const int z = blockIdx.z;
  const int n_bands = (n_rows + K1Shape::kR - 1) / K1Shape::kR;
  shear_fp_block<K1Shape>(rows + static_cast<long long>(z) * n_rows * row_len, beta,
                          s + static_cast<long long>(z) * LU,
                          static_cast<long long>(nz) * LU, A, blockIdx.y, n_rows,
                          row_len, U0, LU, aligned, 0, n_bands, k1_smem);
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

// ---------------------------------------------------------------------------
// K3: q[a, z, u] = |alpha| sum_{t < det_x} p[z, row_a, t] hat(pos_t - u), the
// exact transpose of K2.  row_a is a, or index[a] when the caller hands over
// the whole sinogram (n_rows angles) and the group's angle positions in it:
// the kernel then gathers the group's rows itself, and no copy of them is
// made before the launch.  An index[a] outside [0, n_rows) traps: the launch
// fails, and the host reads nothing back to check.
//
// What bounds it: bytes.  A group of 91 angles x 8 slices reads 7.5 MB of p
// and writes 16.8 MB of q, 7 us at the card's memory rate, against 3 us for
// its arithmetic.  So the design spends as little as it can beside the
// store:
//
//  * A block owns kThreads * kK3V consecutive u of one (angle, slice) line
//    (blockIdx.x is the line, blockIdx.y the tile of u), so the angle's
//    alpha, base = U0 + gamma and row are found without a division per
//    output.
//  * A thread owns kK3V = 4 consecutive u and stores them as one float4
//    (LU is a multiple of 128 from driven_params; any other LU, or a q that
//    is not 16-byte aligned, takes scalar stores).
//  * pos_t is monotone in t, so the u that any t reaches are
//    [floor(min pos), ceil(max pos)], found from t = 0 and t = det_x - 1:
//    a thread outside that range stores its zeros with no arithmetic (38%
//    of the line at 2560 columns and LU 5760).
//  * The t that reach a thread's four u are one short run (at most 5 /
//    |alpha| + 1, |alpha| >= 1).  The thread walks it once, in ascending t
//    from one float division: position, floor and the two hat weights are
//    computed once per t, and the two weighted taps go to the u they belong
//    to, i = floor(pos) and i + 1, as the plain version scatters them.
//
// Each u gets its (at most two) terms in ascending t, every product and sum
// rounded on its own with K2's weights, so K3 equals its plain version bit
// for bit (a sum of two terms from +0 does not depend on their order).
//
// On an NVIDIA H100 80GB HBM3 at 700 W, on the device alone (calls replayed
// from a CUDA graph; enqueued one by one from Python a call takes 0.020-0.026
// ms of the host's time, more than the kernel), a group of 91 angles x 8
// slices x LU 5760 from 2560 columns takes 0.011 ms on its own rows and
// 0.011-0.012 ms gathering them through `index` (bound 0.007 ms), against
// 0.025 ms for the design before it (a thread per u with four candidate t,
// 4-byte stores, two 64-bit divisions per output) and 0.036 ms for that
// design after the indexed copy of the group's angles, which every launch
// then needed; one slice 0.003-0.004 against 0.005 / 0.007 ms.
// ---------------------------------------------------------------------------

constexpr int kK3V = 4;  // consecutive u per thread, one 16-byte store

__global__ void __launch_bounds__(kThreads)
resample_bp_kernel(const float* __restrict__ p, const float* __restrict__ alpha,
                   const float* __restrict__ gamma,
                   const long long* __restrict__ index, float* __restrict__ q,
                   int nz, int n_rows, int LU, int det_x, int U0, int vec) {
  const int line = blockIdx.x;  // a * nz + z
  const int a = line / nz;
  const int z = line - a * nz;
  const int u0 = (blockIdx.y * kThreads + threadIdx.x) * kK3V;
  if (u0 >= LU) return;
  const float al = alpha[a];
  const float aa = fabsf(al);
  const float base = __fadd_rn(static_cast<float>(U0), gamma[a]);
  float acc[kK3V];
#pragma unroll
  for (int k = 0; k < kK3V; ++k) acc[k] = 0.f;
  const float p_first = det_pos(base, al, 0);
  const float p_last = det_pos(base, al, det_x - 1);
  const int u_lo = static_cast<int>(floorf(fminf(p_first, p_last)));
  const int u_hi = static_cast<int>(ceilf(fmaxf(p_first, p_last)));
  if (det_x > 0 && u0 + kK3V - 1 >= u_lo && u0 <= u_hi) {
    const long long row = index != nullptr ? index[a] : a;
    if (row < 0 || row >= n_rows) __trap();  // the launch fails, nothing is read
    const float* src = p + (static_cast<long long>(z) * n_rows + row) * det_x;
    const bool up = al > 0.f;  // pos rises with t
    // positions in (u0 - 1, u0 + kK3V) reach the thread's u; the first t
    // that can lie there, less one for the rounding of the division
    const float edge = static_cast<float>(up ? u0 - 1 : u0 + kK3V);
    int t = max(static_cast<int>(floorf((edge - base) / al)) - 1, 0);
    for (; t < det_x; ++t) {
      const float pos = det_pos(base, al, t);
      if (up ? pos >= static_cast<float>(u0 + kK3V) : pos <= static_cast<float>(u0 - 1))
        break;
      const int d = static_cast<int>(floorf(pos)) - u0;  // taps u0 + d and u0 + d + 1
      if (d < -1 || d >= kK3V) continue;
      const float v = src[t];
      const float w0 = hat(pos, u0 + d);
      const float w1 = hat(pos, u0 + d + 1);
      const float c0 = __fmul_rn(__fmul_rn(aa, w0), v);
      const float c1 = __fmul_rn(__fmul_rn(aa, w1), v);
#pragma unroll
      for (int k = 0; k < kK3V; ++k) {
        if (d == k && w0 > 0.f) acc[k] = __fadd_rn(acc[k], c0);
        if (d + 1 == k && w1 > 0.f) acc[k] = __fadd_rn(acc[k], c1);
      }
    }
  }
  float* out = q + static_cast<long long>(line) * LU + u0;
  if (vec) {  // LU % 4 == 0 and q 16-byte aligned
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kK3V; ++k)
      if (u0 + k < LU) out[k] = acc[k];
  }
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
//    32 kK4J = 256 columns of Z slices (two where nz is even, else one).  A thread owns kK4J = 8 columns 32
//    apart (a warp covers 32 consecutive ones, so its shared-memory reads
//    are conflict-free) and computes the row shift once per (row, angle) for
//    all of them and for every slice of the block.
//  * The angles go by in batches of kK4AZ / Z.  For one angle the block's 8 rows
//    read one window of q: the shifts o_r of 8 consecutive rows differ by at
//    most 8 when |beta| <= 1, so 256 + 9 values.  The block stages the
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
// Per voxel the angles are summed in ascending order with lerp_taps_g's
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
constexpr int kK4AZ = 32;            // windows (angles x slices) staged per batch
constexpr int kK4Global = INT_MIN;   // base of an angle that is read from global memory

// The shape of a block: K4 and K4p run one schedule at their own sizes.  A
// window lies in shared memory as in q, and a thread owns kJ columns 32 apart
// (two 4-byte loads per term).
template <int R_, int J_, int AZ_>
struct UnshearShape {
  static constexpr int kR = R_;            // driven rows per block, one warp each
  static constexpr int kJ = J_;            // columns per thread
  static constexpr int kC = 32 * J_;       // columns per block
  static constexpr int kAZ = AZ_;          // windows (angles x slices) per batch
  // taps of R_ rows whose shifts differ by at most R_, from a start rounded
  // down to a multiple of 4: kC + R_ + 4 values at most
  static constexpr int kW = kC + 2 * R_;   // q window per angle, floats
  static constexpr int kThreads = 32 * R_;
  static constexpr int kBuf = AZ_ * kW;   // one window buffer, floats
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kBuf + 2 * AZ_) + sizeof(int) * 2 * AZ_;
  static_assert(2 * R_ >= R_ + 4 && kW % 4 == 0, "window width");
  static_assert(kBuf >= kC * (R_ + 1), "the turned tile must fit a window buffer");
  static_assert(kThreads % AZ_ == 0 && AZ_ % 2 == 0 && R_ % 4 == 0 && J_ % 4 == 0,
                "thread and store layout");
  // column of the tile that thread x holds in acc[k]
  __device__ static __forceinline__ int col(int x, int k) {
    return x + 32 * k;
  }
};
using K4Shape = UnshearShape<kK4R, kK4J, kK4AZ>;

// window of one angle for the rows r0 .. r0 + kR - 1 of column tile c0: its
// start lo4 (a multiple of 4), and whether it fits the staged width
template <class S>
__device__ __forceinline__ bool k4_window(float bt, int r0, int c0, float cy,
                                          int U0, int aligned, int& lo4) {
  int o_first, o_last;
  float f;
  row_shift(bt, r0, cy, U0, o_first, f);
  row_shift(bt, r0 + S::kR - 1, cy, U0, o_last, f);
  // taps u - 1 and u of u = o + col: from min o + c0 - 1 to max o + c0 + kC - 1
  lo4 = (min(o_first, o_last) + c0 - 1) & ~3;
  return aligned && max(o_first, o_last) + c0 + S::kC - 1 - lo4 < S::kW;
}

// start the copies of angle batch b's windows into `dst`, laid out
// [slice of the block][angle of the batch][kW], and note each angle's
// beta and window start u (base[i], or kK4Global) for the threads that sum
template <class S, int Z>
__device__ __forceinline__ void k4_stage(const float* __restrict__ q,
                                         const float* __restrict__ beta,
                                         float* dst, float* sbeta, int* base,
                                         int b, int A, int nz, int z0, int LU,
                                         int r0, int c0, float cy, int U0,
                                         int aligned) {
  constexpr int kA = S::kAZ / Z;  // angles per batch
  constexpr int kPer = S::kThreads / kA;  // threads that share an angle, 16 bytes each
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int i = tid / kPer;
  const int a = b * kA + i;
  if (a >= A) return;
  const float bt = beta[a];
  int lo4;
  const bool fits = k4_window<S>(bt, r0, c0, cy, U0, aligned, lo4);
  if (tid % kPer == 0) {
    sbeta[i] = bt;
    base[i] = fits ? lo4 : kK4Global;
  }
  if (!fits) return;
  for (int zz = 0; zz < Z; ++zz) {  // Z divides nz
    const float* line = q + (static_cast<long long>(a) * nz + z0 + zz) * LU;
    float* d = dst + (zz * kA + i) * S::kW;
    for (int c = tid % kPer; c < S::kW / 4; c += kPer) {
      const int u = lo4 + 4 * c;  // u % 4 == 0 and LU % 4 == 0
      const bool ok = u >= 0 && u < LU;
      cp_async16(d + 4 * c, ok ? line + u : q, ok ? 16 : 0);
    }
  }
}

// One block of the unshear sum.  Thread (x, y): driven row r0 + y, columns
// c0 + S::col(x, k) for k < kJ, slices z0 .. z0 + Z - 1.  `smem`: two window
// buffers of kBuf floats (the first is reused to turn the tile of the
// y-driven group), then beta and the window start per angle of a batch,
// twice.
template <class S, int Z>
__device__ __forceinline__ void unshear_bp_block(
    const float* __restrict__ q, const float* __restrict__ beta,
    float* __restrict__ vol, int A, int nz, int ny, int nx, int LU, int U0,
    int swap, int accumulate, int aligned, int vol_aligned, float* smem) {
  constexpr int kA = S::kAZ / Z;  // angles per batch
  float* sbeta = smem + 2 * S::kBuf;
  int* sbase = reinterpret_cast<int*>(sbeta + 2 * kA);
  const int n_rows = swap ? nx : ny;
  const int row_len = swap ? ny : nx;
  const int c0 = blockIdx.x * S::kC;
  const int r0 = blockIdx.y * S::kR;
  const int z0 = blockIdx.z * Z;
  const int row = r0 + threadIdx.y;
  const float cy = 0.5f * static_cast<float>(n_rows - 1);
  const int n_batches = (A + kA - 1) / kA;

  float acc[Z][S::kJ];
#pragma unroll
  for (int zz = 0; zz < Z; ++zz)
#pragma unroll
    for (int k = 0; k < S::kJ; ++k) acc[zz][k] = 0.f;

  if (n_batches > 0)
    k4_stage<S, Z>(q, beta, smem, sbeta, sbase, 0, A, nz, z0, LU, r0, c0, cy, U0, aligned);
  cp_async_commit();
  for (int b = 0; b < n_batches; ++b) {
    const int parity = b & 1;
    cp_async_wait_all();
    __syncthreads();  // batch b has landed; batch b - 1's buffer is free
    if (b + 1 < n_batches)
      k4_stage<S, Z>(q, beta, smem + (parity ^ 1) * S::kBuf, sbeta + (parity ^ 1) * kA,
                     sbase + (parity ^ 1) * kA, b + 1, A, nz, z0, LU, r0, c0, cy, U0, aligned);
    cp_async_commit();
    const int na = min(kA, A - b * kA);
    const float* buf = smem + parity * S::kBuf;
    for (int i = 0; i < na; ++i) {
      int o;
      float f;
      row_shift(sbeta[parity * kA + i], row, cy, U0, o, f);
      const float g = __fsub_rn(1.f, f);
      const int lo4 = sbase[parity * kA + i];
      if (lo4 != kK4Global) {
        // tap u of column c0 + x
        const float* w = buf + i * S::kW + (o + c0 + static_cast<int>(threadIdx.x) - lo4);
#pragma unroll
        for (int zz = 0; zz < Z; ++zz)
#pragma unroll
          for (int k = 0; k < S::kJ; ++k)
            acc[zz][k] = __fadd_rn(acc[zz][k],
                                   lerp_taps_g(g, f, w[zz * kA * S::kW + 32 * k],
                                               w[zz * kA * S::kW + 32 * k - 1]));
      } else {
#pragma unroll
        for (int zz = 0; zz < Z; ++zz) {
          const float* line = q + (static_cast<long long>(b * kA + i) * nz + z0 + zz) * LU;
#pragma unroll
          for (int k = 0; k < S::kJ; ++k) {
            const int uk = o + c0 + S::col(threadIdx.x, k);
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
      for (int k = 0; k < S::kJ; ++k) {
        const int col = c0 + S::col(threadIdx.x, k);
        if (col < row_len) out[col] = accumulate ? __fadd_rn(out[col], acc[zz][k]) : acc[zz][k];
      }
    }
    return;
  }
  // y-driven: vol[z, col, row].  Turn the tile in shared memory: acc[k] of
  // thread (x, y) goes to turn[x + 32 k][y], rows padded to kR + 1 floats
  // (conflict-free); then a thread takes one entry and stores the kR rows of
  // its column, which lie along memory.
  float* turn = smem;
  const int tid = threadIdx.y * 32 + threadIdx.x;
#pragma unroll
  for (int zz = 0; zz < Z; ++zz) {
    __syncthreads();  // the last batch, or the slice before, has been read
#pragma unroll
    for (int k = 0; k < S::kJ; ++k)
      turn[(threadIdx.x + 32 * k) * (S::kR + 1) + threadIdx.y] = acc[zz][k];
    __syncthreads();
    for (int e = tid; e < S::kC; e += S::kThreads) {
      const int col = c0 + S::col(e % 32, e / 32);
      if (col >= row_len) continue;
      float* out = vol + (z0 + zz) * slice + static_cast<long long>(col) * nx + r0;
      const float* t = turn + e * (S::kR + 1);
      if (vol_aligned && r0 + S::kR <= n_rows) {  // nx % 4 == 0: 16-byte stores
#pragma unroll
        for (int i = 0; i < S::kR; i += 4) {
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
        for (int i = 0; i < S::kR && r0 + i < n_rows; ++i)
          out[i] = accumulate ? __fadd_rn(out[i], t[i]) : t[i];
      }
    }
  }
}

// K4: column tile blockIdx.x, row tile blockIdx.y, Z slices from Z blockIdx.z
template <int Z>
__global__ void __launch_bounds__(K4Shape::kThreads)
unshear_bp_kernel(const float* __restrict__ q, const float* __restrict__ beta,
                  float* __restrict__ vol, int A, int nz, int ny, int nx,
                  int LU, int U0, int swap, int accumulate, int aligned,
                  int vol_aligned) {
  extern __shared__ __align__(16) float k4_smem[];
  unshear_bp_block<K4Shape, Z>(q, beta, vol, A, nz, ny, nx, LU, U0, swap, accumulate,
                               aligned, vol_aligned, k4_smem);
}

// ---------------------------------------------------------------------------
// K1p / K4p: the pair for one slice (nz == 1), driven rows in bands of 8.
//
// They compute K1's and K4's sums at nz == 1 with the same rounding of every
// term, so the nz == 1 pair stays an exact adjoint with K2/K3.  The Pallas
// kernels packed 8 image rows onto the sublanes and placed each row's two
// taps with a one-hot MXU matmul and a strided lane roll (K4p on d-rolled
// copies of q); none of that has a counterpart here.  What carries over is
// the unit of work: a band of 8 consecutive driven rows, whose shifts o_r
// differ by at most 8 for one angle (|beta| <= 1).
//
// K1p.  What bounds it: one slice gives K1's schedule too few blocks.  A
// group of 91 angles x 2560 rows x LU 5888 is 23 u-tiles x 12 angle tiles =
// 276 blocks of 8 warps, and fewer than half of them have any live band
// (LU is over twice a row's live taps): ~4 warps per scheduler on 132 SMs,
// each waiting for its own shared-memory loads, so K1 at nz == 1 runs at a
// quarter of the instruction rate it reaches on 8 slices.  A block per (u-tile,
// angle tile) cannot be made smaller without losing what makes K1 fast
// (one row shift for a thread's 8 terms, a staged window shared by 8
// angles), so K1p keeps K1's block (shear_fp_block: zero-filling 16-byte
// cp.async into two window buffers, one barrier per band, the live bands
// and their windows worked out before the loop, angle tiles that end at
// the jumps of beta) and takes its parallelism from the rows:
//
//  * The driven rows are cut into `splits` runs of whole bands
//    (blockIdx.z); a block sums one run in ascending order into a partial
//    u-line, partial[split][a][u].
//  * A second pass adds the partials in ascending order of the run,
//    s = ((p0 + p1) + p2) + ..., one thread per output.  The order is fixed,
//    so the result is the same from run to run; it is the plain version's
//    order when that is given the same `splits` (one run is K1's single
//    ascending sum, bit for bit).
//  * The caller passes the y-driven group the transposed slice, so its
//    loads lie along memory like the x-driven group's (as K1's wrapper
//    gives K1 the transposed volume).
//
// On an NVIDIA H100 80GB HBM3 at 700 W a group of 91 angles of one 2560^2
// slice takes 0.52 ms in 1 run, 0.49 in 2, 0.33 in 4, 0.29 in 8 and 0.28 in
// 16 (the kernel before it, 128 u per block staged with scalar loads:
// 1.20 ms); a group of 901 angles 2.38 / 2.25 / 2.22 / 2.28 / 2.43 ms (4.75
// before): there the card is full without runs.  The wrapper takes up to 8
// runs for at most 256 angles, 4 above.  A 512-float window with 6 blocks
// per SM took 0.39 ms against 0.33 (4 runs).
//
// K4p.  What bounds it: operations, as K4 (a group of 91 angles on one
// 2560^2 slice is 6.0e8 terms, 0.036 ms at the card's fp32 peak), and with
// one slice there is no second slice to share a row shift with and only 91
// angles to hide a block's start and its store behind.  K4p is K4's block
// (unshear_bp_block: zero-filling cp.async windows in two buffers, one
// barrier per batch of angles, the window start rounded to 16 bytes, angles
// with |beta| > 1 and unaligned lines from global memory, the y-driven
// tile turned in shared memory and stored as whole sectors, adding into a
// volume) at its own sizes, K4pShape: a thread owns 16 columns 32 apart, so
// the row shift of a (row, angle), the part of the loop that is not loads
// and roundings, is spent once for 16 terms as K4 spends it for its two
// slices; 512 columns per block tile 2560 columns exactly; 16 angles per
// batch keep three blocks of 8 warps on an SM.
//
// On an NVIDIA H100 80GB HBM3 at 700 W a group of 91 angles of one 2560^2
// slice takes 0.206 / 0.218 ms (x- / y-driven; K4 on the same input 0.216 /
// 0.227, the kernel before this one 0.287 / 0.334: scalar staging with a
// division per element, two barriers per step, 4 bytes of each sector in
// the y-driven store) and a group of 901 angles 1.97 / 1.98 ms (K4 2.07 /
// 2.09, before 2.76 / 2.82).  At K4's own sizes (8 columns per thread, 32
// angles per batch) it took 0.219 / 0.229 ms, 20 columns per thread 0.212 /
// 0.224, 16 rows per block 0.240 / 0.253.  What sets the pace is the
// instruction rate, not the shared-memory loads alone: per 16 terms 64
// roundings (no FMA: the bits are the plain version's), 32 loads and ~14
// for the shift.  Two designs that spend fewer of one kind were built and
// timed, and lost:
//
//  * A window in planes, 8 consecutive columns per thread: a thread owns
//    8 consecutive columns, so a (row, angle) needs 9 consecutive values of
//    q for 8 terms instead of 16.  Read as they lie, the 8-float stride
//    between lanes would hit 4 banks; so window element w is stored in
//    plane w % 8 at index w / 8, and the lanes of a warp (one row: the same
//    shift for all) read consecutive words of one plane.  Which plane holds
//    the first tap is the same for the whole warp, so a switch over its 8
//    values gives every load an immediate offset.  The staging writes
//    4-byte elements (a warp per angle, 32 consecutive w to 32 banks).
//    Bit-equal as the other layout, and slower: 0.303 / 0.310 ms, 2.96 /
//    2.97 at 901 angles (four times as many copies as with
//    16 bytes each, every one with its bounds test, and the switch's branch).
//    Not kept in the source.
//  * A table of the batch's shifts, worked out by one thread per (row,
//    angle) while the batch is staged and read back as 8 bytes: 0.232 /
//    0.241 ms at 8 columns per thread against 0.220 / 0.231 without (the
//    load sits at the head of every dependent chain).  Not kept in the
//    source.
//
// The sum per voxel stays in ascending angle order with lerp_taps_g's rounding:
// K4p equals its plain version (and K4) bit for bit.

constexpr int kP1U = 8;             // K1p: u-values per thread
constexpr int kP1A = 8;             // K1p: angles per block, one warp each
constexpr int kP1R = 8;             // K1p: driven rows per band
constexpr int kP1W = 768;           // K1p: staged row window, floats per row
constexpr int kP1Blocks = 4;        // K1p: blocks an SM is asked to hold
using K1pShape = ShearShape<kP1U, kP1A, kP1R, kP1W>;
constexpr int kP4R = 8;             // K4p: driven rows per block, one warp each
constexpr int kP4J = 16;            // K4p: columns per thread
constexpr int kP4A = 16;            // K4p: angles staged per batch
constexpr int kP4Blocks = 1;        // K4p: blocks an SM is asked to hold at least
using K4pShape = UnshearShape<kP4R, kP4J, kP4A>;

// K1p, first pass: part[split, a, u] = sum over the rows of run `split`
// (bands [split * bands_per_split, ...)) of (1-f) row_r[u-o] + f row_r[u-o+1]
// on one slice rows[r * row_len + c].  Angle tile blockIdx.y, run blockIdx.z.
__global__ void __launch_bounds__(K1pShape::kThreads, kP1Blocks)
shear_fp_packed_kernel(const float* __restrict__ rows,
                       const float* __restrict__ beta, float* __restrict__ part,
                       int A, int n_rows, int row_len, int U0, int LU,
                       int aligned, int bands_per_split) {
  extern __shared__ __align__(16) float k1p_smem[];
  const int n_bands = (n_rows + K1pShape::kR - 1) / K1pShape::kR;
  const int band_lo = min(static_cast<int>(blockIdx.z) * bands_per_split, n_bands);
  const int band_hi = min(band_lo + bands_per_split, n_bands);
  shear_fp_block<K1pShape>(rows, beta,
                           part + static_cast<long long>(blockIdx.z) * A * LU, LU, A,
                           blockIdx.y, n_rows, row_len, U0, LU, aligned, band_lo,
                           band_hi, k1p_smem);
}

// K1p, second pass: s[i] = ((part[0][i] + part[1][i]) + ...) over the runs
__global__ void shear_fp_packed_sum_kernel(const float* __restrict__ part,
                                           float* __restrict__ s, long long n,
                                           int splits) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int k = 1; k < splits; ++k) acc = __fadd_rn(acc, part[k * n + i]);
  s[i] = acc;
}

// K4p: vol[row, col] (+)= sum_a (1-f) q[a, o+col] + f q[a, o+col-1] on one
// n x n slice, written to vol[col, row] for the y-driven group: K4's block on
// one slice, column tile blockIdx.x, row tile blockIdx.y.
__global__ void __launch_bounds__(K4pShape::kThreads, kP4Blocks)
unshear_bp_packed_kernel(const float* __restrict__ q,
                         const float* __restrict__ beta,
                         float* __restrict__ vol, int A, int n, int LU,
                         int U0, int swap, int accumulate, int aligned,
                         int vol_aligned) {
  extern __shared__ __align__(16) float k4p_smem[];
  unshear_bp_block<K4pShape, 1>(q, beta, vol, A, 1, n, n, LU, U0, swap, accumulate,
                                aligned, vol_aligned, k4p_smem);
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
  using S = K1Shape;
  if (A == 0 || nz == 0 || LU == 0) return 0;
  const int aligned =
      row_len % 4 == 0 && reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  const int n_bands = (n_rows + S::kR - 1) / S::kR;
  const size_t smem =
      sizeof(float) * 2 * S::kBuf + sizeof(int) * 2 * static_cast<size_t>(n_bands);
  // angle tiles: kK1Splits spare ones for the jumps of beta
  const dim3 grid((LU + S::kTile - 1) / S::kTile, (A + S::kA - 1) / S::kA + kK1Splits, nz);
  if (smem > 227 * 1024 || grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      shear_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shear_fp_kernel<<<grid, dim3(32, S::kA), smem, stream>>>(
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

// `index`: null, or the rows of p (nz, n_rows, det_x) that are the A angles
int tt_resample_bp(const float* p, const float* alpha, const float* gamma,
                   const long long* index, float* q, int A, int nz, int n_rows,
                   int LU, int det_x, int U0, cudaStream_t stream) {
  const long long lines = static_cast<long long>(A) * nz;
  if (lines * LU == 0) return 0;
  const int vec = LU % kK3V == 0 && reinterpret_cast<unsigned long long>(q) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(lines),
                  (LU + kThreads * kK3V - 1) / (kThreads * kK3V));
  if (lines > INT_MAX || grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  resample_bp_kernel<<<grid, kThreads, 0, stream>>>(
      p, alpha, gamma, index, q, nz, n_rows, LU, det_x, U0, vec);
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
  using S = K4Shape;
  const size_t smem = S::kSmem;
  const dim3 grid((row_len + S::kC - 1) / S::kC, (n_rows + S::kR - 1) / S::kR, nz / Z);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = Z == 2 ? unshear_bp_kernel<2> : unshear_bp_kernel<1>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, dim3(32, S::kR), smem, stream>>>(
      q, beta, vol, A, nz, ny, nx, LU, U0, swap, accumulate, aligned, vol_aligned);
  return static_cast<int>(cudaGetLastError());
}

// rows per band of K1p: the runs of `splits` are whole bands
int tt_shear_fp_packed_band() { return K1pShape::kR; }

// `part`: scratch of splits * A * LU floats (not used when splits == 1).
// The runs are ceil(bands / splits) bands each, in order.
int tt_shear_fp_packed(const float* rows, const float* beta, float* s,
                       float* part, int A, int n_rows, int row_len, int U0,
                       int LU, int splits, cudaStream_t stream) {
  using S = K1pShape;
  if (A == 0 || LU == 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned =
      row_len % 4 == 0 && reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  const int n_bands = (n_rows + S::kR - 1) / S::kR;
  const int bands_per_split = (n_bands + splits - 1) / splits;
  const size_t smem =
      sizeof(float) * 2 * S::kBuf + sizeof(int) * 2 * static_cast<size_t>(n_bands);
  const dim3 grid((LU + S::kTile - 1) / S::kTile, (A + S::kA - 1) / S::kA + kK1Splits, splits);
  if (smem > 227 * 1024 || grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      shear_fp_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shear_fp_packed_kernel<<<grid, dim3(32, S::kA), smem, stream>>>(
      rows, beta, splits == 1 ? s : part, A, n_rows, row_len, U0, LU, aligned,
      bands_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(A) * LU;
  shear_fp_packed_sum_kernel<<<blocks_for(n), kThreads, 0, stream>>>(part, s, n, splits);
  return static_cast<int>(cudaGetLastError());
}

int tt_unshear_bp_packed(const float* q, const float* beta, float* vol, int A,
                         int n, int LU, int U0, int swap, int accumulate,
                         cudaStream_t stream) {
  using S = K4pShape;
  if (n == 0) return 0;
  const int aligned =
      LU % 4 == 0 && reinterpret_cast<unsigned long long>(q) % 16 == 0;
  const int vol_aligned =
      n % 4 == 0 && reinterpret_cast<unsigned long long>(vol) % 16 == 0;
  const dim3 grid((n + S::kC - 1) / S::kC, (n + S::kR - 1) / S::kR);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      unshear_bp_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  unshear_bp_packed_kernel<<<grid, dim3(32, S::kR), S::kSmem, stream>>>(
      q, beta, vol, A, n, LU, U0, swap, accumulate, aligned, vol_aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
