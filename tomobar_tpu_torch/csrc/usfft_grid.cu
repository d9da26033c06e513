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
//
// What bounds it on an H100.  The function reads the spectra and writes the
// grids once (0.29 ms at the flagship: 1801 angles x 2560 samples, m = 5,
// 4 z-pairs, 838 MB of grids); its arithmetic is 5.6e8 weights with an exp
// each and 4.5e9 multiply-adds, well under a millisecond.  A scatter (one
// thread per polar sample, an atomicAdd per tap, pair and channel) turns
// those 4.5e9 adds into reductions in device memory on a grid that does not
// fit the L2, and took 52 ms.  So, as the Pallas kernels do, the grid cell
// owns the sum, not the sample; what bounds the kernel now is the rate at
// which the tests that find a cell's samples are executed:
//
//  * A block owns a tile of kTileY x 32 cells of the grid for a batch of
//    kPairs z-pairs (blockIdx.y), a thread one cell, with its 2 kPairs sums
//    in registers, a warp one tile row.  Each cell is stored once with a
//    plain store: no atomics, no zero fill, and a fixed order of the sum
//    (by wrap-around copy, ascending angle, ascending r), so the same input
//    gives the same grid bit for bit.
//  * The samples of one angle lie on a line through the centre, two cells
//    apart: sample r sits at (2 rho cos, -2 rho sin), rho = r - n/2, in cell
//    units from the centre.  For its tile a block works out, one angle per
//    thread, the run [r_lo, r_hi) of samples whose footprint can meet the
//    tile (the intersection of two intervals in rho, widened by a cell and
//    a sample, so it is a superset whatever the rounding and the clamp), and
//    a block-wide prefix sum numbers the samples of all runs.
//  * A batch of kThreads samples is staged in shared memory: each thread
//    finds its sample's angle by bisection in the prefix sums, computes
//    x0, y0 and the footprint corner in the oracle's rounding and loads the
//    sample's g values.  The loads of the next batch are in flight while
//    this one is summed (registers now, shared memory after the loop; two
//    buffers, one barrier per batch).
//  * Every thread walks the batch: a sample counts where
//    e1 <= l1 <= e1 + 2m (the same for the whole warp, so a miss costs a
//    broadcast load, a compare and a branch) and e0 <= l0 <= e0 + 2m; then
//    the weight is computed as the oracle computes it (l/2n is the thread's
//    own constant) and g w is added for each pair and channel.
//  * Wrap-around.  Grid indices are mod(l + n, 2n) and a footprint at the
//    rim reaches l in [-n - m, n + m), so a tile within m cells of a border
//    also runs as its copies shifted by +-2n in that axis (up to four runs
//    for a corner tile; the sums go on in the same registers).
//  * Precision.  Every angle's samples meet at the centre (1e4 terms per
//    cell at the flagship), where a float32 running sum lost 3.3e-5 of the
//    grid's max.  Tiles that touch the centre square of half-width R
//    (l in [-R, R)) add with Kahan compensation, the others plainly (a cell
//    at radius rho sees ~6300/rho angles).
//  * Balance.  A tile at radius rho (cells) holds ~5e5/rho samples, a
//    centre tile every angle, 200 times the mean.  The wrapper hands the
//    blocks their tiles in order of distance from the centre, so the heavy
//    tiles start first and the light ones fill the tail.
//
// More z-pairs than kPairs are further blocks (blockIdx.y): the weights are
// computed once for the kPairs pairs of a block.
//
// On an NVIDIA H100 80GB HBM3 at 700 W one call at the flagship takes 6.9 ms
// against 52.4 ms for the scatter (28 z-pairs: 48 ms against 1.14 s), and
// the time goes with the samples: 900 angles take 3.7 ms, one angle 0.67 ms
// (the store of the grids and the tiles' set-up).  Tiles handed out in
// row-major order took 8.3 ms, centre last 11.4 ms, 32 x 16-cell tiles (two
// blocks per SM) 9.0 ms; without the compensated sums it takes 6.7 ms.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 4;    // z-pairs per block: one float4 per channel
constexpr int kTileX = 32;   // cells per tile row: one warp
constexpr int kTileY = 32;   // tile rows, one warp each
constexpr int kThreads = kTileX * kTileY;  // = samples per batch = angles per round
static_assert(kPairs == 4, "a sample's g values are staged as one float4 per channel");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "one warp per tile row");

struct Sample {
  int e0, e1;    // first tap of the footprint, l units (not wrapped)
  float x0, y0;  // position, in grid periods
};

struct Staged {
  Sample h;
  float4 re, im;
};

struct Args {
  const float* g_re;
  const float* g_im;
  const float* cos_t;
  const float* sin_t;
  float* f_re;
  float* f_im;
  const int* order;  // tile of block x, heavy tiles first
  int nz2, nproj, n, m, R;
  float coeff0, coeff1, clamp;
};

// rho with c2 * rho in [xa, xb]
__device__ __forceinline__ void rho_interval(float c2, float xa, float xb,
                                             float& lo, float& hi) {
  if (c2 == 0.f) {
    const bool all = xa <= 0.f && 0.f <= xb;
    lo = all ? -3.0e38f : 3.0e38f;
    hi = all ? 3.0e38f : -3.0e38f;
    return;
  }
  const float a = xa / c2, b = xb / c2;
  lo = fminf(a, b);
  hi = fmaxf(a, b);
}

// the run [r_lo, r_lo + count) of samples of one angle whose footprint can
// meet the cells [cl, ch] x [rl, rh] (l units, inclusive): a superset
__device__ __forceinline__ void sample_run(float cs, float sn, int n, int m,
                                           int cl, int ch, int rl, int rh,
                                           int& r_lo, int& count) {
  float lo0, hi0, lo1, hi1;
  // floor(X) in [cl - m, ch + m], one cell of margin for rounding and clamp
  rho_interval(2.f * cs, static_cast<float>(cl - m - 1), static_cast<float>(ch + m + 2), lo0, hi0);
  rho_interval(-2.f * sn, static_cast<float>(rl - m - 1), static_cast<float>(rh + m + 2), lo1, hi1);
  const float half = 0.5f * static_cast<float>(n);
  const float lo = fmaxf(fmaxf(lo0, lo1), -half - 1.f);
  const float hi = fminf(fminf(hi0, hi1), half + 1.f);
  r_lo = 0;
  count = 0;
  if (!(lo <= hi)) return;
  r_lo = max(static_cast<int>(floorf(lo + half)) - 1, 0);
  const int r_hi = min(static_cast<int>(floorf(hi + half)) + 2, n);
  count = max(r_hi - r_lo, 0);
}

// exclusive prefix sum of one value per thread over the block: offs[tid]
// and offs[kThreads] = total
__device__ __forceinline__ void block_scan(int v, int* offs, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kThreads / 32 ? warp_tot[lane] : 0;
    int s = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += up;
    }
    warp_tot[lane] = s - t;  // exclusive
    if (lane == 31) offs[kThreads] = s;
  }
  __syncthreads();
  offs[tid] = warp_tot[warp] + inc - v;
  __syncthreads();
}

// sample i of the round's runs, as it is staged
__device__ __forceinline__ Staged load_sample(const Args& a, int a_base, int i, int total,
                                              int p0, const int* rlo, const int* offs) {
  Staged s;
  s.h.e0 = s.h.e1 = INT_MIN / 2;
  s.h.x0 = s.h.y0 = 0.f;
  s.re = s.im = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= total) return s;
  int lo = 0, hi = kThreads;  // the last angle with offs[angle] <= i
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= i) lo = mid; else hi = mid;
  }
  const int ang = a_base + lo;
  const int r = rlo[lo] + (i - offs[lo]);
  const float nf = static_cast<float>(a.n);
  const float two_n_f = static_cast<float>(2 * a.n);
  const float c = __fdiv_rn(__fsub_rn(static_cast<float>(r), 0.5f * nf), nf);
  s.h.x0 = fminf(__fmul_rn(c, a.cos_t[ang]), a.clamp);
  s.h.y0 = fminf(__fmul_rn(-c, a.sin_t[ang]), a.clamp);
  s.h.e0 = static_cast<int>(floorf(__fmul_rn(two_n_f, s.h.x0))) - a.m;
  s.h.e1 = static_cast<int>(floorf(__fmul_rn(two_n_f, s.h.y0))) - a.m;
  const long long ns = static_cast<long long>(a.nproj) * a.n;
  const long long at = static_cast<long long>(ang) * a.n + r;
  float re[kPairs], im[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const bool live = p0 + j < a.nz2;
    re[j] = live ? a.g_re[(p0 + j) * ns + at] : 0.f;
    im[j] = live ? a.g_im[(p0 + j) * ns + at] : 0.f;
  }
  s.re = make_float4(re[0], re[1], re[2], re[3]);
  s.im = make_float4(im[0], im[1], im[2], im[3]);
  return s;
}

template <bool kCompensated>
__device__ __forceinline__ void add_term(float& sum, float& comp, float g, float w) {
  if (kCompensated) {  // Kahan
    const float y = __fsub_rn(__fmul_rn(g, w), comp);
    const float t = __fadd_rn(sum, y);
    comp = __fsub_rn(__fsub_rn(t, sum), y);
    sum = t;
  } else {
    sum = fmaf(g, w, sum);
  }
}

// One tile.  Thread t: cell (row t / 32, column t % 32) of the tile.
// Dynamic shared memory: rlo[kThreads], offs[kThreads + 1], warp_tot[32],
// then two batch buffers of kThreads Sample, float4 re, float4 im.
template <bool kCompensated>
__device__ __forceinline__ void grid_tile(const Args& a, int ty, int tx, int p0,
                                          unsigned char* smem) {
  int* rlo = reinterpret_cast<int*>(smem);
  int* offs = rlo + kThreads;
  int* warp_tot = offs + kThreads + 1;
  // 16-byte aligned: (2 kThreads + 33) ints, rounded up
  unsigned char* batch0 = smem + ((sizeof(int) * (2 * kThreads + 33) + 15) / 16) * 16;
  constexpr size_t kBuf = static_cast<size_t>(kThreads) * (sizeof(Sample) + 2 * sizeof(float4));

  const int tid = threadIdx.x;
  const int n = a.n, two_n = 2 * n, m = a.m;
  const float two_n_f = static_cast<float>(two_n);
  const int i0 = tx * kTileX + (tid & 31);
  const int i1 = ty * kTileY + (tid >> 5);
  const bool valid = i0 < two_n && i1 < two_n;
  // the tile's cells, l units, inclusive
  const int cl = tx * kTileX - n, ch = min(tx * kTileX + kTileX, two_n) - 1 - n;
  const int rl = ty * kTileY - n, rh = min(ty * kTileY + kTileY, two_n) - 1 - n;
  const unsigned span = 2u * static_cast<unsigned>(m);

  float sum[2 * kPairs], comp[2 * kPairs];
#pragma unroll
  for (int j = 0; j < 2 * kPairs; ++j) sum[j] = comp[j] = 0.f;

  // the tile itself, then its copies shifted by +-2n where a footprint that
  // crosses the rim can reach them
  for (int k1 = 0; k1 < 3; ++k1) {
    const int s1 = k1 == 0 ? 0 : k1 == 1 ? 1 : -1;
    if ((s1 > 0 && rl > -n + m - 1) || (s1 < 0 && rh < n - m)) continue;
    for (int k0 = 0; k0 < 3; ++k0) {
      const int s0 = k0 == 0 ? 0 : k0 == 1 ? 1 : -1;
      if ((s0 > 0 && cl > -n + m - 1) || (s0 < 0 && ch < n - m)) continue;
      const int L0 = valid ? i0 - n + s0 * two_n : INT_MAX / 2;
      const int L1 = valid ? i1 - n + s1 * two_n : INT_MAX / 2;
      const float q0 = __fdiv_rn(static_cast<float>(L0), two_n_f);
      const float q1 = __fdiv_rn(static_cast<float>(L1), two_n_f);
      for (int a_base = 0; a_base < a.nproj; a_base += kThreads) {
        int r_lo = 0, count = 0;
        if (a_base + tid < a.nproj)
          sample_run(a.cos_t[a_base + tid], a.sin_t[a_base + tid], n, m,
                     cl + s0 * two_n, ch + s0 * two_n, rl + s1 * two_n, rh + s1 * two_n,
                     r_lo, count);
        rlo[tid] = r_lo;
        block_scan(count, offs, warp_tot);
        const int total = offs[kThreads];
        const int n_batches = (total + kThreads - 1) / kThreads;
        if (n_batches > 0) {
          const Staged s = load_sample(a, a_base, tid, total, p0, rlo, offs);
          reinterpret_cast<Sample*>(batch0)[tid] = s.h;
          reinterpret_cast<float4*>(batch0 + sizeof(Sample) * kThreads)[tid] = s.re;
          reinterpret_cast<float4*>(batch0 + (sizeof(Sample) + sizeof(float4)) * kThreads)[tid] = s.im;
        }
        __syncthreads();
        for (int b = 0; b < n_batches; ++b) {
          Staged next;
          const bool more = b + 1 < n_batches;
          if (more) next = load_sample(a, a_base, (b + 1) * kThreads + tid, total, p0, rlo, offs);
          const unsigned char* buf = batch0 + (b & 1) * kBuf;
          const Sample* hdr = reinterpret_cast<const Sample*>(buf);
          const float4* gre = reinterpret_cast<const float4*>(buf + sizeof(Sample) * kThreads);
          const float4* gim = gre + kThreads;
          const int cnt = min(kThreads, total - b * kThreads);
          for (int s = 0; s < cnt; ++s) {
            const Sample h = hdr[s];
            if (static_cast<unsigned>(L1 - h.e1) > span) continue;  // the whole warp
            if (static_cast<unsigned>(L0 - h.e0) > span) continue;
            const float w0 = __fsub_rn(q0, h.x0);
            const float w1 = __fsub_rn(q1, h.y0);
            const float w = __fmul_rn(a.coeff0, expf(__fmul_rn(
                a.coeff1, __fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)))));
            const float4 re = gre[s], im = gim[s];
            add_term<kCompensated>(sum[0], comp[0], re.x, w);
            add_term<kCompensated>(sum[1], comp[1], re.y, w);
            add_term<kCompensated>(sum[2], comp[2], re.z, w);
            add_term<kCompensated>(sum[3], comp[3], re.w, w);
            add_term<kCompensated>(sum[4], comp[4], im.x, w);
            add_term<kCompensated>(sum[5], comp[5], im.y, w);
            add_term<kCompensated>(sum[6], comp[6], im.z, w);
            add_term<kCompensated>(sum[7], comp[7], im.w, w);
          }
          if (more) {
            unsigned char* nb = batch0 + ((b + 1) & 1) * kBuf;
            reinterpret_cast<Sample*>(nb)[tid] = next.h;
            reinterpret_cast<float4*>(nb + sizeof(Sample) * kThreads)[tid] = next.re;
            reinterpret_cast<float4*>(nb + (sizeof(Sample) + sizeof(float4)) * kThreads)[tid] = next.im;
          }
          __syncthreads();
        }
      }
    }
  }

  if (!valid) return;
  const long long plane = static_cast<long long>(two_n) * two_n;
  const long long cell = static_cast<long long>(i1) * two_n + i0;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (p0 + j < a.nz2) {
      a.f_re[(p0 + j) * plane + cell] = sum[j];
      a.f_im[(p0 + j) * plane + cell] = sum[kPairs + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) usfft_grid_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  const int two_n = 2 * a.n;
  const int nt_x = (two_n + kTileX - 1) / kTileX;
  const int tile = a.order[blockIdx.x];
  const int ty = tile / nt_x, tx = tile - ty * nt_x;
  const int p0 = blockIdx.y * kPairs;
  // does the tile touch the centre square l in [-R, R)?
  const int cl = tx * kTileX - a.n, rl = ty * kTileY - a.n;
  const bool centre = cl < a.R && cl + kTileX > -a.R && rl < a.R && rl + kTileY > -a.R;
  if (centre)
    grid_tile<true>(a, ty, tx, p0, grid_smem);
  else
    grid_tile<false>(a, ty, tx, p0, grid_smem);
}

size_t smem_bytes() {
  return ((sizeof(int) * (2 * kThreads + 33) + 15) / 16) * 16 +
         2 * static_cast<size_t>(kThreads) * (sizeof(Sample) + 2 * sizeof(float4));
}

}  // namespace

extern "C" {

// tile shape, for the wrapper's tile order: rows, columns
int tt_usfft_grid_tile(int axis) { return axis == 0 ? kTileY : kTileX; }

// `order`: the ceil(2n / rows) * ceil(2n / columns) tile numbers
// (row-major), in the order the blocks take them.  R: half-width of the
// centre square whose tiles add with compensation.
int tt_usfft_grid(const float* g_re, const float* g_im, const float* cos_t,
                  const float* sin_t, float* f_re, float* f_im, const int* order,
                  int nz2, int nproj, int n, int m, int R, float coeff0,
                  float coeff1, float clamp, cudaStream_t stream) {
  if (n <= 0 || nz2 <= 0) return 0;
  if (R < 0 || m < 0 || m >= n || nproj < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int two_n = 2 * n;
  const long long tiles = static_cast<long long>((two_n + kTileX - 1) / kTileX) *
                          ((two_n + kTileY - 1) / kTileY);
  const int batches = (nz2 + kPairs - 1) / kPairs;
  if (tiles > 0x7fffffffLL || batches > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      usfft_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{g_re, g_im, cos_t, sin_t, f_re, f_im, order, nz2, nproj, n, m, R,
               coeff0, coeff1, clamp};
  usfft_grid_kernel<<<dim3(static_cast<unsigned>(tiles), batches), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
