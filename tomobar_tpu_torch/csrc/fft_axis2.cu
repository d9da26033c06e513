// F: the length-n forward DFT along axis -2 of a split-complex float32
// pair (Z, n, L), unnormalised, n = B*C with 1 < B <= 8 and C <= 1024.  The
// unnormalised inverse is the same kernel on swapped re/im pointers
// (conj(DFT(conj x)) = swap(DFT(swap x))), which the wrapper does.
//
// Replaces (file, function): tomobar_tpu/ops/fft_real.py, the inner
// `kernel` of _fft_axis2_fused.  It computes what that kernel computes --
// the Bailey four-step
//     X[k1 + B*k2] = DFT_C[n2 -> k2]( T[k1, n2] * DFT_B[n1 -> k1]( x[n1*C + n2] ) )
// with T[k1, n2] = exp(-2i*pi*k1*n2/n) -- but not block by block: the
// Pallas kernel holds whole (n, 256)-lane strips in VMEM and does the
// C-point DFT as a dense (C, C) MXU matmul, which has no counterpart on a
// card whose block holds at most 227 KB of shared memory.
//
// What bounds it on an H100: bytes.  16 bytes per complex element in and
// out (1.68 GB at 4 x 5120 x 5120: 0.50 ms at 3.35 TB/s) against about
// 5 n log2 n flops per column (under 0.1 ms), so the design's job is to
// touch device memory once and to keep enough blocks resident to hide the
// latency of everything else.
//
// Design.
//  * A cluster of B thread blocks owns kCols = 8 neighbouring columns l of
//    one batch z (32-byte rows: whole sectors).  Block k1 of the cluster
//    loads the slab n1 = k1 (rows k1*C .. k1*C + C - 1) into its shared
//    memory, so every input element is read from device memory once.
//  * The B step runs in place across the cluster's shared memory
//    (distributed shared memory): a thread reads x[n1*C + n2] for all n1
//    from the B slabs, forms the B-point DFT times T[k1, n2] in registers,
//    and writes row k1 back into block k1's slab at the same place.  Each
//    block does this for its share of the n2.  Two cluster barriers.
//  * The C-point DFT of block k1 runs in place in its slab as decimation-
//    in-frequency stages with whole butterflies in registers (radix 16, 8,
//    5, 4, 3, 2: a thread reads its q inputs once, does the q-point DFT
//    with constant roots, multiplies by the stage twiddles w_C^(j p C/Ls),
//    indexed without a remainder, and writes q outputs to the places it
//    read), one barrier per stage and one buffer, so a C = 1024 block needs
//    73 KB where ping-pong buffers needed 136 KB, and three blocks share an
//    SM.  The result is left in digit-reversed order, which costs nothing:
//    the store computes k2 from the position, and every output row is its
//    own 32-byte segment anyway.  The radix sequences of the C that the
//    reconstruction paths produce (1024 = 16*8*8, 640 = 5*16*8) are
//    compile-time, so their index arithmetic folds to shifts; any other
//    C <= 1024 runs the same stages from a run-time plan, with one output
//    per thread item for a radix that has no register butterfly.
//  * Shared memory is float2 (re, im) per element, [position][column]; the
//    position is XOR-swizzled by the parity of its upper bits so that the
//    two positions a half-warp touches in any power-of-two stage fall in
//    different halves of the banks.
//  * All tables (DFT_B, T and the roots w_C^j) are float64 on the host cast
//    to float32; no library FFT, GEMM or tensor-core path is used.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 8;  // neighbouring columns l per cluster (32-byte rows)
constexpr int kMaxB = 8;
constexpr int kMaxC = 1024;
constexpr int kMaxStages = 10;      // C <= 1024 has at most 10 prime factors
constexpr int kPlanThreads = 512;   // block size of the run-time plan
constexpr int kMaxItems = kMaxC * kCols / kPlanThreads;

struct StagePlan {
  int n;                  // number of stages
  int radix[kMaxStages];  // their radices, in order; the product is C
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

// shared-memory slot of position pos: the lowest bit is flipped by the
// parity of the bits above it (a bijection on every aligned pair)
__device__ __forceinline__ int slot(int pos) {
  return pos ^ (__popc(pos >> 1) & 1);
}

// exp(-2i*pi*k/16), k < 8
__device__ __forceinline__ float2 root16(int k) {
  switch (k) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(0.92387953251128674f, -0.38268343236508977f);
    case 2: return make_float2(0.70710678118654752f, -0.70710678118654752f);
    case 3: return make_float2(0.38268343236508977f, -0.92387953251128674f);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-0.38268343236508977f, -0.92387953251128674f);
    case 6: return make_float2(-0.70710678118654752f, -0.70710678118654752f);
    default: return make_float2(-0.92387953251128674f, -0.38268343236508977f);
  }
}

// In-register forward DFTs: x[k] <- sum_q x[q] exp(-2i*pi*k*q/R).
template <int R>
struct Dft;

template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float2* x) {
    const float2 a = x[0], b = x[1];
    x[0] = cadd(a, b);
    x[1] = csub(a, b);
  }
};

template <>
struct Dft<3> {
  static __device__ __forceinline__ void run(float2* x) {
    const float c = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 s = cadd(x[1], x[2]), d = csub(x[1], x[2]);
    const float2 m = make_float2(x[0].x - 0.5f * s.x, x[0].y - 0.5f * s.y);
    x[0] = cadd(x[0], s);
    x[1] = make_float2(m.x + c * d.y, m.y - c * d.x);
    x[2] = make_float2(m.x - c * d.y, m.y + c * d.x);
  }
};

template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float2* x) {
    const float2 t0 = cadd(x[0], x[2]), t1 = csub(x[0], x[2]);
    const float2 t2 = cadd(x[1], x[3]), t3 = mul_mi(csub(x[1], x[3]));
    x[0] = cadd(t0, t2);
    x[1] = cadd(t1, t3);
    x[2] = csub(t0, t2);
    x[3] = csub(t1, t3);
  }
};

template <>
struct Dft<5> {
  static __device__ __forceinline__ void run(float2* x) {
    const float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;
    const float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;
    const float2 a1 = cadd(x[1], x[4]), a2 = cadd(x[2], x[3]);
    const float2 b1 = csub(x[1], x[4]), b2 = csub(x[2], x[3]);
    const float2 p1 = make_float2(x[0].x + c1 * a1.x + c2 * a2.x,
                                  x[0].y + c1 * a1.y + c2 * a2.y);
    const float2 p2 = make_float2(x[0].x + c2 * a1.x + c1 * a2.x,
                                  x[0].y + c2 * a1.y + c1 * a2.y);
    const float2 q1 = make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y);
    const float2 q2 = make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y);
    x[0] = cadd(x[0], cadd(a1, a2));
    x[1] = make_float2(p1.x + q1.y, p1.y - q1.x);  // p1 - i q1
    x[4] = make_float2(p1.x - q1.y, p1.y + q1.x);
    x[2] = make_float2(p2.x + q2.y, p2.y - q2.x);  // p2 - i q2
    x[3] = make_float2(p2.x - q2.y, p2.y + q2.x);
  }
};

// radix 8 and 16 by one decimation-in-time split into even and odd inputs
template <int R>
__device__ __forceinline__ void dft_split(float2* x) {
  constexpr int H = R / 2;
  float2 e[H], o[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    e[k] = x[2 * k];
    o[k] = x[2 * k + 1];
  }
  Dft<H>::run(e);
  Dft<H>::run(o);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const int k16 = k * (16 / R);
    const float2 t = k16 == 0 ? o[k] : k16 == 4 ? mul_mi(o[k]) : cmul(o[k], root16(k16));
    x[k] = cadd(e[k], t);
    x[k + H] = csub(e[k], t);
  }
}

template <>
struct Dft<8> {
  static __device__ __forceinline__ void run(float2* x) { dft_split<8>(x); }
};

template <>
struct Dft<16> {
  static __device__ __forceinline__ void run(float2* x) { dft_split<16>(x); }
};

// One in-place decimation-in-frequency stage of radix R on sub-transforms
// of length Ls (C / Ls of them): butterfly (blk, j), j < M = Ls / R, reads
// positions blk*Ls + j + M q, q < R, and writes
//   y_p = w_C^(j p C/Ls) * sum_q x_q exp(-2i*pi*p*q/R)
// to position blk*Ls + j + M p.  A thread owns whole butterflies.
template <int R>
__device__ __forceinline__ void stage_butterflies(float2* s, const float2* w,
                                                  int C, int Ls, int threads) {
  const int M = Ls / R;
  const int step = C / Ls;
  const int n_butterflies = C / R * kCols;
  for (int b = threadIdx.x; b < n_butterflies; b += threads) {
    const int col = b % kCols;
    const int t = b / kCols;
    const int blk = t / M;
    const int j = t - blk * M;
    const int base = blk * Ls + j;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = s[slot(base + M * q) * kCols + col];
    Dft<R>::run(x);
    if (M > 1) {
#pragma unroll
      for (int p = 1; p < R; ++p) x[p] = cmul(x[p], w[j * p * step]);
    }
#pragma unroll
    for (int p = 0; p < R; ++p) s[slot(base + M * p) * kCols + col] = x[p];
  }
  __syncthreads();
}

// The same stage for a radix without a register butterfly: one output per
// thread item, all outputs held in registers across a barrier, then
// written.  Used by the run-time plan only (kPlanThreads threads).
__device__ __forceinline__ void stage_outputs(float2* s, const float2* w, int C,
                                              int Ls, int r) {
  const int M = Ls / r;
  const int step = C / Ls;
  const int root_step = C / r;
  float2 out[kMaxItems];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int it = threadIdx.x + i * kPlanThreads;
    if (it >= C * kCols) continue;
    const int col = it % kCols;
    const int pos = it / kCols;
    const int blk = pos / Ls;
    const int rem = pos - blk * Ls;
    const int p = rem / M;
    const int j = rem - p * M;
    const int base = blk * Ls + j;
    float2 acc = make_float2(0.f, 0.f);
    for (int q = 0; q < r; ++q) {
      const float2 v = s[slot(base + M * q) * kCols + col];
      acc = cadd(acc, cmul(v, w[((p * q) % r) * root_step]));
    }
    out[i] = cmul(acc, w[j * p * step]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int it = threadIdx.x + i * kPlanThreads;
    if (it >= C * kCols) continue;
    s[slot(it / kCols) * kCols + it % kCols] = out[i];
  }
  __syncthreads();
}

__device__ __forceinline__ void run_stage(float2* s, const float2* w, int C,
                                          int Ls, int r, int threads) {
  switch (r) {
    case 16: stage_butterflies<16>(s, w, C, Ls, threads); break;
    case 8: stage_butterflies<8>(s, w, C, Ls, threads); break;
    case 5: stage_butterflies<5>(s, w, C, Ls, threads); break;
    case 4: stage_butterflies<4>(s, w, C, Ls, threads); break;
    case 3: stage_butterflies<3>(s, w, C, Ls, threads); break;
    case 2: stage_butterflies<2>(s, w, C, Ls, threads); break;
    default: stage_outputs(s, w, C, Ls, r); break;
  }
}

// The B step on this block's share of the n2, in place across the slabs of
// the cluster: slab k1 <- T[k1, n2] * sum_n1 DFT_B[k1, n1] slab n1.
template <int B>
__device__ __forceinline__ void b_step(cg::cluster_group& cluster, float2* slab,
                                       const float2* wb,
                                       const float2* __restrict__ t_table, int C,
                                       int threads) {
  float2* remote[B];
#pragma unroll
  for (int n1 = 0; n1 < B; ++n1) remote[n1] = cluster.map_shared_rank(slab, n1);
  const int chunk = (C + B - 1) / B;
  const int first = static_cast<int>(cluster.block_rank()) * chunk;
  for (int it = threadIdx.x; it < chunk * kCols; it += threads) {
    const int n2 = first + it / kCols;
    if (n2 >= C) continue;
    const int idx = slot(n2) * kCols + it % kCols;
    float2 x[B];
#pragma unroll
    for (int n1 = 0; n1 < B; ++n1) x[n1] = remote[n1][idx];
#pragma unroll
    for (int k1 = 0; k1 < B; ++k1) {
      float2 y = x[0];  // DFT_B[k1, 0] = 1
#pragma unroll
      for (int n1 = 1; n1 < B; ++n1) y = cadd(y, cmul(x[n1], wb[k1 * B + n1]));
      remote[k1][idx] = k1 == 0 ? y : cmul(y, t_table[k1 * C + n2]);
    }
  }
}

// C_ > 0: the compile-time plan C_ = R1*R2*R3*R4 (unused radices are 1);
// C_ == 0: C and the radices come from `plan`.
template <int C_, int R1, int R2, int R3, int R4, int THREADS>
__global__ void __launch_bounds__(THREADS)
fft_axis2_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim,
                 const float2* __restrict__ tables, int B, int C_arg,
                 StagePlan plan, int L, int n_tiles) {
  extern __shared__ __align__(16) float2 f_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = C_ > 0 ? C_ : C_arg;
  float2* w = f_smem;                // roots w_C^j, C of them
  float2* wb = w + C;                // DFT_B, kMaxB * kMaxB slots
  float2* slab = wb + kMaxB * kMaxB; // (C rounded up to even) * kCols

  const float2* g_wb = tables;             // DFT_B (B, B)
  const float2* g_t = g_wb + B * B;        // T (B, C)
  const float2* g_w = g_t + B * C;         // roots (C)

  const int k1 = static_cast<int>(cluster.block_rank());  // blockIdx.x % B
  const long long tile = blockIdx.x / B;
  const int l0 = static_cast<int>(tile % n_tiles) * kCols;
  const long long z = tile / n_tiles;
  const long long base = z * B * C * static_cast<long long>(L);
  const int items = C * kCols;

  for (int j = threadIdx.x; j < C; j += THREADS) w[j] = g_w[j];
  for (int j = threadIdx.x; j < B * B; j += THREADS) wb[j] = g_wb[j];

  // 1. the slab n1 = k1: rows k1*C + n2
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int col = it % kCols;
    const int n2 = it / kCols;
    const int l = l0 + col;
    float2 v = make_float2(0.f, 0.f);
    if (l < L) {
      const long long off = base + static_cast<long long>(k1 * C + n2) * L + l;
      v = make_float2(re[off], im[off]);
    }
    slab[slot(n2) * kCols + col] = v;
  }
  cluster.sync();

  // 2. the B step, in place across the cluster
  switch (B) {
    case 2: b_step<2>(cluster, slab, wb, g_t, C, THREADS); break;
    case 3: b_step<3>(cluster, slab, wb, g_t, C, THREADS); break;
    case 4: b_step<4>(cluster, slab, wb, g_t, C, THREADS); break;
    case 5: b_step<5>(cluster, slab, wb, g_t, C, THREADS); break;
    case 6: b_step<6>(cluster, slab, wb, g_t, C, THREADS); break;
    case 7: b_step<7>(cluster, slab, wb, g_t, C, THREADS); break;
    default: b_step<8>(cluster, slab, wb, g_t, C, THREADS); break;
  }
  cluster.sync();  // also keeps every slab alive until its readers are done

  // 3. the C-point DFT of row k1, in place; 4. X[k1 + B*k2], with k2 read
  // off the digits of the position: pos = sum_i p_i M_i  ->  k2 = sum_i p_i
  // R_1 .. R_(i-1)
  if constexpr (C_ > 0) {
    stage_butterflies<R1>(slab, w, C_, C_, THREADS);
    if constexpr (R2 > 1) stage_butterflies<R2>(slab, w, C_, C_ / R1, THREADS);
    if constexpr (R3 > 1) stage_butterflies<R3>(slab, w, C_, C_ / (R1 * R2), THREADS);
    if constexpr (R4 > 1) stage_butterflies<R4>(slab, w, C_, C_ / (R1 * R2 * R3), THREADS);
  } else {
    int Ls = C;
    for (int i = 0; i < plan.n; ++i) {
      run_stage(slab, w, C, Ls, plan.radix[i], THREADS);
      Ls /= plan.radix[i];
    }
  }
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int col = it % kCols;
    const int pos = it / kCols;
    const int l = l0 + col;
    if (l >= L) continue;
    int k2 = 0;
    if constexpr (C_ > 0) {
      constexpr int M1 = C_ / R1, M2 = M1 / R2, M3 = M2 / R3;
      const int p1 = pos / M1, r1 = pos % M1;
      const int p2 = r1 / M2, r2 = r1 % M2;
      const int p3 = r2 / M3, p4 = r2 % M3;
      k2 = p1 + R1 * (p2 + R2 * (p3 + R3 * p4));
    } else {
      int rem = pos, M = C, weight = 1;
      for (int i = 0; i < plan.n; ++i) {
        M /= plan.radix[i];
        k2 += (rem / M) * weight;
        rem %= M;
        weight *= plan.radix[i];
      }
    }
    const float2 v = slab[slot(pos) * kCols + col];
    const long long off = base + static_cast<long long>(k1 + B * k2) * L + l;
    ore[off] = v.x;
    oim[off] = v.y;
  }
}

template <int C_, int R1, int R2, int R3, int R4, int THREADS>
int launch(const float* re, const float* im, float* ore, float* oim,
           const float* tables, int Z, int B, int C, const StagePlan& plan,
           int L, cudaStream_t stream) {
  const int n_tiles = (L + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(Z) * n_tiles * B;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fft_axis2_kernel<C_, R1, R2, R3, R4, THREADS>;
  const size_t smem =
      sizeof(float2) * (C + kMaxB * kMaxB + static_cast<size_t>((C + 1) & ~1) * kCols);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the B blocks of a tile
  attr[0].val.clusterDim.x = B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, re, im, ore, oim,
                           reinterpret_cast<const float2*>(tables), B, C, plan, L,
                           n_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool plan_is(const StagePlan& plan, int r1, int r2, int r3) {
  return plan.n == 3 && plan.radix[0] == r1 && plan.radix[1] == r2 &&
         plan.radix[2] == r3;
}

}  // namespace

// radices: n_stages host ints whose product is C (the wrapper's stage plan)
extern "C" int tt_fft_axis2(const float* re, const float* im, float* ore,
                            float* oim, const float* tables, int Z, int B,
                            int C, int L, const int* radices, int n_stages,
                            cudaStream_t stream) {
  if (B < 2 || B > kMaxB || C < 2 || C > kMaxC || Z < 0 || L < 0 ||
      n_stages < 1 || n_stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  StagePlan plan = {};
  plan.n = n_stages;
  int product = 1;
  for (int i = 0; i < n_stages; ++i) {
    if (radices[i] < 2 || radices[i] > C) return static_cast<int>(cudaErrorInvalidValue);
    plan.radix[i] = radices[i];
    product *= radices[i];
  }
  if (product != C) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1024 && plan_is(plan, 16, 8, 8))
    return launch<1024, 16, 8, 8, 1, 256>(re, im, ore, oim, tables, Z, B, C, plan, L, stream);
  if (C == 640 && plan_is(plan, 5, 16, 8))
    return launch<640, 5, 16, 8, 1, 320>(re, im, ore, oim, tables, Z, B, C, plan, L, stream);
  return launch<0, 1, 1, 1, 1, kPlanThreads>(re, im, ore, oim, tables, Z, B, C, plan, L, stream);
}
