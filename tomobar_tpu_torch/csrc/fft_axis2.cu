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
//
// Fc, the centred variant (fft_axis2_centred_kernel, tt_fft_axis2_centred):
// FOURIER_INV's whole inverse 2-D transform of (Z, 2n, 2n) grids in two
// launches of the same block, with nothing grid-sized made between or
// around them.  Replaces no TPU kernel: the JAX package's _ifft2_centered
// runs the checkerboard, the half-pixel ramp, the transpose and the scale as
// XLA passes around its two fused F passes.  What the stage computes is
//     out[m, k] = (-1)^(m+k) / (2n)^2 * sum_j e(j m) sum_i e(i k) x[i, j] c(i) c(j)
// with e(t) = exp(+2i*pi*t/(2n)) and c(k) = (-1)^k exp(i*pi*(k - n)/(2n))
// (c(k) = (-1)^k without the half-pixel shift): the checkerboard and the
// ramp are both separable, so one 2n-long table replaces three (2n)^2 ones.
//  * Pass 1 (kCentredRows) is F along axis -2 that multiplies each element
//    by c(i) c(j) as it loads it.  The inverse runs the forward block on
//    swapped (im, re) pointers; in that frame the caller's factor c is
//    conj(c), since swap(c x) = conj(c) swap(x).
//  * Pass 2 (kCentredCols) transforms along the other axis by reading its
//    input transposed: the cluster's 8 "columns" are 8 rows of pass 1's
//    output, and block k1 reads its slab n1 = k1 as 8 runs of C contiguous
//    floats, 16 bytes a thread, a warp 8 rows x 16 floats, whose smem slots
//    fall two words to a bank (the fewest for 64-bit stores).  It stores as
//    F does, multiplied by (-1)^(m+k) / (2n)^2, so the image comes out
//    transposed, as the chain of passes left it.  Reading transposed costs
//    no barrier; storing transposed from pass 1 would have needed a third
//    cluster barrier and scattered reads of the digit-reversed slabs.
//  * Bound: each pass moves what F moves (1.68 GB at 4 x 5120^2, 0.50 ms at
//    3.35 TB/s); the twelve grid-sized PyTorch passes it replaces moved
//    about 3.6 GB a z-pair.  Prediction before the first run: each pass
//    within 10% of F's 1.40 ms at 4 x 5120^2, so the stage at ~2.9 ms per
//    4 pairs against ~9.9 ms for the chain.
//
// Ff, the filter variant (fft_axis2_filter_kernel, tt_fft_axis2_filter):
// FOURIER_INV's whole filter stage in one launch, from the raw sinogram rows
// (Z, A, raw) to the cropped filtered rows (Z, A, width).  Replaces no TPU
// kernel: the JAX package's _fbp_filter_stage runs the edge pad, the
// transposes, the filter multiply, the scale, the pair stack and the crop
// as XLA passes around its two fused F passes, every one an ow-wide round
// trip through device memory (3.4 GB a pass at 57 x 1801 x 8192).
//  * Rows 2j and 2j + 1 of a slice are one (re, im) pair, as
//    apply_freq_filter_real pairs them (an odd A's last row with zeros);
//    the cluster's 8 columns are 8 pairs.  Block k1 loads positions
//    k1*C + n2 of the width-ow grid straight from the raw rows through the
//    clamped index x[clamp(p - pad_m, 0, raw - 1)] (the edge pad), 16 bytes
//    a thread where the widths allow, so nothing ow-wide is ever written.
//  * The forward transform is F's: the B step across the cluster, then the
//    C-point stages, which leave X[k1 + B*k2] digit-reversed in block k1.
//  * The inverse is the transpose of that network, run in the frame
//    swap(a + ib) = b + ia, where the unnormalised inverse is the forward
//    DFT: with X' = X * filt (1/ow folded into the table),
//        y[m2 + C*m1] = swap( sum_k1 DFT_B[m1, k1] T[k1, m2]
//                             sum_k2 swap(X'[k1 + B*k2]) e^(-2i pi k2 m2 / C) ).
//    The C-point DFT of digit-reversed input to natural output is the
//    forward stages transposed, in the other order (each reads and writes
//    the places its forward stage wrote and read, twiddles on the inputs):
//    F_C = F_C^T = S_1^T .. S_s^T P.  The last forward stage and the first
//    transposed one touch the same R positions in the same thread, so the
//    filter multiply and the swap sit between them in registers.  Then T and
//    DFT_B across the cluster, into the blocks that hold part of the crop
//    only; block m1 holds positions m1*C + m2 in natural order and stores
//    those in [unpad_m, unpad_m + width), im to row 2j and re to row 2j + 1.
//  * Bound: 2 x 5 ow log2 ow flops a pair (0.82 ms at 67 TFLOP/s for 57 x
//    1801 rows at ow 8192) against the raw rows in and the filtered rows
//    out once (2.1 GB at width 2560: 0.63 ms at 3.35 TB/s); the chain of
//    passes it replaces moved ~30 GB.
//  * Prediction before the first run on the card (FOURIER_INV at 512 x
//    1801 x 2560, 9 z-blocks): the tomobar::usfft.filter spans 0.539-0.544
//    s a call -> 0.06-0.15 s (the low end F's one pass a call today, the
//    high end the two transforms' work in one residency at F's issue
//    rate); the call 1.258 s -> ~0.78-0.87 s; slices_per_s 407 -> 540-650;
//    usfft_transform_roofline_pct 6.87 -> 13-18; usfft_roofline_pct 5.75
//    -> 8-9.5; usfft_grid_roofline_pct unchanged at 3.97; device idle under
//    2%; peak_mem_gib not above 51.40.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 8;  // neighbouring columns l per cluster (32-byte rows)
constexpr int kMaxB = 8;
constexpr int kMaxC = 1024;
constexpr int kMaxStages = 10;      // C <= 1024 has at most 10 prime factors
constexpr int kPlanThreads = 512;   // block size of the run-time plan
constexpr int kMaxItems = kMaxC * kCols / kPlanThreads;

// how a launch loads and stores: F, or one of the two passes of Fc
enum Mode { kPlain = 0, kCentredRows = 1, kCentredCols = 2 };

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
// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
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
// kTransposed: the transpose of that stage at the same places, the
// twiddles on the inputs before the DFT (Ff's inverse, see the head).
template <int R, bool kTransposed = false>
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
    if constexpr (kTransposed) {
      if (M > 1) {
#pragma unroll
        for (int p = 1; p < R; ++p) x[p] = cmul(x[p], w[j * p * step]);
      }
      Dft<R>::run(x);
    } else {
      Dft<R>::run(x);
      if (M > 1) {
#pragma unroll
        for (int p = 1; p < R; ++p) x[p] = cmul(x[p], w[j * p * step]);
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) s[slot(base + M * p) * kCols + col] = x[p];
  }
  __syncthreads();
}

// The same stage for a radix without a register butterfly: one output per
// thread item, all outputs held in registers across a barrier, then
// written.  Used by the run-time plan only (kPlanThreads threads).
template <bool kTransposed = false>
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
      float2 v = s[slot(base + M * q) * kCols + col];
      if constexpr (kTransposed) v = cmul(v, w[j * q * step]);
      acc = cadd(acc, cmul(v, w[((p * q) % r) * root_step]));
    }
    out[i] = kTransposed ? acc : cmul(acc, w[j * p * step]);
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

template <bool kTransposed = false>
__device__ __forceinline__ void run_stage(float2* s, const float2* w, int C,
                                          int Ls, int r, int threads) {
  switch (r) {
    case 16: stage_butterflies<16, kTransposed>(s, w, C, Ls, threads); break;
    case 8: stage_butterflies<8, kTransposed>(s, w, C, Ls, threads); break;
    case 5: stage_butterflies<5, kTransposed>(s, w, C, Ls, threads); break;
    case 4: stage_butterflies<4, kTransposed>(s, w, C, Ls, threads); break;
    case 3: stage_butterflies<3, kTransposed>(s, w, C, Ls, threads); break;
    case 2: stage_butterflies<2, kTransposed>(s, w, C, Ls, threads); break;
    default: stage_outputs<kTransposed>(s, w, C, Ls, r); break;
  }
}

// k2 of the C-point stages' output at position pos (they leave it digit-
// reversed): pos = sum_i p_i M_i  ->  k2 = sum_i p_i R_1 .. R_(i-1)
template <int C_, int R1, int R2, int R3, int R4>
__device__ __forceinline__ int digit_reversed(int pos, const StagePlan& plan, int C) {
  if constexpr (C_ > 0) {
    constexpr int M1 = C_ / R1, M2 = M1 / R2, M3 = M2 / R3;
    const int p1 = pos / M1, r1 = pos % M1;
    const int p2 = r1 / M2, r2 = r1 % M2;
    const int p3 = r2 / M3, p4 = r2 % M3;
    return p1 + R1 * (p2 + R2 * (p3 + R3 * p4));
  } else {
    int k2 = 0, rem = pos, M = C, weight = 1;
    for (int i = 0; i < plan.n; ++i) {
      M /= plan.radix[i];
      k2 += (rem / M) * weight;
      rem %= M;
      weight *= plan.radix[i];
    }
    return k2;
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

// The load of pass 2 of Fc: the slab of rows first + n2 (n2 < C) of the
// columns l0 + col is in[z, l0 + col, first + n2] of a (Z, L, n) input, so
// each column is a run of C contiguous floats.  A warp takes 8 columns x 16
// floats, 16 bytes a thread, where C_ is a multiple of 4 (the compile-time
// plans; the entry checks the alignment), and one float a thread otherwise.
template <int C_, int THREADS>
__device__ __forceinline__ void load_transposed(const float* __restrict__ re,
                                                const float* __restrict__ im,
                                                float2* slab, long long base,
                                                int first, int n, int C, int l0,
                                                int L) {
  if constexpr (C_ > 0 && C_ % 4 == 0) {
    for (int it = threadIdx.x; it < C_ / 4 * kCols; it += THREADS) {
      const int col = it % kCols;
      const int n2 = it / kCols * 4;
      const int l = l0 + col;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (l < L) {
        const long long off = base + static_cast<long long>(l) * n + first + n2;
        a = *reinterpret_cast<const float4*>(re + off);
        b = *reinterpret_cast<const float4*>(im + off);
      }
      slab[slot(n2) * kCols + col] = make_float2(a.x, b.x);
      slab[slot(n2 + 1) * kCols + col] = make_float2(a.y, b.y);
      slab[slot(n2 + 2) * kCols + col] = make_float2(a.z, b.z);
      slab[slot(n2 + 3) * kCols + col] = make_float2(a.w, b.w);
    }
  } else {
    const int runs = (C + 3) / 4;
    for (int it = threadIdx.x; it < runs * 4 * kCols; it += THREADS) {
      const int n2 = it / (4 * kCols) * 4 + it % 4;
      const int col = it / 4 % kCols;
      if (n2 >= C) continue;
      const int l = l0 + col;
      float2 v = make_float2(0.f, 0.f);
      if (l < L) {
        const long long off = base + static_cast<long long>(l) * n + first + n2;
        v = make_float2(re[off], im[off]);
      }
      slab[slot(n2) * kCols + col] = v;
    }
  }
}

// The block of F (MODE kPlain) and of the two passes of Fc.  C_ > 0: the
// compile-time plan C_ = R1*R2*R3*R4 (unused radices are 1); C_ == 0: C and
// the radices come from `plan`.  kCentredRows multiplies element (i, l) by
// conj(c(i) c(l)) as it loads it (`centre` holds c, B*C of it);
// kCentredCols reads a (Z, L, B*C) input transposed and stores
// (-1)^(row + l) * `scale` times the result.
template <int MODE, int C_, int R1, int R2, int R3, int R4, int THREADS>
__device__ __forceinline__ void fft_axis2_block(
    const float* __restrict__ re, const float* __restrict__ im,
    float* __restrict__ ore, float* __restrict__ oim,
    const float2* __restrict__ tables, const float2* __restrict__ centre,
    float scale, int B, int C_arg, const StagePlan& plan, int L, int n_tiles) {
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
  if constexpr (MODE == kCentredCols) {
    load_transposed<C_, THREADS>(re, im, slab, base, k1 * C, B * C, C, l0, L);
  } else {
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int col = it % kCols;
      const int n2 = it / kCols;
      const int l = l0 + col;
      float2 v = make_float2(0.f, 0.f);
      if (l < L) {
        const long long off = base + static_cast<long long>(k1 * C + n2) * L + l;
        v = make_float2(re[off], im[off]);
        if constexpr (MODE == kCentredRows)
          v = cmul_conj(v, cmul(centre[k1 * C + n2], centre[l]));
      }
      slab[slot(n2) * kCols + col] = v;
    }
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
  // off the digits of the position
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
    const int k2 = digit_reversed<C_, R1, R2, R3, R4>(pos, plan, C);
    const float2 v = slab[slot(pos) * kCols + col];
    const long long off = base + static_cast<long long>(k1 + B * k2) * L + l;
    if constexpr (MODE == kCentredCols) {
      const float f = ((k1 + B * k2 + l) & 1) ? -scale : scale;
      ore[off] = v.x * f;
      oim[off] = v.y * f;
    } else {
      ore[off] = v.x;
      oim[off] = v.y;
    }
  }
}

template <int C_, int R1, int R2, int R3, int R4, int THREADS>
__global__ void __launch_bounds__(THREADS)
fft_axis2_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim,
                 const float2* __restrict__ tables, int B, int C_arg,
                 StagePlan plan, int L, int n_tiles) {
  fft_axis2_block<kPlain, C_, R1, R2, R3, R4, THREADS>(
      re, im, ore, oim, tables, nullptr, 0.f, B, C_arg, plan, L, n_tiles);
}

template <int MODE, int C_, int R1, int R2, int R3, int R4, int THREADS>
__global__ void __launch_bounds__(THREADS)
fft_axis2_centred_kernel(const float* __restrict__ re, const float* __restrict__ im,
                         float* __restrict__ ore, float* __restrict__ oim,
                         const float2* __restrict__ tables,
                         const float2* __restrict__ centre, float scale, int B,
                         int C_arg, StagePlan plan, int L, int n_tiles) {
  fft_axis2_block<MODE, C_, R1, R2, R3, R4, THREADS>(
      re, im, ore, oim, tables, centre, scale, B, C_arg, plan, L, n_tiles);
}

template <int MODE, int C_, int R1, int R2, int R3, int R4, int THREADS>
int launch(const float* re, const float* im, float* ore, float* oim,
           const float* tables, const float* centre, float scale, int Z, int B,
           int C, const StagePlan& plan, int L, cudaStream_t stream) {
  const int n_tiles = (L + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(Z) * n_tiles * B;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float2) * (C + kMaxB * kMaxB + static_cast<size_t>((C + 1) & ~1) * kCols);
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
  const float2* t2 = reinterpret_cast<const float2*>(tables);
  cudaError_t err;
  if constexpr (MODE == kPlain) {
    auto kernel = fft_axis2_kernel<C_, R1, R2, R3, R4, THREADS>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, kernel, re, im, ore, oim, t2, B, C, plan, L, n_tiles);
  } else {
    auto kernel = fft_axis2_centred_kernel<MODE, C_, R1, R2, R3, R4, THREADS>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, kernel, re, im, ore, oim, t2,
                             reinterpret_cast<const float2*>(centre), scale, B, C,
                             plan, L, n_tiles);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool plan_is(const StagePlan& plan, int r1, int r2, int r3) {
  return plan.n == 3 && plan.radix[0] == r1 && plan.radix[1] == r2 &&
         plan.radix[2] == r3;
}

template <int MODE>
int dispatch(const float* re, const float* im, float* ore, float* oim,
             const float* tables, const float* centre, float scale, int Z, int B,
             int C, const StagePlan& plan, int L, cudaStream_t stream) {
  if (C == 1024 && plan_is(plan, 16, 8, 8))
    return launch<MODE, 1024, 16, 8, 8, 1, 256>(re, im, ore, oim, tables, centre, scale, Z,
                                                B, C, plan, L, stream);
  if (C == 640 && plan_is(plan, 5, 16, 8))
    return launch<MODE, 640, 5, 16, 8, 1, 320>(re, im, ore, oim, tables, centre, scale, Z,
                                               B, C, plan, L, stream);
  return launch<MODE, 0, 1, 1, 1, 1, kPlanThreads>(re, im, ore, oim, tables, centre, scale,
                                                   Z, B, C, plan, L, stream);
}

// the checks of both entries; fills `plan` from the host's radices
int make_plan(int Z, int B, int C, int L, const int* radices, int n_stages,
              StagePlan* plan) {
  if (B < 2 || B > kMaxB || C < 2 || C > kMaxC || Z < 0 || L < 0 ||
      n_stages < 1 || n_stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  *plan = {};
  plan->n = n_stages;
  int product = 1;
  for (int i = 0; i < n_stages; ++i) {
    if (radices[i] < 2 || radices[i] > C) return static_cast<int>(cudaErrorInvalidValue);
    plan->radix[i] = radices[i];
    product *= radices[i];
  }
  if (product != C) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// ---- Ff (see the head of this file) ----------------------------------------

// pair l of the launch: its row 2j's index z*A + 2j, and whether row 2j + 1
// exists (an odd A's last row pairs with zeros)
__device__ __forceinline__ long long pair_row(int l, int npairs, int A, bool& has_im) {
  const int z = l / npairs, j = l - z * npairs;
  has_im = 2 * j + 1 < A;
  return static_cast<long long>(z) * A + 2 * j;
}

// Ff's load: the slab n1 = k1 of pairs l0 .. l0 + 7, position k1*C + n2 of
// the width-ow grid read as x[clamp(k1*C + n2 - pad_m, 0, raw - 1)] from
// rows 2j (re) and 2j + 1 (im).  vec: runs of 4 positions by 16-byte loads,
// 8 pairs x 4 runs a warp (each run is wholly inside the row or wholly on
// one clamped side of it, by the entry's checks); else one float a thread
// item, 8 pairs x 4 positions a warp.
__device__ __forceinline__ void load_rows(const float* __restrict__ x, float2* slab,
                                          int k1, int C, int l0, int L, int npairs,
                                          int A, int raw, int pad_m, bool vec,
                                          int threads) {
  if (vec) {
    for (int it = threadIdx.x; it < C / 4 * kCols; it += threads) {
      const int col = it % kCols;
      const int n2 = it / kCols * 4;
      const int l = l0 + col;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (l < L) {
        bool has_im;
        const float* re = x + pair_row(l, npairs, A, has_im) * raw;
        const int q = k1 * C + n2 - pad_m;
        if (q >= 0 && q < raw) {
          a = *reinterpret_cast<const float4*>(re + q);
          if (has_im) b = *reinterpret_cast<const float4*>(re + raw + q);
        } else {
          const int e = q < 0 ? 0 : raw - 1;
          a = make_float4(re[e], re[e], re[e], re[e]);
          if (has_im) b = make_float4(re[raw + e], re[raw + e], re[raw + e], re[raw + e]);
        }
      }
      slab[slot(n2) * kCols + col] = make_float2(a.x, b.x);
      slab[slot(n2 + 1) * kCols + col] = make_float2(a.y, b.y);
      slab[slot(n2 + 2) * kCols + col] = make_float2(a.z, b.z);
      slab[slot(n2 + 3) * kCols + col] = make_float2(a.w, b.w);
    }
  } else {
    const int runs = (C + 3) / 4;
    for (int it = threadIdx.x; it < runs * 4 * kCols; it += threads) {
      const int n2 = it / (4 * kCols) * 4 + it % 4;
      const int col = it / 4 % kCols;
      if (n2 >= C) continue;
      const int l = l0 + col;
      float2 v = make_float2(0.f, 0.f);
      if (l < L) {
        bool has_im;
        const float* re = x + pair_row(l, npairs, A, has_im) * raw;
        const int q = min(max(k1 * C + n2 - pad_m, 0), raw - 1);
        v = make_float2(re[q], has_im ? re[raw + q] : 0.f);
      }
      slab[slot(n2) * kCols + col] = v;
    }
  }
}

// Ff's store: block m1 holds grid positions m1*C + m2 in natural order, in
// the inverse's swapped frame; those in the crop go to column
// m1*C + m2 - unpad_m, the im part to row 2j and the re part to row 2j + 1
// where it exists.  vec: runs of 4 by 16-byte stores (each run wholly
// inside or outside the crop), else one float a thread item.
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float2* slab,
                                           int m1, int C, int l0, int L, int npairs,
                                           int A, int unpad_m, int width, bool vec,
                                           int threads) {
  if (vec) {
    for (int it = threadIdx.x; it < C / 4 * kCols; it += threads) {
      const int col = it % kCols;
      const int n2 = it / kCols * 4;
      const int l = l0 + col;
      const int o = m1 * C + n2 - unpad_m;
      if (l >= L || o < 0 || o >= width) continue;
      const float2 v0 = slab[slot(n2) * kCols + col], v1 = slab[slot(n2 + 1) * kCols + col];
      const float2 v2 = slab[slot(n2 + 2) * kCols + col], v3 = slab[slot(n2 + 3) * kCols + col];
      bool has_im;
      float* dst = out + pair_row(l, npairs, A, has_im) * width + o;
      *reinterpret_cast<float4*>(dst) = make_float4(v0.y, v1.y, v2.y, v3.y);
      if (has_im) *reinterpret_cast<float4*>(dst + width) = make_float4(v0.x, v1.x, v2.x, v3.x);
    }
  } else {
    const int runs = (C + 3) / 4;
    for (int it = threadIdx.x; it < runs * 4 * kCols; it += threads) {
      const int n2 = it / (4 * kCols) * 4 + it % 4;
      const int col = it / 4 % kCols;
      const int l = l0 + col;
      const int o = m1 * C + n2 - unpad_m;
      if (n2 >= C || l >= L || o < 0 || o >= width) continue;
      const float2 v = slab[slot(n2) * kCols + col];
      bool has_im;
      float* dst = out + pair_row(l, npairs, A, has_im) * width + o;
      dst[0] = v.y;
      if (has_im) dst[width] = v.x;
    }
  }
}

// X'[k] = X[k] * filt[k] (the 1/ow folded into the table), stored swapped:
// the inverse runs as the forward transform in that frame
__device__ __forceinline__ float2 filter_swap(float2 v, const float2* __restrict__ filt,
                                              int k) {
  const float2 y = cmul(v, __ldg(&filt[k]));
  return make_float2(y.y, y.x);
}

// Ff's turn from the forward to the inverse transform: the last forward
// stage (radix R, M = 1, so no twiddle), the filter multiply at
// X[k1 + B*k2], the swap, and the first stage of the transposed network
// (again M = 1), all in one thread's registers: the last forward stage and
// its transpose touch the same R positions, so no barrier and no shared-
// memory round trip lie between them.
template <int C_, int R1, int R2, int R3, int R4, int R>
__device__ __forceinline__ void filter_butterflies(float2* s, const float2* __restrict__ filt,
                                                   int k1, int B, int C,
                                                   const StagePlan& plan, int threads) {
  const int n_butterflies = C / R * kCols;
  for (int b = threadIdx.x; b < n_butterflies; b += threads) {
    const int col = b % kCols;
    const int base = b / kCols * R;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = s[slot(base + q) * kCols + col];
    Dft<R>::run(x);
#pragma unroll
    for (int p = 0; p < R; ++p)
      x[p] = filter_swap(x[p], filt,
                         k1 + B * digit_reversed<C_, R1, R2, R3, R4>(base + p, plan, C));
    Dft<R>::run(x);
#pragma unroll
    for (int q = 0; q < R; ++q) s[slot(base + q) * kCols + col] = x[q];
  }
  __syncthreads();
}

// The same turn for a run-time plan: fused where the last radix has a
// register butterfly; else the last stage, the multiply as a pass of its
// own, and the transposed last stage.
__device__ __forceinline__ void filter_turn(float2* s, const float2* w,
                                            const float2* __restrict__ filt, int k1, int B,
                                            int C, const StagePlan& plan, int threads) {
  const int r = plan.radix[plan.n - 1];
  switch (r) {
    case 16: filter_butterflies<0, 1, 1, 1, 1, 16>(s, filt, k1, B, C, plan, threads); return;
    case 8: filter_butterflies<0, 1, 1, 1, 1, 8>(s, filt, k1, B, C, plan, threads); return;
    case 5: filter_butterflies<0, 1, 1, 1, 1, 5>(s, filt, k1, B, C, plan, threads); return;
    case 4: filter_butterflies<0, 1, 1, 1, 1, 4>(s, filt, k1, B, C, plan, threads); return;
    case 3: filter_butterflies<0, 1, 1, 1, 1, 3>(s, filt, k1, B, C, plan, threads); return;
    case 2: filter_butterflies<0, 1, 1, 1, 1, 2>(s, filt, k1, B, C, plan, threads); return;
    default: break;
  }
  stage_outputs<false>(s, w, C, r, r);
  for (int it = threadIdx.x; it < C * kCols; it += threads) {
    const int pos = it / kCols;
    float2& v = s[slot(pos) * kCols + it % kCols];
    v = filter_swap(v, filt, k1 + B * digit_reversed<0, 1, 1, 1, 1>(pos, plan, C));
  }
  __syncthreads();
  stage_outputs<true>(s, w, C, r, r);
}

// The inverse's B step, the transpose of b_step: block m1 of the cluster
// gets sum_k1 DFT_B[m1, k1] * T[k1, m2] * slab k1 [m2], for the m1 in
// [m_lo, m_hi] only (the blocks that hold part of the crop).
template <int B>
__device__ __forceinline__ void b_step_inverse(cg::cluster_group& cluster, float2* slab,
                                               const float2* wb,
                                               const float2* __restrict__ t_table, int C,
                                               int threads, int m_lo, int m_hi) {
  float2* remote[B];
#pragma unroll
  for (int n1 = 0; n1 < B; ++n1) remote[n1] = cluster.map_shared_rank(slab, n1);
  const int chunk = (C + B - 1) / B;
  const int first = static_cast<int>(cluster.block_rank()) * chunk;
  for (int it = threadIdx.x; it < chunk * kCols; it += threads) {
    const int m2 = first + it / kCols;
    if (m2 >= C) continue;
    const int idx = slot(m2) * kCols + it % kCols;
    float2 x[B];
    x[0] = remote[0][idx];
#pragma unroll
    for (int k1 = 1; k1 < B; ++k1) x[k1] = cmul(remote[k1][idx], t_table[k1 * C + m2]);
#pragma unroll
    for (int m1 = 0; m1 < B; ++m1) {
      if (m1 < m_lo || m1 > m_hi) continue;
      float2 y = x[0];
#pragma unroll
      for (int k1 = 1; k1 < B; ++k1) y = cadd(y, cmul(x[k1], wb[m1 * B + k1]));
      remote[m1][idx] = y;
    }
  }
}

template <int B>
__device__ __forceinline__ void b_steps(cg::cluster_group& cluster, float2* slab,
                                        const float2* wb, const float2* __restrict__ t_table,
                                        int C, int threads, bool inverse, int m_lo,
                                        int m_hi) {
  if (inverse)
    b_step_inverse<B>(cluster, slab, wb, t_table, C, threads, m_lo, m_hi);
  else
    b_step<B>(cluster, slab, wb, t_table, C, threads);
}

__device__ __forceinline__ void b_step_any(cg::cluster_group& cluster, float2* slab,
                                           const float2* wb, const float2* __restrict__ t_table,
                                           int B, int C, int threads, bool inverse, int m_lo,
                                           int m_hi) {
  switch (B) {
    case 2: b_steps<2>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    case 3: b_steps<3>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    case 4: b_steps<4>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    case 5: b_steps<5>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    case 6: b_steps<6>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    case 7: b_steps<7>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
    default: b_steps<8>(cluster, slab, wb, t_table, C, threads, inverse, m_lo, m_hi); break;
  }
}

// Ff's block: C_ > 0 the compile-time plan C_ = R1*R2*R3; C_ == 0: C and the
// radices come from `plan`.
template <int C_, int R1, int R2, int R3, int THREADS>
__global__ void __launch_bounds__(THREADS)
fft_axis2_filter_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float2* __restrict__ tables, const float2* __restrict__ filt,
                        int A, int raw, int B, int C_arg, StagePlan plan, int pad_m,
                        int unpad_m, int width, int L, bool vec) {
  extern __shared__ __align__(16) float2 f_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = C_ > 0 ? C_ : C_arg;
  float2* w = f_smem;                // roots w_C^j, C of them
  float2* wb = w + C;                // DFT_B, kMaxB * kMaxB slots
  float2* slab = wb + kMaxB * kMaxB; // (C rounded up to even) * kCols
  const float2* g_wb = tables;       // DFT_B (B, B)
  const float2* g_t = g_wb + B * B;  // T (B, C)
  const float2* g_w = g_t + B * C;   // roots (C)

  const int k1 = static_cast<int>(cluster.block_rank());  // blockIdx.x % B
  const int l0 = static_cast<int>(blockIdx.x / B) * kCols;
  const int npairs = (A + 1) / 2;
  const int m_lo = unpad_m / C, m_hi = (unpad_m + width - 1) / C;
  for (int j = threadIdx.x; j < C; j += THREADS) w[j] = g_w[j];
  for (int j = threadIdx.x; j < B * B; j += THREADS) wb[j] = g_wb[j];

  // 1. the slab n1 = k1 of the padded rows; 2. the B step
  load_rows(x, slab, k1, C, l0, L, npairs, A, raw, pad_m, vec, THREADS);
  cluster.sync();
  b_step_any(cluster, slab, wb, g_t, B, C, THREADS, false, 0, 0);
  cluster.sync();

  // 3. the forward C-point stages, the filter turn inside the last, the
  // transposed stages in the other order: slab k1 then holds, at position
  // m2, sum_k2 swap(X'[k1 + B*k2]) e^(-2i pi k2 m2 / C)
  if constexpr (C_ > 0) {
    static_assert(R1 > 1 && R2 > 1 && R3 > 1, "the compile-time plans have three stages");
    stage_butterflies<R1>(slab, w, C_, C_, THREADS);
    stage_butterflies<R2>(slab, w, C_, C_ / R1, THREADS);
    filter_butterflies<C_, R1, R2, R3, 1, R3>(slab, filt, k1, B, C_, plan, THREADS);
    stage_butterflies<R2, true>(slab, w, C_, C_ / R1, THREADS);
    stage_butterflies<R1, true>(slab, w, C_, C_, THREADS);
  } else {
    int Ls = C;
    for (int i = 0; i < plan.n - 1; ++i) {
      run_stage<false>(slab, w, C, Ls, plan.radix[i], THREADS);
      Ls /= plan.radix[i];
    }
    filter_turn(slab, w, filt, k1, B, C, plan, THREADS);
    for (int i = plan.n - 2; i >= 0; --i) {
      Ls *= plan.radix[i];
      run_stage<true>(slab, w, C, Ls, plan.radix[i], THREADS);
    }
  }
  cluster.sync();

  // 4. the inverse B step into the blocks that hold part of the crop;
  // 5. their store
  b_step_any(cluster, slab, wb, g_t, B, C, THREADS, true, m_lo, m_hi);
  cluster.sync();  // also keeps every slab alive until its readers are done
  if (k1 < m_lo || k1 > m_hi) return;
  store_rows(out, slab, k1, C, l0, L, npairs, A, unpad_m, width, vec, THREADS);
}

template <int C_, int R1, int R2, int R3, int THREADS>
int launch_filter(const float* x, float* out, const float* tables, const float* filt,
                  int A, int raw, int B, int C, const StagePlan& plan, int pad_m,
                  int unpad_m, int width, int L, bool vec, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((L + kCols - 1) / kCols) * B;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float2) * (C + kMaxB * kMaxB + static_cast<size_t>((C + 1) & ~1) * kCols);
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
  auto kernel = fft_axis2_filter_kernel<C_, R1, R2, R3, THREADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, x, out, reinterpret_cast<const float2*>(tables),
                           reinterpret_cast<const float2*>(filt), A, raw, B, C, plan, pad_m,
                           unpad_m, width, L, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// radices: n_stages host ints whose product is C (the wrapper's stage plan)
extern "C" int tt_fft_axis2(const float* re, const float* im, float* ore,
                            float* oim, const float* tables, int Z, int B,
                            int C, int L, const int* radices, int n_stages,
                            cudaStream_t stream) {
  StagePlan plan;
  const int err = make_plan(Z, B, C, L, radices, n_stages, &plan);
  if (err != 0) return err;
  return dispatch<kPlain>(re, im, ore, oim, tables, nullptr, 0.f, Z, B, C, plan, L, stream);
}

// Fc, pass 1 or 2 (see the head of this file).  centre: c(k), k < B*C, as
// float32 (re, im) pairs (pass 1; its L columns index it too); scale: the
// store's factor (pass 2, whose input is (Z, L, B*C), 16-byte aligned).
extern "C" int tt_fft_axis2_centred(const float* re, const float* im, float* ore,
                                    float* oim, const float* tables,
                                    const float* centre, float scale, int pass,
                                    int Z, int B, int C, int L, const int* radices,
                                    int n_stages, cudaStream_t stream) {
  StagePlan plan;
  const int err = make_plan(Z, B, C, L, radices, n_stages, &plan);
  if (err != 0) return err;
  if (pass == 1 && L <= B * C)
    return dispatch<kCentredRows>(re, im, ore, oim, tables, centre, scale, Z, B, C, plan,
                                  L, stream);
  if (pass != 2) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<std::uintptr_t>(re) | reinterpret_cast<std::uintptr_t>(im)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return dispatch<kCentredCols>(re, im, ore, oim, tables, centre, scale, Z, B, C, plan, L,
                                stream);
}

// Ff (see the head of this file): x (Z, A, raw) rows to out (Z, A, width);
// tables as F's for n = B*C, filt B*C float32 (re, im) pairs.
extern "C" int tt_fft_axis2_filter(const float* x, float* out, const float* tables,
                                   const float* filt, int Z, int A, int raw, int B, int C,
                                   int pad_m, int unpad_m, int width, const int* radices,
                                   int n_stages, cudaStream_t stream) {
  StagePlan plan;
  const int err = make_plan(Z, B, C, A, radices, n_stages, &plan);
  if (err != 0) return err;
  const long long L = static_cast<long long>(Z) * ((A + 1) / 2);
  if (A < 1 || raw < 1 || width < 1 || unpad_m < 0 || unpad_m + width > B * C ||
      L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const std::uintptr_t addresses =
      reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(out);
  const bool vec = C % 4 == 0 && raw % 4 == 0 && pad_m % 4 == 0 && unpad_m % 4 == 0 &&
                   width % 4 == 0 && addresses % 16 == 0;
  const int n = static_cast<int>(L);
  if (C == 1024 && plan_is(plan, 16, 8, 8))
    return launch_filter<1024, 16, 8, 8, 256>(x, out, tables, filt, A, raw, B, C, plan, pad_m,
                                              unpad_m, width, n, vec, stream);
  if (C == 640 && plan_is(plan, 5, 16, 8))
    return launch_filter<640, 5, 16, 8, 320>(x, out, tables, filt, A, raw, B, C, plan, pad_m,
                                             unpad_m, width, n, vec, stream);
  return launch_filter<0, 1, 1, 1, kPlanThreads>(x, out, tables, filt, A, raw, B, C, plan,
                                                 pad_m, unpad_m, width, n, vec, stream);
}
