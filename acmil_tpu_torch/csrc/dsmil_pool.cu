// Kernel B6: fused DSMIL bag-stream pooling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acmil_tpu/ops/dsmil_pool.py::_kernel, which
// fused_dsmil_pool launches. For each padded bag b and class c:
//
//   q_n      = x_n Wq + bq                                   [N, Q]
//   a_cn     = q_n . q_max_c / sqrt(Q),  -1e30 at masked rows [C, N]
//   p_c      = softmax of a_c over N, masked rows excluded
//   bag[c]   = sum_n p_cn x_n       (the RAW features, not q) [C, D]
//
// and the logits a (-1e30 at masked rows) are written out as the TPU kernel
// writes them.
//
// Arithmetic. The Pallas kernel forms q = x Wq + bq in full, [N, Q], only to
// dot it with C query vectors. Folding the queries first,
//
//   u_c = Wq q_max_c / sqrt(Q)   [D],   beta_c = bq . q_max_c / sqrt(Q),
//   a_cn = x_n . u_c + beta_c,
//
// cuts the per-row work from D*Q to D*C multiply-adds (64x fewer at Q = 128,
// C = 2); the logits then differ from the Pallas kernel's only in the order
// of f32 sums.
//
// Design (scripts/attn_variants.py --kernel b6 times the choices: the ring's
// depth, the stage size, the range count, the split-TF32 route where the
// rows kernel fits, class groups of 32, 64-row logits tiles, 4-byte logits
// copies; each of these loses or ties on an H100 at N = 65536;
// scripts/b6_widths.py times both routes at C = 2-8 and every pretrain D).
// The TPU walks a bag's N chunks in sequence on one core. Here each bag's
// 64-row tiles are split into a few contiguous ranges (chosen by the
// wrapper to fill the card about twice on the rows route, once on the
// split-TF32 route), one block a range, and each range leaves one
// partial (m, s, acc[C, D]) that a merge combines by the flash rule,
//
//   M = max_r m_r,  s = sum_r s_r e^(m_r - M),
//   bag = sum_r acc_r e^(m_r - M) / max(s, 1e-12),
//
// so an all-masked bag (s = 0, acc = 0) gives bag = 0 and no NaN, as the TPU
// kernel's max(s, 1e-12) does. The kernels:
//
//   b6_fold_kernel    u and beta, a block per (32 columns, bag, 8 classes),
//                     the Q terms split over its 8 warps and summed in order
//   b6_rows_kernel    where it fits (rows_fit: C <= 2 up to D = 1024, all D
//                     at C = 1, C <= 4 up to D = 512): one streamed read of
//                     the range through a ring of kStages slices of up to
//                     32 contiguous rows, each one TMA bulk copy completing
//                     on an mbarrier; fp16 rows stay fp16 in shared memory
//                     and are widened in registers. Each warp keeps its own
//                     online softmax over its rows of every slice (the dots
//                     x . u_c, the logits, (m, s) and acc += p x in
//                     registers), so a slice costs one __syncthreads; the
//                     8 warps' partials are merged in order at the range's
//                     end. All f32 FMA: at C = 2 the arithmetic is a fifth
//                     of the time the bytes take
//   b6_logits_kernel  elsewhere: per class group of G, the logits X U as a
//                     split-TF32 tensor-core product (tf32x3.cuh; fp16 x is
//                     exact in TF32, so two MMAs, three for f32 x), the
//                     range's (m, s) per class
//   b6_pool_kernel    with it: acc = X^T P per (range, 128 columns, class
//                     group), split-TF32 with p = e^(a - m_range) formed in
//                     shared memory (0 at masked rows, never e^0)
//   b6_merge_kernel   the flash merge, a block per (32 columns, class, bag),
//                     each range's weight formed once in shared memory
//
// So on the rows route x is read once; on the split-TF32 route twice per
// class group of G = 64 (C = 128: two groups), the pooling's read split
// over panels of 128 columns.
//
// Bounds. At N = 65536, D = 384, Q = 128, C = 2 with fp16 features the op
// reads 50.3 MB of x and writes 0.5 MB of logits: about 15 us at 3.35 TB/s.
// With the queries folded the arithmetic is 0.2 GFLOP, so the row kernel is
// bound by reading x once; a range's partial is C*D*4 bytes. At C = 128 the
// folded products are 12.9 GFLOP, 26 us at the TF32 rate with two MMAs a
// product, beside 100 MB of x and 67 MB of logits written and read back.
//
// Rows past N (and past a range's end) are masked in the kernels: the
// split-TF32 copies zero-fill them, the rows kernel never multiplies them;
// nothing is padded by a copy. No float atomics: every sum has a
// fixed order, so two launches give the same bits.
//
// Widths the kernel takes: D a multiple of 8 up to 1536, 1 <= C <= 128 (the
// TPU kernel's limit), any Q and N, at most kMaxRanges ranges a bag. The
// Python wrapper (acmil_tpu_torch/ops/dsmil_pool.py) checks them, chooses
// the ranges, lays out the workspace and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;                  // rows of x per tile; ranges are whole tiles
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldC = 8;                  // classes a fold block
constexpr int kRowsMaxC = 4;               // classes of the rows route, at most
constexpr int kMaxClasses = 128;           // classes per bag
constexpr int kMaxD = 1536;
constexpr int kMaxRanges = 1024;           // ranges per bag the merge takes
constexpr int kMaxSlice = 32;              // rows per ring stage, at most
constexpr int kStageBytes = 32768;         // bytes per ring stage, at most
constexpr int kStages = 3;                 // ring depth of the rows kernel
// classes per group of the split-TF32 products, at most
constexpr int kMaxG = 64;
constexpr int kMergeCols = 32;             // columns of D per merge block
constexpr int kSmemMax = 232448;
constexpr float kNeg = -1e30f;             // logit at masked rows, as on the TPU

// split-TF32 products: x tiles of kLTile rows (logits) or 128 columns x 32
// rows (pooling), 32-deep slices, 3 stages
constexpr int kBK = 32, kGemmStages = 3, kPoolCols = 128, kPoolRows = 32;
// the pooling stages a slice's logits 16 bytes a copy where N % 4 == 0
constexpr bool kLogits16 = true;
constexpr int kPStride = kPoolRows + 4;    // p [G][kPStride] (hi, lo) in shared memory
constexpr int kLTile = 128;                // rows a logits tile
constexpr int kLStride = kLTile + 4;       // logits [G][kLStride]

using tf32x3::raise_smem;
using tf32x3::SmemLimit;

__device__ __forceinline__ bool row_valid(const uint8_t* mask_b, int row,
                                          int end) {
  return row < end && mask_b[row] != 0;
}

// 4 bytes from global to shared memory, or 4 zero bytes where !pred
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

// The TMA's one-dimensional bulk copy of `bytes` (a multiple of 16) from
// global to shared memory, completing on the mbarrier `bar`, and the
// mbarrier's few operations
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "wait:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra wait;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// eight consecutive elements of shared memory, 16-byte aligned, as f32
__device__ __forceinline__ void load8s(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8s(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ---- the fold: u[b, c, d] = inv_sqrt_q sum_q wq_t[q, d] q_max[b, c, q] and
// beta[b, c] (column d == D, from bq). A block per (32 columns, bag, group of
// 8 classes); lane l owns column 32 x + l, warp w sums the terms q = w, w +
// 8, ... (each warp reads 128 contiguous bytes of a row of wq_t). The terms
// come kFoldQ at a time, a warp's 16 loads issued together, with the
// group's q_max through shared memory; the 8 warps' sums are added in
// order ---------------------------------------------------------------------
constexpr int kFoldQ = 128;                // terms of q a pass
__global__ void __launch_bounds__(kThreads)
b6_fold_kernel(const float* __restrict__ wq_t,    // [Q, D]
               const float* __restrict__ bq,      // [Q]
               const float* __restrict__ q_max,   // [B, C, Q]
               float* __restrict__ u,             // [B, C, D]
               float* __restrict__ beta,          // [B, C]
               int d_feat, int q_dim, int n_cls, float inv_sqrt_q) {
  __shared__ float red[kWarps][kFoldC][32];
  __shared__ float qs[kFoldC][kFoldQ];
  constexpr int kPer = kFoldQ / kWarps;   // terms a warp takes a pass
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kFoldC;
  const int ncl = min(kFoldC, n_cls - c0);
  const int d = blockIdx.x * 32 + lane;
  const float* qm = q_max + (static_cast<size_t>(b) * n_cls + c0) * q_dim;
  float acc[kFoldC];
#pragma unroll
  for (int c = 0; c < kFoldC; ++c) acc[c] = 0.f;
  for (int q0 = 0; q0 < q_dim; q0 += kFoldQ) {
    float w[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = q0 + warp + kWarps * i;
      w[i] = q >= q_dim || d > d_feat ? 0.f
             : d < d_feat ? __ldg(wq_t + static_cast<size_t>(q) * d_feat + d)
                          : __ldg(bq + q);
    }
    for (int i = threadIdx.x; i < kFoldC * kFoldQ; i += kThreads) {
      const int c = i / kFoldQ, q = q0 + i % kFoldQ;
      qs[c][i % kFoldQ] = c < ncl && q < q_dim ? __ldg(qm + c * q_dim + q) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kFoldC; ++c)
        acc[c] = fmaf(w[i], qs[c][warp + kWarps * i], acc[c]);
    __syncthreads();   // qs is rewritten by the next pass
  }
#pragma unroll
  for (int c = 0; c < kFoldC; ++c) red[warp][c][lane] = acc[c];
  __syncthreads();
  const int c = threadIdx.x / 32;      // one (class, column) a thread
  if (c < ncl && d <= d_feat) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][c][lane];
    s *= inv_sqrt_q;
    const size_t o = static_cast<size_t>(b) * n_cls + c0 + c;
    if (d < d_feat)
      u[o * d_feat + d] = s;
    else
      beta[o] = s;
  }
}

// units of 8 columns, 256 apart, a lane of the rows kernel accumulates at
// NC classes: 48 accumulators a lane at NC = 1, 64 at NC = 2 and 4
__host__ __device__ constexpr int rows_units(int nc) { return nc == 1 ? 6 : 8 / nc; }
// NC of c classes
constexpr int rows_nc(int c) { return c == 1 ? 1 : c == 2 ? 2 : 4; }
// Whether the rows kernel takes c classes of d columns: its accumulators
// must hold all of D (ops/dsmil_pool.py's _B6_ROWS_MAX_D). A block holding
// part of D would read the rows once per part, and with more classes its
// registers spill: the split-TF32 route is faster there on an H100.
constexpr bool rows_fit(int c, int d) {
  return c <= kRowsMaxC && d <= 256 * rows_units(rows_nc(c));
}

// bytes of the rows kernel's ring, which its merge of the warps' partials
// ([C][256 kU] floats) reuses; u follows
template <typename T>
__host__ __device__ size_t rows_ring_bytes(int slice, int d_feat, int n_cls, int ku) {
  const size_t ring = sizeof(T) * kStages * slice * d_feat;
  const size_t merge = sizeof(float) * n_cls * 256 * ku;
  return ring > merge ? ring : merge;
}

// ---- the rows route (rows_fit): one block per (range, bag). NC >= C sizes
// the per-class registers, and a lane accumulates kU units of 8 columns,
// 256 apart (rows_units: at most 64 accumulators), which cover D. Per ring
// slice of `slice` rows, warp w takes the rows w, w + 8, w + 16, w + 24
// and keeps its own online softmax over them:
//   the dots x . u_c, lane l over the columns 8 l + 256 k (u from shared
//   memory, each element serving the warp's rows at once), summed by a
//   butterfly that leaves every lane the total; the logits to [B, C, N];
//   the warp's (m, s) per class, rescaled only when m grows; acc += p x over
//   the lane's columns.
// So a slice costs one __syncthreads. At the range's end the 8 warps'
// partials are merged in order (the flash rule) through shared memory.
template <typename T, int NC, int kU>
__global__ void __launch_bounds__(kThreads, 2)
b6_rows_kernel(const T* __restrict__ feats,        // [B, N, D]
               const uint8_t* __restrict__ mask,   // [B, N]
               const float* __restrict__ u,        // [B, C, D]
               const float* __restrict__ beta,     // [B, C]
               float* __restrict__ logits,         // [B, C, N]
               float* __restrict__ part_m,         // [B, R, C]
               float* __restrict__ part_s,         // [B, R, C]
               float* __restrict__ part_acc,       // [B, R, C, D]
               int n, int d_feat, int n_cls, int ranges, int range_rows,
               int slice) {
  constexpr int kRows = kMaxSlice / kWarps;  // rows a warp takes a slice
  extern __shared__ __align__(16) char smem[];
  __shared__ float wm[kWarps][kRowsMaxC], ws[kWarps][kRowsMaxC];
  __shared__ __align__(8) uint64_t full[kStages];   // a stage's rows have landed
  const int stage_elems = slice * d_feat;
  T* ring = reinterpret_cast<T*>(smem);                        // [kStages][slice][D]
  float* buf = reinterpret_cast<float*>(smem);                 // after the ring: [C][256 kU]
  float* us = reinterpret_cast<float*>(smem + rows_ring_bytes<T>(slice, d_feat, n_cls, kU));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r = blockIdx.x, b = blockIdx.y;
  const int r0 = r * range_rows, r1 = min(n, r0 + range_rows);
  const T* xb = feats + static_cast<size_t>(b) * n * d_feat;
  const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
  float bc[NC], m[NC], s[NC], acc[NC][kU][8];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    bc[c] = c < n_cls ? beta[b * n_cls + c] : 0.f;
    m[c] = kNeg;
    s[c] = 0.f;
#pragma unroll
    for (int k = 0; k < kU; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][k][j] = 0.f;
  }

  // slice i's rows (those before the range's end: a slice's rows are
  // contiguous) into stage i % kStages by one bulk copy of thread 0
  const int slices = (r1 - r0 + slice - 1) / slice;
  auto issue = [&](int i) {
    const int row0 = r0 + i * slice;
    bulk_copy(ring + (i % kStages) * stage_elems,
              xb + static_cast<size_t>(row0) * d_feat,
              sizeof(T) * min(slice, r1 - row0) * d_feat, full + i % kStages);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(full + i);
    for (int i = 0; i < kStages - 1 && i < slices; ++i) issue(i);
  }
  // u while the first slices are on their way
  const float* ub = u + static_cast<size_t>(b) * n_cls * d_feat;
  for (int i = 4 * tid; i < n_cls * d_feat; i += 4 * kThreads)
    *reinterpret_cast<float4*>(us + i) = *reinterpret_cast<const float4*>(ub + i);
  __syncthreads();   // the barriers are initialised, u is in
  // lane l reads the mask of row l of the next slice a slice ahead
  bool valid_next = lane < slice && row_valid(mask_b, r0 + lane, r1);

  for (int it = 0; it < slices; ++it) {
    bar_wait(full + it % kStages, (it / kStages) & 1);
    __syncthreads();   // slice it is in; slice it - 1 is consumed
    if (tid == 0 && it + kStages - 1 < slices) issue(it + kStages - 1);
    const T* xs = ring + (it % kStages) * stage_elems;
    const int row0 = r0 + it * slice;
    const int rows = min(slice, r1 - row0);   // the rows the copy brought
    const unsigned vbits = __ballot_sync(0xffffffffu, valid_next);
    valid_next = lane < slice && row_valid(mask_b, row0 + slice + lane, r1);
    if (warp >= slice) continue;   // slices of 4 rows leave warps idle

    // ---- the dots of the warp's rows ---------------------------------------
    float a[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) a[i][c] = 0.f;
    for (int e = 8 * lane; e < d_feat; e += 256) {
      float xv[kRows][8];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = warp + kWarps * i;
        if (rr < slice) {
          load8s(xs + rr * d_feat + e, xv[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= n_cls) break;
        float uv[8];
        load8s(us + c * d_feat + e, uv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][c] = fmaf(xv[i][j], uv[j], a[i][c]);
      }
    }
    // ---- logits, the warp's online softmax, p --------------------------------
    float p[kRows][NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = warp + kWarps * i;
        float v = a[i][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        v = rr < slice && (vbits >> rr & 1u) ? v + bc[c] : kNeg;
        if (lane == i * NC + c && c < n_cls && row0 + rr < r1 && rr < slice)
          logits[(static_cast<size_t>(b) * n_cls + c) * n + row0 + rr] = v;
        a[i][c] = v;
        mx = fmaxf(mx, v);
      }
      if (mx > m[c]) {   // warp-uniform: every lane holds the same sums
        const float scale = expf(m[c] - mx);
        s[c] *= scale;
#pragma unroll
        for (int k = 0; k < kU; ++k)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][k][j] *= scale;
        m[c] = mx;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = warp + kWarps * i;
        p[i][c] = rr < slice && (vbits >> rr & 1u) ? expf(a[i][c] - m[c]) : 0.f;
        s[c] += p[i][c];
      }
    }
    // ---- acc += p x over the lane's columns -----------------------------------
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int e = 8 * lane + 256 * k;
      if (e >= d_feat) break;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = warp + kWarps * i;
        if (rr >= rows) break;
        float xv[8];
        load8s(xs + rr * d_feat + e, xv);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][k][j] = fmaf(p[i][c], xv[j], acc[c][k][j]);
      }
    }
  }

  // ---- merge the warps' partials in order: M = max_w m_w, each warp's share
  // scaled by e^(m_w - M), added to buf one warp after another ---------------
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wm[warp][c] = m[c];
      ws[warp][c] = s[c];
    }
  }
  __syncthreads();   // the ring is consumed: buf may take its place
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float mall = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mall = fmaxf(mall, wm[w][c]);
    const float f = expf(m[c] - mall);
#pragma unroll
    for (int k = 0; k < kU; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][k][j] *= f;
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= n_cls) break;
#pragma unroll
        for (int k = 0; k < kU; ++k) {
          const int e = 8 * lane + 256 * k;
          if (e >= d_feat) break;
          float4* dst = reinterpret_cast<float4*>(buf + c * 256 * kU + e);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 v = make_float4(acc[c][k][4 * h], acc[c][k][4 * h + 1],
                                   acc[c][k][4 * h + 2], acc[c][k][4 * h + 3]);
            if (w > 0) {
              const float4 o = dst[h];
              v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
            }
            dst[h] = v;
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t part = static_cast<size_t>(b) * ranges + r;
  if (tid < n_cls) {
    float mall = kNeg, sall = 0.f;
    for (int w = 0; w < kWarps; ++w) mall = fmaxf(mall, wm[w][tid]);
    for (int w = 0; w < kWarps; ++w) sall += ws[w][tid] * expf(wm[w][tid] - mall);
    part_m[part * n_cls + tid] = mall;
    part_s[part * n_cls + tid] = sall;
  }
  for (int i = 4 * tid; i < n_cls * 256 * kU; i += 4 * kThreads) {
    const int c = i / (256 * kU), e = i % (256 * kU);
    if (e < d_feat)
      *reinterpret_cast<float4*>(part_acc + (part * n_cls + c) * d_feat + e) =
          *reinterpret_cast<const float4*>(buf + i);
  }
}

// ---- the split-TF32 route (where the rows kernel does not fit) -----------
// logits tile [kLTile rows][G classes] = X U^T: A = x (row, d), B(k = d, n =
// c) = u[c][d], both read as they lie (K-major); warps 4 x 2
template <typename T, int G>
using GemmL = tf32x3::BlockGemm<tf32x3::Operand<T, true, kLTile, kBK>,
                                tf32x3::Operand<float, true, G, kBK>, kLTile,
                                G, kBK, 4, 2, kGemmStages>;
// x^T staged for the pooling: (i = column, k = row), kPoolRows rows a slice
template <typename T>
using PoolX = tf32x3::Operand<T, false, kPoolCols, kPoolRows>;

// One block per (range, bag, group of G classes): the range's rows in tiles
// of kLTile, in order, each tile's logits by GemmL, then per class (a warp each) beta,
// the mask, the logits to [B, C, N] and the running (m, s).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
b6_logits_kernel(const T* __restrict__ feats,       // [B, N, D]
                 const uint8_t* __restrict__ mask,  // [B, N]
                 const float* __restrict__ u,       // [B, C, D]
                 const float* __restrict__ beta,    // [B, C]
                 float* __restrict__ logits,        // [B, C, N]
                 float* __restrict__ part_m,        // [B, R, C]
                 float* __restrict__ part_s,        // [B, R, C]
                 int n, int d_feat, int n_cls, int ranges, int range_rows) {
  using Gemm = GemmL<T, G>;
  extern __shared__ __align__(16) char smem[];
  float* lt = reinterpret_cast<float*>(smem + Gemm::kSmemBytes);  // [G][kLStride]
  float* ms = lt + G * kLStride;             // [G] running max
  float* ss = ms + G;                        // [G] running sum
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * G;
  const int ncl = min(G, n_cls - c0);
  const int r0 = r * range_rows, r1 = min(n, r0 + range_rows);
  const T* xb = feats + static_cast<size_t>(b) * n * d_feat;
  const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
  const size_t g0 = static_cast<size_t>(b) * n_cls + c0;   // the group's first (bag, class)
  for (int i = threadIdx.x; i < G; i += kThreads) {
    ms[i] = kNeg;
    ss[i] = 0.f;
  }
  const tf32x3::Operand<T, true, kLTile, kBK> xa{xb, d_feat, r1, d_feat};
  const tf32x3::Operand<float, true, G, kBK> ua{u + g0 * d_feat, d_feat, ncl,
                                                d_feat};
  // every write to lt or ms below comes after the tile's product has passed
  // a __syncthreads, so the tiles need no other barrier
  for (int t0 = r0; t0 < r1; t0 += kLTile) {
    float acc[Gemm::kMT][Gemm::kNT][4];
    Gemm::zero(acc);
    Gemm::run(acc, xa, ua, t0, 0, 0, d_feat, smem);
    Gemm::for_pairs(acc, 0, 0, [&](int row, int c, float v0, float v1) {
      lt[c * kLStride + row] = v0;
      lt[(c + 1) * kLStride + row] = v1;
    });
    __syncthreads();
    for (int c = warp; c < ncl; c += kWarps) {
      const float bc = beta[g0 + c];
      constexpr int kPerLane = kLTile / 32;
      float a[kPerLane], mx = kNeg;
      bool valid[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int row = t0 + lane + 32 * q;
        valid[q] = row_valid(mask_b, row, r1);
        a[q] = valid[q] ? lt[c * kLStride + lane + 32 * q] + bc : kNeg;
        if (row < r1) logits[(g0 + c) * n + row] = a[q];
        mx = fmaxf(mx, a[q]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[c];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) ps += valid[q] ? expf(a[q] - m_new) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      __syncwarp();
      if (lane == 0) {
        ss[c] = fmaf(ss[c], expf(m_old - m_new), ps);
        ms[c] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(b) * ranges + r;
  for (int i = threadIdx.x; i < ncl; i += kThreads) {
    part_m[part * n_cls + c0 + i] = ms[i];
    part_s[part * n_cls + c0 + i] = ss[i];
  }
}

// One block per (range, bag, 128 columns x group of G classes): acc[d][c] =
// sum over the range's rows of x[row][d] p[c][row], p = e^(a - m_range) (0 at
// masked rows and past the range), as split-TF32 m16n8k8 products: warp w
// owns columns 16 w .. 16 w + 15 and every class of the group. Each ring
// stage holds a slice of kPoolRows rows of x and of the logits
// b6_logits_kernel wrote (16-byte copies where N % 4 == 0, else 4-byte
// copies: a class's logits then start anywhere);
// the slice's p is formed once in shared memory, already split into TF32
// hi and lo. Thread t always forms p of row t % 32, so it reads that row's
// mask bit a slice ahead.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
b6_pool_kernel(const T* __restrict__ feats,         // [B, N, D]
               const uint8_t* __restrict__ mask,    // [B, N]
               const float* __restrict__ logits,    // [B, C, N]
               const float* __restrict__ part_m,    // [B, R, C]
               float* __restrict__ part_acc,        // [B, R, C, D]
               int n, int d_feat, int n_cls, int ranges, int range_rows) {
  using OpX = PoolX<T>;
  constexpr int kStage = OpX::kStageBytes + G * kPoolRows * 4;   // x, then logits
  extern __shared__ __align__(16) char smem[];
  uint2* pp = reinterpret_cast<uint2*>(smem + kGemmStages * kStage);  // [G][kPStride] (hi, lo)
  float* mg = reinterpret_cast<float*>(pp + G * kPStride);            // [G]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int panels = (d_feat + kPoolCols - 1) / kPoolCols;
  const int r = blockIdx.x, b = blockIdx.y;
  const int d0 = (blockIdx.z % panels) * kPoolCols;
  const int c0 = (blockIdx.z / panels) * G;
  const int ncl = min(G, n_cls - c0);
  const int r0 = r * range_rows, r1 = min(n, r0 + range_rows);
  const T* xb = feats + static_cast<size_t>(b) * n * d_feat;
  const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
  const float* lg = logits + (static_cast<size_t>(b) * n_cls + c0) * n;
  const size_t part = static_cast<size_t>(b) * ranges + r;
  for (int i = threadIdx.x; i < G; i += kThreads)
    mg[i] = i < ncl ? part_m[part * n_cls + c0 + i] : 0.f;
  const OpX xo{xb + d0, d_feat, d_feat - d0, r1};
  auto issue = [&](int i) {
    char* st = smem + (i % kGemmStages) * kStage;
    const int row0 = r0 + i * kPoolRows;
    xo.template load<kThreads>(reinterpret_cast<T*>(st), 0, row0);
    float* ls = reinterpret_cast<float*>(st + OpX::kStageBytes);
    if (kLogits16 && n % 4 == 0) {   // a class's rows start 16-byte aligned
      for (int q = 4 * threadIdx.x; q < G * kPoolRows; q += 4 * kThreads) {
        const int c = q / kPoolRows, row = row0 + q % kPoolRows;
        const bool ok = c < ncl && row < r1;   // r1 is N or a multiple of 64
        tf32x3::cp16(ls + q, ok ? lg + static_cast<size_t>(c) * n + row : lg, ok);
      }
    } else {
      for (int q = threadIdx.x; q < G * kPoolRows; q += kThreads) {
        const int c = q / kPoolRows, row = row0 + q % kPoolRows;
        const bool ok = c < ncl && row < r1;
        cp4(ls + q, ok ? lg + static_cast<size_t>(c) * n + row : lg, ok);
      }
    }
  };

  float acc[G / 8][4];
#pragma unroll
  for (int j = 0; j < G / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int slices = (r1 - r0 + kPoolRows - 1) / kPoolRows;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < slices) issue(s);
    tf32x3::cp_commit();
  }
  bool valid_next = row_valid(mask_b, r0 + lane, r1);
  const int g = lane / 4, t = lane % 4, m0 = 16 * warp;
  for (int it = 0; it < slices; ++it) {
    tf32x3::cp_wait<kGemmStages - 2>();
    __syncthreads();   // slice it is in; slice it - 1 and its p are consumed
    if (it + kGemmStages - 1 < slices) issue(it + kGemmStages - 1);
    tf32x3::cp_commit();
    const char* st = smem + (it % kGemmStages) * kStage;
    const float* ls = reinterpret_cast<const float*>(st + OpX::kStageBytes);
    const bool valid = valid_next;
    valid_next = row_valid(mask_b, r0 + (it + 1) * kPoolRows + lane, r1);
    for (int q = threadIdx.x; q < G * kPoolRows; q += kThreads) {
      const int c = q / kPoolRows, rr = q % kPoolRows;   // rr == lane
      uint32_t hi = 0u, lo = 0u;
      if (valid && c < ncl) tf32x3::split<0>(expf(ls[q] - mg[c]), hi, lo);
      pp[c * kPStride + rr] = make_uint2(hi, lo);
    }
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(st);
#pragma unroll
    for (int kk = 0; kk < kPoolRows; kk += 8) {
      uint32_t ah[4], al[4];
      tf32x3::split<OpX::kExact>(OpX::at(xs, m0 + g, kk + t), ah[0], al[0]);
      tf32x3::split<OpX::kExact>(OpX::at(xs, m0 + g + 8, kk + t), ah[1], al[1]);
      tf32x3::split<OpX::kExact>(OpX::at(xs, m0 + g, kk + t + 4), ah[2], al[2]);
      tf32x3::split<OpX::kExact>(OpX::at(xs, m0 + g + 8, kk + t + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < G / 8; ++j) {
        const uint2* pc = pp + (8 * j + g) * kPStride + kk + t;
        const uint2 p0 = pc[0], p1 = pc[4];
        const uint32_t bh[2] = {p0.x, p1.x}, bl[2] = {p0.y, p1.y};
        if (!OpX::kExact) tf32x3::mma(acc[j], al, bh);
        tf32x3::mma(acc[j], ah, bl);
        tf32x3::mma(acc[j], ah, bh);
      }
    }
  }
  tf32x3::cp_wait<0>();
  // acc[j][e] is column d0 + m0 + g + 8 (e / 2) of class c0 + 8 j + 2 t + e % 2
#pragma unroll
  for (int j = 0; j < G / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + e % 2, d = d0 + m0 + g + 8 * (e / 2);
      if (c < ncl && d < d_feat)
        part_acc[(part * n_cls + c0 + c) * d_feat + d] = acc[j][e];
    }
}

// ---- the flash merge of bag b's ranges, for class c and the 32 columns
// from col0: each range's weight e^(m_r - M) is formed once, in shared
// memory; warp w sums the ranges w, w + 8, ... of its lane's column, then
// the 8 warps' sums are added in order. Every sum has a fixed order. A fully
// masked range (m = -1e30, s = 0, acc = 0) adds nothing, and an all-masked
// bag ends with s = 0 and bag = 0. One block per (32 columns, class, bag) --
__global__ void __launch_bounds__(kThreads)
b6_merge_kernel(const float* __restrict__ part_m,    // [B, R, C]
                const float* __restrict__ part_s,    // [B, R, C]
                const float* __restrict__ part_acc,  // [B, R, C, D]
                float* __restrict__ bag,             // [B, C, D]
                int ranges, int n_cls, int d_feat) {
  __shared__ float wgt[kMaxRanges];
  __shared__ float red_acc[kWarps][kMergeCols];
  __shared__ float red_w[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.z, c = blockIdx.y, col0 = blockIdx.x * kMergeCols;
  const size_t base = static_cast<size_t>(b) * ranges;

  // M = max_r m_r (a max is exact in any order)
  float mx = kNeg;
  for (int r = threadIdx.x; r < ranges; r += kThreads)
    mx = fmaxf(mx, part_m[(base + r) * n_cls + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red_w[warp] = mx;
  __syncthreads();
  float m_all = kNeg;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) m_all = fmaxf(m_all, red_w[i]);
  __syncthreads();   // red_w is written again below

  float s = 0.f;
  for (int r = threadIdx.x; r < ranges; r += kThreads) {
    const size_t o = (base + r) * n_cls + c;
    const float w = expf(part_m[o] - m_all);
    wgt[r] = w;
    s = fmaf(part_s[o], w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red_w[warp] = s;
  __syncthreads();

  const int col = col0 + lane;
  float a = 0.f;
  if (col < d_feat) {
    const float* acc_r = part_acc + (base * n_cls + c) * d_feat + col;
    const size_t stride = static_cast<size_t>(n_cls) * d_feat;   // a range's
#pragma unroll 16
    for (int r = warp; r < ranges; r += kWarps)
      a = fmaf(acc_r[r * stride], wgt[r], a);
  }
  red_acc[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < d_feat) {
    float a_all = 0.f, s_all = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      a_all += red_acc[i][lane];
      s_all += red_w[i];
    }
    bag[(static_cast<size_t>(b) * n_cls + c) * d_feat + col] =
        a_all / fmaxf(s_all, 1e-12f);
  }
}

struct Args {
  const void* feats; const uint8_t* mask;
  const float *wq_t, *bq, *q_max;
  float *logits, *bag, *u, *beta, *part_m, *part_s, *part_acc;
  int batch, n, d_feat, q_dim, n_cls, ranges, range_rows;
  float inv_sqrt_q;
  cudaStream_t stream;
};

// rows per ring stage of the rows kernel: the largest of 32, 16, 8, 4 whose
// stage fits kStageBytes and whose ring and u fit an SM beside the static
// arrays
template <typename T>
int rows_slice(int d_feat, int n_cls, int ku, size_t* smem_bytes) {
  const size_t us = sizeof(float) * n_cls * d_feat;
  int slice = kMaxSlice;
  while (slice > 4 && (sizeof(T) * slice * d_feat > kStageBytes ||
                       rows_ring_bytes<T>(slice, d_feat, n_cls, ku) + us >
                           kSmemMax - 8192))
    slice /= 2;
  *smem_bytes = rows_ring_bytes<T>(slice, d_feat, n_cls, ku) + us;
  return slice;
}

template <typename T, int NC, int KU>
cudaError_t launch_rows(const Args& a) {
  size_t bytes = 0;
  const int slice = rows_slice<T>(a.d_feat, a.n_cls, KU, &bytes);
  static SmemLimit limit;
  const cudaError_t err = raise_smem(b6_rows_kernel<T, NC, KU>, bytes, limit);
  if (err != cudaSuccess) return err;
  b6_rows_kernel<T, NC, KU><<<dim3(a.ranges, a.batch), kThreads, bytes,
                              a.stream>>>(
      static_cast<const T*>(a.feats), a.mask, a.u, a.beta, a.logits, a.part_m,
      a.part_s, a.part_acc, a.n, a.d_feat, a.n_cls, a.ranges, a.range_rows,
      slice);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_mma(const Args& a) {
  const int groups = (a.n_cls + G - 1) / G;
  const size_t lbytes =
      GemmL<T, G>::kSmemBytes + sizeof(float) * (G * kLStride + 2 * G);
  static SmemLimit llimit;
  cudaError_t err = raise_smem(b6_logits_kernel<T, G>, lbytes, llimit);
  if (err != cudaSuccess) return err;
  b6_logits_kernel<T, G><<<dim3(a.ranges, a.batch, groups), kThreads, lbytes,
                           a.stream>>>(
      static_cast<const T*>(a.feats), a.mask, a.u, a.beta, a.logits, a.part_m,
      a.part_s, a.n, a.d_feat, a.n_cls, a.ranges, a.range_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int panels = (a.d_feat + kPoolCols - 1) / kPoolCols;
  const size_t pbytes =
      kGemmStages * (PoolX<T>::kStageBytes + sizeof(float) * G * kPoolRows) +
      sizeof(uint2) * G * kPStride + sizeof(float) * G;
  static SmemLimit plimit;
  if ((err = raise_smem(b6_pool_kernel<T, G>, pbytes, plimit)) != cudaSuccess)
    return err;
  b6_pool_kernel<T, G><<<dim3(a.ranges, a.batch, groups * panels), kThreads,
                         pbytes, a.stream>>>(
      static_cast<const T*>(a.feats), a.mask, a.logits, a.part_m, a.part_acc,
      a.n, a.d_feat, a.n_cls, a.ranges, a.range_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a) {
  b6_fold_kernel<<<dim3((a.d_feat + 32) / 32, a.batch,
                        (a.n_cls + kFoldC - 1) / kFoldC),
                   kThreads, 0, a.stream>>>(a.wq_t, a.bq, a.q_max, a.u, a.beta,
                                            a.d_feat, a.q_dim, a.n_cls,
                                            a.inv_sqrt_q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (rows_fit(a.n_cls, a.d_feat)) {
    // C = 2 at D <= 512 takes 2 units, not 4: its registers then fit
    // without spilling
    err = a.n_cls == 1   ? launch_rows<T, 1, rows_units(1)>(a)
          : a.n_cls == 2 ? (a.d_feat <= 512 ? launch_rows<T, 2, 2>(a)
                                            : launch_rows<T, 2, rows_units(2)>(a))
                         : launch_rows<T, 4, rows_units(4)>(a);
  } else {
    // classes a group: 32 up to 32 classes, else kMaxG
    err = a.n_cls <= 32 || kMaxG == 32 ? launch_mma<T, 32>(a)
                                       : launch_mma<T, 64>(a);
  }
  if (err != cudaSuccess) return err;
  b6_merge_kernel<<<dim3((a.d_feat + kMergeCols - 1) / kMergeCols, a.n_cls,
                         a.batch),
                    kThreads, 0, a.stream>>>(a.part_m, a.part_s, a.part_acc,
                                             a.bag, a.ranges, a.n_cls, a.d_feat);
  return cudaGetLastError();
}

static_assert(kMaxSlice == 32 && kRowsMaxC * kMaxSlice / kWarps <= 32,
              "a lane a row of the slice, and a lane a (row, class) of a warp");
static_assert(kPoolCols == 16 * kWarps, "16 columns a warp in the pooling");
static_assert(kMaxG == 32 || kMaxG == 64, "class groups of 32 or 64");
static_assert(kPoolRows == 32 && kThreads % kPoolRows == 0,
              "the pooling's thread t forms p of row t % 32 only");

}  // namespace

extern "C" {

// Launches kernel B6 on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers: feats [B, N, D] (fp16 when feats_half
// is 1, else f32), mask [B, N] bytes, wq_t [Q, D] (Wq transposed: the torch
// Linear's weight), bq [Q], q_max [B, C, Q]; outputs logits [B, C, N] and bag
// [B, C, D]; workspace u [B, C, D] and beta [B, C] floats, part_m and part_s
// [B, R, C] floats and part_acc [B, R, C, D] floats, with
// R = `ranges` ranges a bag (at most kMaxRanges) of `range_tiles` tiles
// (kTile rows) each: every range holds at least one of the N rows, and the
// last ends at or past N. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for widths or ranges the kernel does not take).
int b6_dsmil_pool(const void* feats, int feats_half, const void* mask,
                  const float* wq_t, const float* bq, const float* q_max,
                  float* logits, float* bag, float* u, float* beta,
                  float* part_m, float* part_s, float* part_acc, int batch, int n, int d_feat, int q_dim, int n_cls,
                  int ranges, int range_tiles, float inv_sqrt_q, void* stream) {
  const long long range_rows = static_cast<long long>(range_tiles) * kTile;
  if (n_cls < 1 || n_cls > kMaxClasses || d_feat % 8 || d_feat < 8 ||
      d_feat > kMaxD || batch < 1 || batch > 65535 || n < 1 || q_dim < 1 ||
      ranges < 1 || ranges > kMaxRanges || range_tiles < 1 ||
      ranges * range_rows < n || (ranges - 1) * range_rows >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{feats, static_cast<const uint8_t*>(mask), wq_t, bq, q_max,
               logits, bag, u, beta, part_m, part_s, part_acc, batch, n, d_feat, q_dim, n_cls, ranges,
               static_cast<int>(range_rows), inv_sqrt_q,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(feats_half ? launch<__half>(a) : launch<float>(a));
}

}  // extern "C"
