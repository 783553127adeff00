// The H stage of the gated-attention pooling, shared by kernels B1 (the
// forward, attn_pool.cu) and B2 (the backward, attn_pool_bwd.cu):
//
//   gated_h_norms_kernel  |x| of every row and |W1| of every column
//   gated_h_kernel        H = relu(X W1 + b1), [M, Df] [Df, L] -> [M, L] f32,
//                         in 128 x 128 tiles of split-TF32 products
//                         (tf32x3.cuh); with kDp (B2 only) also each
//                         128-column panel's part of H d_bag^T
//   gated_h_fix_kernel    the near-0 elements gated_h_kernel listed,
//                         recomputed in the forward's order
//
// M = B N rows of the bags' features, one after another.
//
// The relu mask. H is discontinuous in its sign: where x W1 + b1 is within
// rounding of 0, two ways of summing it can give the mask opposite signs,
// and B2 then sends an element's whole d_h into dW1 and db1, or not. So
// every pre-activation within kMaskTol |x_row| |W1_col| of 0 (a bound on the
// rounding of either sum, by Cauchy-Schwarz; never one of a zero row, whose
// sum is exactly 0 either way) is recomputed as one f32 FMA chain over d in
// order, about 1 element in 10^4. B1 and B2 run this same code on the same
// tiles, so for the same inputs their H are the same bits and their relu
// masks agree by construction.
//
// Determinism: no float atomics. The listing's int atomicAdd only orders
// the list; each listed element is recomputed the same way wherever it
// lands.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

// Internal linkage: each library that includes this header keeps its own
// kernels and its own once-per-kernel statics (SmemLimit), even where
// several such libraries are loaded into one process.
namespace {
namespace gated_h {

constexpr int kA = 128;            // gated-attention hidden width
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
// a pre-activation within this share of |x_row| |W1_col| of 0 is recomputed
// in the forward's order: 2**-17, several times the rounding of a sum of up
// to 1536 terms in either order
constexpr float kMaskTol = 7.62939453125e-06f;
constexpr int kMaxNear = 512;      // near-0 elements a tile lists
constexpr int kMaxK = 128;         // attention branches the kernels take

// 128 x 128 output tiles, 32-deep slices, warps 2 x 4 (64 x 32 each), 3
// stages
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;

template <typename T, bool kKMajor, int kExtent>
using Op = tf32x3::Operand<T, kKMajor, kExtent, kBK>;
template <class A, class B>
using Gemm = tf32x3::BlockGemm<A, B, kBM, kBN, kBK, 2, 4, kStages>;
// A = x (row, d), B(k = d, n = l) = W1[d][l]
template <typename T>
using GemmH = Gemm<Op<T, true, kBM>, Op<float, false, kBN>>;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

using tf32x3::raise_smem;
using tf32x3::SmemLimit;

// ---- |x| per row and |W1| per column -----------------------------------------
// Blocks from col_blocks on take 32 rows of x, 8 lanes a row (each lane's
// loads issued together); the first ones 32 columns of W1 each, 8 warps
// summing every 8th row, then the 8 sums in order (they start first, as
// they are the longest). norms = [xn (M) | wn (L)].
constexpr int kNormRows = kThreads / 8;
template <typename T>
__global__ void __launch_bounds__(kThreads)
gated_h_norms_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                     float* __restrict__ norms, int m, int df, int l_dim) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col_blocks = l_dim / 32;
  if (static_cast<int>(blockIdx.x) >= col_blocks) {
    constexpr int kVec = 16 / sizeof(T);
    const int r = (blockIdx.x - col_blocks) * kNormRows + threadIdx.x / 8;
    const T* xr = x + static_cast<size_t>(min(r, m - 1)) * df;
    float s = 0.f;
#pragma unroll 4
    for (int d = (threadIdx.x % 8) * kVec; d < df; d += 8 * kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + d));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float f = tf32x3::widen(v[i]);
        s = fmaf(f, f, s);
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x % 8 == 0 && r < m) norms[r] = sqrtf(s);
  } else {
    const int c = blockIdx.x * 32 + lane;
    float s = 0.f;
#pragma unroll 4
    for (int d = warp; d < df; d += kWarps) {
      const float v = w1[static_cast<size_t>(d) * l_dim + c];
      s = fmaf(v, v, s);
    }
    sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) t += sums[i][lane];
      norms[m + c] = sqrtf(t);
    }
  }
}

// ---- H = relu(x W1 + b1), [M, L] f32 ----------------------------------------
// x W1 + b1 as the forward sums it: one f32 FMA chain over d in order. w1t
// is W1 transposed, [L, Df], so that a column is contiguous.
template <typename T>
__device__ float forward_preact(const T* __restrict__ x,
                                const float* __restrict__ w1t,
                                const float* __restrict__ b1, int r, int c,
                                int df) {
  const T* xr = x + static_cast<size_t>(r) * df;
  const float* wc = w1t + static_cast<size_t>(c) * df;
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < df; d += 8) {   // Df is a multiple of 32
    float xv[8], wv[8];
    tf32x3::load8(xr + d, xv);
    tf32x3::load8(wc + d, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(xv[i], wv[i], s);
  }
  return s + b1[c];
}

// The tile's product; each pre-activation within kMaskTol |x_row| |W1_col|
// of 0 is listed for gated_h_fix_kernel in near[tile] (or, past kMaxNear,
// recomputed here). With kDp, the tile then adds its panel's part of
// d_p = H d_bag^T (B2's K1).
template <typename T, bool kDp>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
gated_h_kernel(const T* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ w1t, const float* __restrict__ b1,
               const float* __restrict__ norms, const float* __restrict__ dbag,
               float* __restrict__ h, int2* __restrict__ near,
               int* __restrict__ near_counts, float* __restrict__ dp_part,
               int m, int n, int df, int l_dim, int k_br) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int count;
  using G = GemmH<T>;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int2* listed = near + static_cast<size_t>(tile) * kMaxNear;
  if (threadIdx.x == 0) count = 0;
  float acc[G::kMT][G::kNT][4];
  G::zero(acc);
  G::run(acc, {x, df, m, df}, {w1, l_dim, l_dim, df}, m0, n0, 0, df, smem);
  const float* xn = norms;
  const float* wn = norms + m;
  G::for_pairs(acc, m0, n0, [&](int r, int c, float v0, float v1) {
    if (r >= m) return;
    float v[2] = {v0 + b1[c], v1 + b1[c + 1]};
    const float tol = kMaskTol * xn[r];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (fabsf(v[e]) < tol * wn[c + e]) {
        const int j = atomicAdd(&count, 1);
        if (j < kMaxNear) listed[j] = make_int2(r, c + e);
        else v[e] = forward_preact(x, w1t, b1, r, c + e, df);
      }
    }
    store2(h + static_cast<size_t>(r) * l_dim + c, fmaxf(v[0], 0.f),
           fmaxf(v[1], 0.f));
  });
  __syncthreads();  // the tile of H is stored
  if (threadIdx.x == 0) near_counts[tile] = min(count, kMaxNear);
  if constexpr (kDp) {
    // ---- this panel's part of d_p = H d_bag^T, two threads a row. The
    // listed elements still hold this product's values, which differ from
    // the forward's by less than the recompute tolerance: d_p is continuous
    // in h
    const int r = min(m0 + static_cast<int>(threadIdx.x) / 2, m - 1);
    const int c0 = n0 + (threadIdx.x % 2) * (kBN / 2);
    float hv[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(h + static_cast<size_t>(r) * l_dim + c0 + i);
      hv[i] = v.x; hv[i + 1] = v.y; hv[i + 2] = v.z; hv[i + 3] = v.w;
    }
    const float* db = dbag + static_cast<size_t>(r / n) * k_br * l_dim + c0;
    for (int kb = 0; kb < k_br; ++kb) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 4)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s4[j] = fmaf(hv[i + j], __ldg(db + kb * l_dim + i + j), s4[j]);
      float sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (threadIdx.x % 2 == 0 && m0 + static_cast<int>(threadIdx.x) / 2 < m)
        dp_part[(static_cast<size_t>(blockIdx.y) * m + r) * k_br + kb] = sum;
    }
  }
}

// ---- the listed elements in the forward's order: one warp a tile, one lane
// an element ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(32)
gated_h_fix_kernel(const T* __restrict__ x, const float* __restrict__ w1t,
                   const float* __restrict__ b1, const int2* __restrict__ near,
                   const int* __restrict__ near_counts, float* __restrict__ h,
                   int df, int l_dim) {
  const int2* listed = near + static_cast<size_t>(blockIdx.x) * kMaxNear;
  for (int j = threadIdx.x; j < near_counts[blockIdx.x]; j += 32) {
    const int2 rc = listed[j];
    h[static_cast<size_t>(rc.x) * l_dim + rc.y] =
        fmaxf(forward_preact(x, w1t, b1, rc.x, rc.y, df), 0.f);
  }
}

// Launches the H stage on `stream`: norms (M + L floats), h (M x L floats),
// near (T x kMaxNear int2) and near_counts (T ints), T = ceil(M / 128) L /
// 128, are the caller's; with kDp, dbag [B, K, L] is read and dp_part
// (L / 128 x M x K floats) written, n being the rows of one bag.
template <typename T, bool kDp>
cudaError_t launch_h_stage(const T* x, const float* w1, const float* w1t,
                           const float* b1, float* norms, const float* dbag,
                           float* h, int2* near, int* near_counts,
                           float* dp_part, int m, int n, int df, int l_dim,
                           int k_br, cudaStream_t stream) {
  const int norm_rows = (m + kNormRows - 1) / kNormRows;
  gated_h_norms_kernel<T><<<norm_rows + l_dim / 32, kThreads, 0, stream>>>(
      x, w1, norms, m, df, l_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static SmemLimit limit;
  err = raise_smem(gated_h_kernel<T, kDp>, GemmH<T>::kSmemBytes, limit);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kBM - 1) / kBM, l_dim / kBN);
  gated_h_kernel<T, kDp><<<grid, kThreads, GemmH<T>::kSmemBytes, stream>>>(
      x, w1, w1t, b1, norms, dbag, h, near, near_counts, dp_part, m, n, df,
      l_dim, k_br);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gated_h_fix_kernel<T><<<grid.x * grid.y, 32, 0, stream>>>(
      x, w1t, b1, near, near_counts, h, df, l_dim);
  return cudaGetLastError();
}

}  // namespace gated_h
}  // namespace
