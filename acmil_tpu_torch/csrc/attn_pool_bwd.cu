// Kernel B2: fused gated-attention pooling, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acmil_tpu/ops/attn_pool.py::_bwd_kernel,
// which _fused_pool_bwd_stats launches. Given the forward's inputs, the
// per-(bag, branch) softmax couplings lse [B, K] and c = sum_l d_bag * bag
// [B, K], and the cotangents d_bag [B, K, L] and d_logits [B, K, N], one pass
// over x computes, for every row:
//
//   h = relu(x W1 + b1), gv = tanh(h V + bv), gu = sigmoid(h U + bu), g = gv gu
//   p     = exp(g w + bw - lse)                 (0 at masked rows and past N)
//   d_log = p (h d_bag^T - c) + d_logits        (0 at masked rows and past N)
//   d_av  = (d_log w^T) gu (1 - gv^2),  d_au = (d_log w^T) gv gu (1 - gu)
//   r     = [h > 0] (p d_bag + d_av V^T + d_au U^T)
//   dx    = r W1^T                              (only when asked)
//
// and the weight gradients summed over all rows of all bags:
// dW1 = x^T r, db1 = sum r, dV = h^T d_av, dbv = sum d_av, dU = h^T d_au,
// dbu = sum d_au, dw = g^T d_log, dbw = sum d_log.
//
// Design. The TPU kernel walks every (bag, chunk) in order on one core and
// carries eight gradient accumulators in VMEM from step to step. On the H100
// blocks run in parallel and nothing carries over, and dW1 alone is
// Df x L x 4 = 192 KB at Df = 384, L = 128: it does not fit one block's
// shared memory beside the tiles. So the rows are cut into tiles (64 rows at
// L = 128, 32 above), and G blocks walk them with a stride of G. Each block
// accumulates its tiles' gradients into a private slice of a workspace in
// global memory (about 332 KB at Df = 384, L = 128, K = 5; 4.7 MB at
// Df = 1536, L = 768): the first tile stores, later tiles add. A second
// kernel then sums the G slices in a fixed order. No float atomics are used,
// so two launches on the same inputs give the same bits, at every width. G
// is the number of blocks the card holds at once (132 SMs x 1 block of 256
// threads = 132 on an H100 SXM), so every block stays resident; at L = 128
// the workspace (about 44 MB) mostly stays in the 50 MB L2 cache, at the
// larger widths it does not.
//
// Like the TPU kernel, B2 recomputes h, the gates and the logits of its tile
// from x and the weights and writes no [N, L] intermediate to device memory.
// Shared memory holds h (later r), g (later d_av), d_au, p and d_log for the
// tile, and a staging area through which x, W1, V and U pass 8 to 32 rows or
// columns at a time (fewer at L = 768, where h alone is 96 KB): 134 KB per
// block at L = 128, K = 5, at most 211 KB (L = 768, K = 128), one block per
// SM.
//
// Bounds. At Df = 384, L = A = 128 a 65536-row bag costs about 25 GFLOP of
// f32 FMA without dx (32 GFLOP with it), about three times the forward, and
// reads 50 MB of fp16 features (plus 50 MB of dx writes when asked). On the
// CUDA cores (67 TFLOP/s f32 peak) that is compute-bound. Register tiles of
// rows x columns per thread (8 x 4 at L = 128, 4 x L/32 above, 16 x 4 for
// dV and dU per panel of 128 columns), fed from shared memory with
// broadcast and 16-byte loads, carry the products; mma/wgmma on the tensor
// cores and TMA are later work.
//
// Features are read as fp16 or f32 and widened in registers; dx is written in
// the features' dtype; every weight gradient is f32. Widths taken: L in {128,
// 256, 384, 512, 768} (one instantiation each), A = 128, Df a multiple of 32,
// 1 <= K <= 128. The Python wrapper (acmil_tpu_torch/ops/attn_pool.py) checks
// them and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 128;            // gated-attention hidden width
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 128;        // columns of h per dV/dU/dW1 pass
constexpr int kVDepth = 32;        // rows of V/U per staged slice
constexpr int kReduceThreads = 256;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The per-width layout of the partial kernel.
template <int L>
struct Shape {
  static constexpr int kTile = L == 128 ? 64 : 32;   // rows of x per tile
  static constexpr int kRows = kTile / kWarps;       // rows a thread owns
  static constexpr int kCols = L / 32;               // columns of h a thread owns
  static constexpr int kDepth = L == 768 ? 16 : 32;  // x/W1 depth for h
  static constexpr int kTDepth = L == 768 ? 8 : 16;  // columns of V/U transposed
  static constexpr int kTStride = L + 1;             // row stride of V^T/U^T slices
  static constexpr int kD2 = L == 768 ? 16 : 32;     // columns of x for dW1/dx
  static constexpr int kW1Stride = L + 4;            // staged W1 rows (16 B aligned)
  // floats in the staging area; 8192 at L = 128 as before
  static constexpr int kStage = cmax(
      cmax(cmax(kTile * kDepth + kDepth * L, 2 * kVDepth * kA),
           2 * kTDepth * kTStride),
      kTile * kD2 + kD2 * kW1Stride);
  static_assert(L % kPanel == 0 && kTile * 4 <= kThreads * 4, "widths");
  static_assert(kThreads == 2 * kA, "thread mappings");
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// N consecutive floats of shared memory (16-byte loads where N = 4).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ void store_dx(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_dx(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The block's private gradient slice: the first tile stores, later ones add.
__device__ __forceinline__ void accumulate(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

__device__ __forceinline__ bool row_valid(const uint8_t* mask_b, int row,
                                          int n) {
  return row < n && mask_b[row] != 0;
}

// Copies `rows` rows of a [*, W] row-major f32 matrix into shared memory.
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * W / 4; q += kThreads) d[q] = s[q];
}

// Stages columns kc..kc+D-1 of the tile's kTile rows of x as f32
// [kTile][D]; rows past N read as 0.
template <int kTile, int D, typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* xb, int n0, int n,
                                        int df, int kc) {
  if (threadIdx.x >= kTile * (D / 8)) return;
  const int r = threadIdx.x / (D / 8);  // rows x segments of 8 columns
  const int c = (threadIdx.x % (D / 8)) * 8;
  float vals[8];
  if (n0 + r < n) {
    load8(xb + static_cast<size_t>(n0 + r) * df + kc + c, vals);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) vals[i] = 0.f;
  }
  float4* dst = reinterpret_cast<float4*>(xs + r * D + c);
  dst[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
  dst[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
}

template <int L>
size_t partial_smem_bytes(int k_br) {
  using S = Shape<L>;
  return sizeof(float) * (static_cast<size_t>(S::kTile) * L +
                          2 * S::kTile * kA + S::kStage + 2 * k_br * S::kTile);
}

__host__ __device__ size_t slice_floats(int df, int l_dim, int k_br) {
  return static_cast<size_t>(df) * l_dim + l_dim + 2 * (l_dim * kA + kA) +
         kA * k_br + k_br;
}

// Block g walks tiles g, g + G, ... over all bags and accumulates their
// gradients into work[g], a slice laid out as
// [dW1 (Df x L) | db1 (L) | dV (L x A) | dbv (A) | dU (L x A) | dbu (A) |
//  dw (A x K) | dbw (K)].
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 1)
pool_bwd_partial_kernel(const T* __restrict__ feats,       // [B, N, Df]
                        const uint8_t* __restrict__ mask,  // [B, N]
                        const float* __restrict__ w1,      // [Df, L]
                        const float* __restrict__ b1,      // [L]
                        const float* __restrict__ v,       // [L, A]
                        const float* __restrict__ bv,      // [A]
                        const float* __restrict__ u,       // [L, A]
                        const float* __restrict__ bu,      // [A]
                        const float* __restrict__ w,       // [A, K]
                        const float* __restrict__ bw,      // [K]
                        const float* __restrict__ lse,     // [B, K]
                        const float* __restrict__ cc,      // [B, K]
                        const float* __restrict__ dbag,    // [B, K, L]
                        const float* __restrict__ dlo,     // [B, K, N]
                        T* __restrict__ dx,                // [B, N, Df] or null
                        float* __restrict__ work,          // [G, slice]
                        int batch, int n, int df, int k_br) {
  using S = Shape<L>;
  constexpr int kTile = S::kTile, kRows = S::kRows, kCols = S::kCols;
  constexpr int kDepth = S::kDepth, kTDepth = S::kTDepth, kD2 = S::kD2;
  constexpr int kTStride = S::kTStride, kW1Stride = S::kW1Stride;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                    // [kTile][L]: h, then r
  float* r1 = hs + kTile * L;          // [kTile][kA]: g, then d_av
  float* r2 = r1 + kTile * kA;         // [kTile][kA]: d_au
  float* stage = r2 + kTile * kA;      // S::kStage floats
  float* ps = stage + S::kStage;       // [K][kTile]: p
  float* dls = ps + k_br * kTile;      // [K][kTile]: d_log

  const int tid = threadIdx.x;
  const int tx = tid & 31;             // lane
  const int ty = tid >> 5;             // warp
  const int tiles_per_bag = (n + kTile - 1) / kTile;
  const int total = batch * tiles_per_bag;

  float* g_dw1 = work + blockIdx.x * slice_floats(df, L, k_br);
  float* g_db1 = g_dw1 + static_cast<size_t>(df) * L;
  float* g_dv = g_db1 + L;
  float* g_dbv = g_dv + L * kA;
  float* g_du = g_dbv + kA;
  float* g_dbu = g_du + L * kA;
  float* g_dw = g_dbu + kA;
  float* g_dbw = g_dw + kA * k_br;

  bool first = true;
  for (int t = blockIdx.x; t < total; t += gridDim.x, first = false) {
    const int b = t / tiles_per_bag;
    const int n0 = (t - b * tiles_per_bag) * kTile;
    const T* xb = feats + static_cast<size_t>(b) * n * df;
    const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
    const float* lse_b = lse + static_cast<size_t>(b) * k_br;
    const float* cc_b = cc + static_cast<size_t>(b) * k_br;
    const float* dbag_b = dbag + static_cast<size_t>(b) * k_br * L;
    const float* dlo_b = dlo + static_cast<size_t>(b) * k_br * n;

    // ---- h = relu(x W1 + b1); thread tile rows kRows ty.., columns tx + 32j
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    {
      float* xs = stage;                   // [kTile][kDepth]
      float* ws = stage + kTile * kDepth;  // [kDepth][L]
      for (int kc = 0; kc < df; kc += kDepth) {
        __syncthreads();  // the previous slice (or tile) has been read
        stage_x<kTile, kDepth>(xs, xb, n0, n, df, kc);
        copy_rows<L>(ws, w1 + static_cast<size_t>(kc) * L, kDepth);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          float a[kRows], bb[kCols];
#pragma unroll
          for (int i = 0; i < kRows; ++i) a[i] = xs[(ty * kRows + i) * kDepth + kk];
#pragma unroll
          for (int j = 0; j < kCols; ++j) bb[j] = ws[kk * L + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 32 * j;
      const float bias = b1[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        hs[(ty * kRows + i) * L + c] = fmaxf(acc[i][j] + bias, 0.f);
    }

    // ---- gv = tanh(h V + bv), gu = sigmoid(h U + bu), kept in registers ---
    float gv[kRows][4], gu[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[i][j] = 0.f;
        gu[i][j] = 0.f;
      }
    {
      float* vs = stage;                   // [kVDepth][kA]
      float* us = stage + kVDepth * kA;    // [kVDepth][kA]
      for (int lc = 0; lc < L; lc += kVDepth) {
        __syncthreads();  // h is written; the previous slice has been read
        copy_rows<kA>(vs, v + static_cast<size_t>(lc) * kA, kVDepth);
        copy_rows<kA>(us, u + static_cast<size_t>(lc) * kA, kVDepth);
        __syncthreads();
#pragma unroll 4
        for (int ll = 0; ll < kVDepth; ++ll) {
          float hv[kRows], bvv[4], buu[4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) hv[i] = hs[(ty * kRows + i) * L + lc + ll];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bvv[j] = vs[ll * kA + tx + 32 * j];
            buu[j] = us[ll * kA + tx + 32 * j];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              gv[i][j] = fmaf(hv[i], bvv[j], gv[i][j]);
              gu[i][j] = fmaf(hv[i], buu[j], gu[i][j]);
            }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 32 * j;
      const float bias_v = bv[c];
      const float bias_u = bu[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        gv[i][j] = tanhf(gv[i][j] + bias_v);
        gu[i][j] = 1.f / (1.f + expf(-(gu[i][j] + bias_u)));
        r1[(ty * kRows + i) * kA + c] = gv[i][j] * gu[i][j];
      }
    }
    __syncthreads();

    // ---- p and d_log per (row, branch): one warp per row ------------------
    for (int row = ty; row < kTile; row += kWarps) {
      const int grow = n0 + row;
      const bool valid = row_valid(mask_b, grow, n);
      float gq[4], hq[kCols];
#pragma unroll
      for (int q = 0; q < 4; ++q) gq[q] = r1[row * kA + tx + 32 * q];
#pragma unroll
      for (int q = 0; q < kCols; ++q) hq[q] = hs[row * L + tx + 32 * q];
      for (int kb = 0; kb < k_br; ++kb) {
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dot = fmaf(gq[q], __ldg(w + (tx + 32 * q) * k_br + kb), dot);
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          dp = fmaf(hq[q], __ldg(dbag_b + kb * L + tx + 32 * q), dp);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
          dp += __shfl_xor_sync(0xffffffffu, dp, off);
        }
        if (tx == 0) {
          float p = 0.f, dl = 0.f;
          if (valid) {  // a select: masked rows ignore their d_logits
            p = expf(dot + bw[kb] - lse_b[kb]);
            dl = fmaf(p, dp - cc_b[kb], dlo_b[static_cast<size_t>(kb) * n + grow]);
          }
          ps[kb * kTile + row] = p;
          dls[kb * kTile + row] = dl;
        }
      }
    }
    __syncthreads();

    // ---- dw = g^T d_log, dbw = sum d_log ----------------------------------
    for (int idx = tid; idx < kA * k_br; idx += kThreads) {
      const int a = idx % kA;
      const int kb = idx / kA;
      float s = 0.f;
#pragma unroll 8
      for (int row = 0; row < kTile; ++row)
        s = fmaf(r1[row * kA + a], dls[kb * kTile + row], s);
      accumulate(g_dw + a * k_br + kb, s, first);
    }
    for (int kb = tid; kb < k_br; kb += kThreads) {
      float s = 0.f;
      for (int row = 0; row < kTile; ++row) s += dls[kb * kTile + row];
      accumulate(g_dbw + kb, s, first);
    }

    // ---- d_g = d_log w^T, then d_av and d_au in place of gv and gu --------
    {
      float dg[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dg[i][j] = 0.f;
      for (int kb = 0; kb < k_br; ++kb) {
        float dl8[kRows], wv[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dl8[i] = dls[kb * kTile + ty * kRows + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = __ldg(w + (tx + 32 * j) * k_br + kb);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dg[i][j] = fmaf(dl8[i], wv[j], dg[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tv = gv[i][j], su = gu[i][j];
          gv[i][j] = dg[i][j] * su * (1.f - tv * tv);   // d_av
          gu[i][j] = dg[i][j] * tv * su * (1.f - su);   // d_au
        }
    }
    __syncthreads();  // g has been read
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        r1[(ty * kRows + i) * kA + tx + 32 * j] = gv[i][j];
        r2[(ty * kRows + i) * kA + tx + 32 * j] = gu[i][j];
      }
    __syncthreads();

    // ---- dV = h^T d_av, dU = h^T d_au: thread tile l 16ty.., a 4tx.. per
    // panel of 128 rows of dV/dU ---------------------------------------------
#pragma unroll 1
    for (int lp = 0; lp < L; lp += kPanel) {
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        const float* src = which ? r2 : r1;
        float* dst = (which ? g_du : g_dv) + lp * kA;
        float ad[16][4];
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) ad[i][q] = 0.f;
#pragma unroll 2
        for (int row = 0; row < kTile; ++row) {
          float hv[16];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float4 h4 = *reinterpret_cast<const float4*>(
                hs + row * L + lp + ty * 16 + 4 * m);
            hv[4 * m] = h4.x; hv[4 * m + 1] = h4.y;
            hv[4 * m + 2] = h4.z; hv[4 * m + 3] = h4.w;
          }
          const float4 d4 =
              *reinterpret_cast<const float4*>(src + row * kA + tx * 4);
          const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) ad[i][q] = fmaf(hv[i], dv4[q], ad[i][q]);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accumulate(dst + (ty * 16 + i) * kA + tx * 4 + q, ad[i][q], first);
      }
    }
    {
      const float* src = tid < kA ? r1 : r2;
      const int a = tid % kA;
      float s = 0.f;
      for (int row = 0; row < kTile; ++row) s += src[row * kA + a];
      accumulate((tid < kA ? g_dbv : g_dbu) + a, s, first);
    }

    // ---- d_h = p d_bag + d_av V^T + d_au U^T, r = [h > 0] d_h -------------
    {
      float dh[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dh[i][j] = 0.f;
      for (int kb = 0; kb < k_br; ++kb) {
        float p8[kRows], db4[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) p8[i] = ps[kb * kTile + ty * kRows + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) db4[j] = __ldg(dbag_b + kb * L + tx + 32 * j);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) dh[i][j] = fmaf(p8[i], db4[j], dh[i][j]);
      }
      float* vt = stage;                       // [kTDepth][kTStride]: V^T
      float* ut = stage + kTDepth * kTStride;  // [kTDepth][kTStride]: U^T
      for (int a0 = 0; a0 < kA; a0 += kTDepth) {
        __syncthreads();  // dV/dU are done with h; the last slice is read
        for (int q = tid; q < L * kTDepth; q += kThreads) {
          const int l = q / kTDepth;
          const int aa = q % kTDepth;
          vt[aa * kTStride + l] = __ldg(v + l * kA + a0 + aa);
          ut[aa * kTStride + l] = __ldg(u + l * kA + a0 + aa);
        }
        __syncthreads();
#pragma unroll 4
        for (int aa = 0; aa < kTDepth; ++aa) {
          float dv8[kRows], du8[kRows], vv[kCols], uu[kCols];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv8[i] = r1[(ty * kRows + i) * kA + a0 + aa];
            du8[i] = r2[(ty * kRows + i) * kA + a0 + aa];
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            vv[j] = vt[aa * kTStride + tx + 32 * j];
            uu[j] = ut[aa * kTStride + tx + 32 * j];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              dh[i][j] = fmaf(dv8[i], vv[j], fmaf(du8[i], uu[j], dh[i][j]));
        }
      }
      // each thread overwrites only the h entries it reads
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float* hp = hs + (ty * kRows + i) * L + tx + 32 * j;
          *hp = *hp > 0.f ? dh[i][j] : 0.f;
        }
    }
    __syncthreads();
    for (int l = tid; l < L; l += kThreads) {
      float s = 0.f;
      for (int row = 0; row < kTile; ++row) s += hs[row * L + l];
      accumulate(g_db1 + l, s, first);
    }

    // ---- dW1 = x^T r and dx = r W1^T, kD2 columns of x at a time ----------
    constexpr int kWRows = kD2 / kWarps;       // dW1 rows a thread owns
    constexpr int kLaneGroups = 32 / kD2;      // lane groups sharing dx rows
    constexpr int kDxRows = kRows / kLaneGroups;
    float* xs = stage;                         // [kTile][kD2]
    float* w1s = stage + kTile * kD2;          // [kD2][kW1Stride]: W1 rows
    for (int kc = 0; kc < df; kc += kD2) {
      __syncthreads();  // the previous slice has been read
      stage_x<kTile, kD2>(xs, xb, n0, n, df, kc);
      for (int q = tid; q < kD2 * L / 4; q += kThreads) {
        const int dd = q / (L / 4);
        const int l4 = (q % (L / 4)) * 4;
        *reinterpret_cast<float4*>(w1s + dd * kW1Stride + l4) =
            __ldg(reinterpret_cast<const float4*>(
                w1 + static_cast<size_t>(kc + dd) * L + l4));
      }
      __syncthreads();
      // dW1 rows kc + kWRows ty.., columns lp + 4tx..
#pragma unroll 1
      for (int lp = 0; lp < L; lp += kPanel) {
        float aw[kWRows][4];
#pragma unroll
        for (int i = 0; i < kWRows; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) aw[i][q] = 0.f;
#pragma unroll 4
        for (int row = 0; row < kTile; ++row) {
          float xa[kWRows];
          load_row<kWRows>(xs + row * kD2 + ty * kWRows, xa);
          const float4 r4 =
              *reinterpret_cast<const float4*>(hs + row * L + lp + tx * 4);
          const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int i = 0; i < kWRows; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) aw[i][q] = fmaf(xa[i], ra[q], aw[i][q]);
        }
#pragma unroll
        for (int i = 0; i < kWRows; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accumulate(g_dw1 + static_cast<size_t>(kc + ty * kWRows + i) * L +
                           lp + tx * 4 + q,
                       aw[i][q], first);
      }
      // dx rows kRows ty + kDxRows (lane group).., column kc + lane % kD2
      if (dx != nullptr) {
        const int cx = tx % kD2;
        const int r0 = ty * kRows + (tx / kD2) * kDxRows;
        float ax[kDxRows];
#pragma unroll
        for (int i = 0; i < kDxRows; ++i) ax[i] = 0.f;
#pragma unroll 4
        for (int l = 0; l < L; l += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w1s + cx * kW1Stride + l);
#pragma unroll
          for (int i = 0; i < kDxRows; ++i) {
            const float4 r4 =
                *reinterpret_cast<const float4*>(hs + (r0 + i) * L + l);
            ax[i] = fmaf(r4.x, w4.x, fmaf(r4.y, w4.y,
                    fmaf(r4.z, w4.z, fmaf(r4.w, w4.w, ax[i]))));
          }
        }
#pragma unroll
        for (int i = 0; i < kDxRows; ++i) {
          const int row = n0 + r0 + i;
          if (row < n)
            store_dx(dx + (static_cast<size_t>(b) * n + row) * df + kc + cx, ax[i]);
        }
      }
    }
  }
}

// out[i] = sum over g = 0..G-1 of work[g][i], in that order.
__global__ void __launch_bounds__(kReduceThreads)
grad_reduce_kernel(const float* __restrict__ work, float* __restrict__ out,
                   int groups, int slice) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= slice) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g)
    s += work[static_cast<size_t>(g) * slice + i];
  out[i] = s;
}

template <typename T, int L>
cudaError_t set_smem(int k_br) {
  return cudaFuncSetAttribute(pool_bwd_partial_kernel<T, L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(partial_smem_bytes<L>(k_br)));
}

// Blocks of the partial kernel the current device holds at once, or minus
// a cudaError_t.
template <typename T, int L>
int max_blocks(int k_br) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem<T, L>(k_br);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pool_bwd_partial_kernel<T, L>, kThreads,
        partial_smem_bytes<L>(k_br));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

template <typename T, int L>
cudaError_t launch(const void* feats, const uint8_t* mask, const float* w1,
                   const float* b1, const float* v, const float* bv,
                   const float* u, const float* bu, const float* w,
                   const float* bw, const float* lse, const float* cc,
                   const float* dbag, const float* dlo, void* dx, float* work,
                   float* grads, int batch, int n, int df, int k_br,
                   int groups, cudaStream_t stream) {
  cudaError_t err = set_smem<T, L>(k_br);
  if (err != cudaSuccess) return err;
  pool_bwd_partial_kernel<T, L><<<groups, kThreads,
                                  partial_smem_bytes<L>(k_br), stream>>>(
      static_cast<const T*>(feats), mask, w1, b1, v, bv, u, bu, w, bw, lse,
      cc, dbag, dlo, static_cast<T*>(dx), work, batch, n, df, k_br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slice = static_cast<int>(slice_floats(df, L, k_br));
  grad_reduce_kernel<<<(slice + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, stream>>>(work, grads, groups, slice);
  return cudaGetLastError();
}

// F(L) for the widths the kernel is instantiated at, else `otherwise`.
#define B2_WIDTHS(F, otherwise) \
  switch (l_dim) {              \
    case 128: return F(128);    \
    case 256: return F(256);    \
    case 384: return F(384);    \
    case 512: return F(512);    \
    case 768: return F(768);    \
    default: return otherwise;  \
  }

template <typename T>
int max_blocks_width(int l_dim, int k_br) {
#define B2_BLOCKS(LL) max_blocks<T, LL>(k_br)
  B2_WIDTHS(B2_BLOCKS, -static_cast<int>(cudaErrorInvalidValue))
#undef B2_BLOCKS
}

template <typename T>
cudaError_t launch_width(int l_dim, const void* feats, const uint8_t* mask,
                         const float* w1, const float* b1, const float* v,
                         const float* bv, const float* u, const float* bu,
                         const float* w, const float* bw, const float* lse,
                         const float* cc, const float* dbag, const float* dlo,
                         void* dx, float* work, float* grads, int batch, int n,
                         int df, int k_br, int groups, cudaStream_t stream) {
#define B2_LAUNCH(LL)                                                        \
  launch<T, LL>(feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, cc, dbag, dlo, \
                dx, work, grads, batch, n, df, k_br, groups, stream)
  B2_WIDTHS(B2_LAUNCH, cudaErrorInvalidValue)
#undef B2_LAUNCH
}

}  // namespace

extern "C" {

// Rows of x per tile at this L (0 for an L the kernel does not take).
int b2_tile_rows(int l_dim) {
#define B2_TILE(LL) Shape<LL>::kTile
  B2_WIDTHS(B2_TILE, 0)
#undef B2_TILE
}

// The most blocks (G) a launch should use on the current device for this K,
// L and feature dtype, or minus a cudaError_t. The caller sizes the
// workspace as G x slice floats, slice = Df*L + L + 2*(L*A + A) + A*K + K,
// and passes G = min(this, number of tiles).
int b2_max_blocks(int k_br, int feats_half, int l_dim) {
  return feats_half ? max_blocks_width<__half>(l_dim, k_br)
                    : max_blocks_width<float>(l_dim, k_br);
}

// Launches kernel B2 on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers; `feats_half` selects fp16 (1) or f32
// (0) features (and dx). dx may be null (no input gradient). `grads`
// receives the summed gradients in the workspace slice's layout. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for an L the kernel
// does not take).
int b2_attn_pool_backward(const void* feats, int feats_half, const void* mask,
                          const float* w1, const float* b1, const float* v,
                          const float* bv, const float* u, const float* bu,
                          const float* w, const float* bw, const float* lse,
                          const float* cc, const float* dbag, const float* dlo,
                          void* dx, float* work, float* grads, int batch,
                          int n, int df, int k_br, int l_dim, int groups,
                          void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_half)
    return static_cast<int>(launch_width<__half>(
        l_dim, feats, m, w1, b1, v, bv, u, bu, w, bw, lse, cc, dbag, dlo, dx,
        work, grads, batch, n, df, k_br, groups, st));
  return static_cast<int>(launch_width<float>(
      l_dim, feats, m, w1, b1, v, bv, u, bu, w, bw, lse, cc, dbag, dlo, dx,
      work, grads, batch, n, df, k_br, groups, st));
}

}  // extern "C"
