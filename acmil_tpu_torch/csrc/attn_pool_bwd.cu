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
// Df x L x 4 = 192 KB at Df = 384: it does not fit one block's shared memory
// beside the tiles. So the rows are cut into 64-row tiles, and G blocks walk
// them with a stride of G. Each block accumulates its tiles' gradients into a
// private slice of a workspace in global memory (about 332 KB at Df = 384,
// K = 5): the first tile stores, later tiles add. A second kernel then sums
// the G slices in a fixed order. No float atomics are used, so two launches
// on the same inputs give the same bits. G is the number of blocks the card
// holds at once (132 SMs x 1 block of 256 threads = 132 on an H100 SXM), so
// every block stays resident, and the workspace (about 44 MB) mostly stays
// in the 50 MB L2 cache.
//
// Like the TPU kernel, B2 recomputes h, the gates and the logits of its tile
// from x and the weights and writes no [N, L] intermediate to device memory.
// Shared memory holds h (later r), g (later d_av), d_au, p and d_log for the
// tile, and a staging area through which x, W1, V and U pass 16 or 32 rows or
// columns at a time: 134 KB per block at K = 5, one block per SM.
//
// Bounds. At Df = 384, L = A = 128 a 65536-row bag costs about 25 GFLOP of
// f32 FMA without dx (32 GFLOP with it), about three times the forward, and
// reads 50 MB of fp16 features (plus 50 MB of dx writes when asked). On the
// CUDA cores (67 TFLOP/s f32 peak) that is compute-bound. Register tiles of
// 8 x 4 or 16 x 4 per thread, fed from shared memory with broadcast and
// 16-byte loads, carry the products; mma/wgmma on the tensor cores and TMA
// are later work.
//
// Features are read as fp16 or f32 and widened in registers; dx is written in
// the features' dtype; every weight gradient is f32. Widths taken: L = A =
// 128, Df a multiple of 32, 1 <= K <= 128. The Python wrapper
// (acmil_tpu_torch/ops/attn_pool.py) checks them and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of x per tile
constexpr int kL = 128;            // DimReduction width: columns of h
constexpr int kA = 128;            // gated-attention hidden width
constexpr int kDepth = 32;         // reduction depth staged per step
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 8192;       // floats in the staging area
constexpr int kTDepth = 16;        // columns of V/U per transposed slice
constexpr int kTStride = kL + 1;   // row stride of a transposed V/U slice
constexpr int kW1Stride = kL + 4;  // row stride of staged W1 rows (16 B aligned)
constexpr int kReduceThreads = 256;

static_assert(kTile * kDepth + kDepth * kL <= kStage, "x/W1 slices");
static_assert(2 * kDepth * kA <= kStage, "V/U slices");
static_assert(2 * kTDepth * kTStride <= kStage, "transposed V/U slices");
static_assert(kTile * kDepth + kDepth * kW1Stride <= kStage, "x slice, W1 rows");
static_assert(kThreads == 2 * kA && kThreads == 4 * kTile, "thread mappings");

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

// Copies `rows` rows of a [*, 128] row-major f32 matrix into shared memory.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * kL / 4; q += kThreads) d[q] = s[q];
}

// Stages columns kc..kc+31 of the tile's 64 rows of x as f32 [64][32];
// rows past N read as 0.
template <typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* xb, int n0, int n,
                                        int df, int kc) {
  const int r = threadIdx.x >> 2;      // 64 rows x 4 segments of 8 columns
  const int c = (threadIdx.x & 3) * 8;
  float vals[8];
  if (n0 + r < n) {
    load8(xb + static_cast<size_t>(n0 + r) * df + kc + c, vals);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) vals[i] = 0.f;
  }
  float4* dst = reinterpret_cast<float4*>(xs + r * kDepth + c);
  dst[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
  dst[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
}

size_t partial_smem_bytes(int k_br) {
  return sizeof(float) *
         (static_cast<size_t>(3) * kTile * kL + kStage + 2 * k_br * kTile);
}

// Block g walks tiles g, g + G, ... over all bags and accumulates their
// gradients into work[g], a slice laid out as
// [dW1 (Df x L) | db1 (L) | dV (L x A) | dbv (A) | dU (L x A) | dbu (A) |
//  dw (A x K) | dbw (K)].
template <typename T>
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
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                    // [kTile][kL]: h, then r
  float* r1 = hs + kTile * kL;         // [kTile][kA]: g, then d_av
  float* r2 = r1 + kTile * kA;         // [kTile][kA]: d_au
  float* stage = r2 + kTile * kA;      // kStage floats
  float* ps = stage + kStage;          // [K][kTile]: p
  float* dls = ps + k_br * kTile;      // [K][kTile]: d_log

  const int tid = threadIdx.x;
  const int tx = tid & 31;             // lane
  const int ty = tid >> 5;             // warp
  const int tiles_per_bag = (n + kTile - 1) / kTile;
  const int total = batch * tiles_per_bag;

  const size_t slice = static_cast<size_t>(df) * kL + kL + 2 * (kL * kA + kA) +
                       kA * k_br + k_br;
  float* g_dw1 = work + blockIdx.x * slice;
  float* g_db1 = g_dw1 + static_cast<size_t>(df) * kL;
  float* g_dv = g_db1 + kL;
  float* g_dbv = g_dv + kL * kA;
  float* g_du = g_dbv + kA;
  float* g_dbu = g_du + kL * kA;
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
    const float* dbag_b = dbag + static_cast<size_t>(b) * k_br * kL;
    const float* dlo_b = dlo + static_cast<size_t>(b) * k_br * n;

    // ---- h = relu(x W1 + b1); thread tile rows 8ty.., columns tx + 32j ----
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    {
      float* xs = stage;                   // [kTile][kDepth]
      float* ws = stage + kTile * kDepth;  // [kDepth][kL]
      for (int kc = 0; kc < df; kc += kDepth) {
        __syncthreads();  // the previous slice (or tile) has been read
        stage_x(xs, xb, n0, n, df, kc);
        copy_rows(ws, w1 + static_cast<size_t>(kc) * kL, kDepth);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          float a[8], bb[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = xs[(ty * 8 + i) * kDepth + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = ws[kk * kL + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 32 * j;
      const float bias = b1[c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        hs[(ty * 8 + i) * kL + c] = fmaxf(acc[i][j] + bias, 0.f);
    }

    // ---- gv = tanh(h V + bv), gu = sigmoid(h U + bu), kept in registers ---
    float gv[8][4], gu[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[i][j] = 0.f;
        gu[i][j] = 0.f;
      }
    {
      float* vs = stage;                   // [kDepth][kA]
      float* us = stage + kDepth * kA;     // [kDepth][kA]
      for (int lc = 0; lc < kL; lc += kDepth) {
        __syncthreads();  // h is written; the previous slice has been read
        copy_rows(vs, v + static_cast<size_t>(lc) * kA, kDepth);
        copy_rows(us, u + static_cast<size_t>(lc) * kA, kDepth);
        __syncthreads();
#pragma unroll 4
        for (int ll = 0; ll < kDepth; ++ll) {
          float hv[8], bvv[4], buu[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) hv[i] = hs[(ty * 8 + i) * kL + lc + ll];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bvv[j] = vs[ll * kA + tx + 32 * j];
            buu[j] = us[ll * kA + tx + 32 * j];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
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
      for (int i = 0; i < 8; ++i) {
        gv[i][j] = tanhf(gv[i][j] + bias_v);
        gu[i][j] = 1.f / (1.f + expf(-(gu[i][j] + bias_u)));
        r1[(ty * 8 + i) * kA + c] = gv[i][j] * gu[i][j];
      }
    }
    __syncthreads();

    // ---- p and d_log per (row, branch): one warp per row ------------------
    for (int row = ty; row < kTile; row += kWarps) {
      const int grow = n0 + row;
      const bool valid = row_valid(mask_b, grow, n);
      float gq[4], hq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gq[q] = r1[row * kA + tx + 32 * q];
        hq[q] = hs[row * kL + tx + 32 * q];
      }
      for (int kb = 0; kb < k_br; ++kb) {
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dot = fmaf(gq[q], __ldg(w + (tx + 32 * q) * k_br + kb), dot);
          dp = fmaf(hq[q], __ldg(dbag_b + kb * kL + tx + 32 * q), dp);
        }
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
      float dg[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dg[i][j] = 0.f;
      for (int kb = 0; kb < k_br; ++kb) {
        float dl8[8], wv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) dl8[i] = dls[kb * kTile + ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = __ldg(w + (tx + 32 * j) * k_br + kb);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dg[i][j] = fmaf(dl8[i], wv[j], dg[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
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
      for (int i = 0; i < 8; ++i) {
        r1[(ty * 8 + i) * kA + tx + 32 * j] = gv[i][j];
        r2[(ty * 8 + i) * kA + tx + 32 * j] = gu[i][j];
      }
    __syncthreads();

    // ---- dV = h^T d_av, dU = h^T d_au: thread tile l 16ty.., a 4tx.. ------
#pragma unroll 1
    for (int which = 0; which < 2; ++which) {
      const float* src = which ? r2 : r1;
      float* dst = which ? g_du : g_dv;
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
          const float4 h4 =
              *reinterpret_cast<const float4*>(hs + row * kL + ty * 16 + 4 * m);
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
    {
      const float* src = tid < kA ? r1 : r2;
      const int a = tid % kA;
      float s = 0.f;
      for (int row = 0; row < kTile; ++row) s += src[row * kA + a];
      accumulate((tid < kA ? g_dbv : g_dbu) + a, s, first);
    }

    // ---- d_h = p d_bag + d_av V^T + d_au U^T, r = [h > 0] d_h -------------
    {
      float dh[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[i][j] = 0.f;
      for (int kb = 0; kb < k_br; ++kb) {
        float p8[8], db4[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) p8[i] = ps[kb * kTile + ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) db4[j] = __ldg(dbag_b + kb * kL + tx + 32 * j);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dh[i][j] = fmaf(p8[i], db4[j], dh[i][j]);
      }
      float* vt = stage;                       // [kTDepth][kTStride]: V^T
      float* ut = stage + kTDepth * kTStride;  // [kTDepth][kTStride]: U^T
      for (int a0 = 0; a0 < kA; a0 += kTDepth) {
        __syncthreads();  // dV/dU are done with h; the last slice is read
        for (int q = tid; q < kL * kTDepth; q += kThreads) {
          const int l = q / kTDepth;
          const int aa = q % kTDepth;
          vt[aa * kTStride + l] = __ldg(v + l * kA + a0 + aa);
          ut[aa * kTStride + l] = __ldg(u + l * kA + a0 + aa);
        }
        __syncthreads();
#pragma unroll 4
        for (int aa = 0; aa < kTDepth; ++aa) {
          float dv8[8], du8[8], vv[4], uu[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dv8[i] = r1[(ty * 8 + i) * kA + a0 + aa];
            du8[i] = r2[(ty * 8 + i) * kA + a0 + aa];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            vv[j] = vt[aa * kTStride + tx + 32 * j];
            uu[j] = ut[aa * kTStride + tx + 32 * j];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dh[i][j] = fmaf(dv8[i], vv[j], fmaf(du8[i], uu[j], dh[i][j]));
        }
      }
      // each thread overwrites only the h entries it reads
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (ty * 8 + i) * kL + tx + 32 * j;
          *hp = *hp > 0.f ? dh[i][j] : 0.f;
        }
    }
    __syncthreads();
    if (tid < kL) {
      float s = 0.f;
      for (int row = 0; row < kTile; ++row) s += hs[row * kL + tid];
      accumulate(g_db1 + tid, s, first);
    }

    // ---- dW1 = x^T r and dx = r W1^T, 32 columns of x at a time -----------
    float* xs = stage;                     // [kTile][kDepth]
    float* w1s = stage + kTile * kDepth;   // [kDepth][kW1Stride]: W1 rows
    for (int kc = 0; kc < df; kc += kDepth) {
      __syncthreads();  // the previous slice has been read
      stage_x(xs, xb, n0, n, df, kc);
      for (int q = tid; q < kDepth * kL / 4; q += kThreads) {
        const int dd = q / (kL / 4);
        const int l4 = (q % (kL / 4)) * 4;
        *reinterpret_cast<float4*>(w1s + dd * kW1Stride + l4) =
            __ldg(reinterpret_cast<const float4*>(
                w1 + static_cast<size_t>(kc + dd) * kL + l4));
      }
      __syncthreads();
      // dW1 rows kc + 4ty.., columns 4tx..
      float aw[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) aw[i][q] = 0.f;
#pragma unroll 4
      for (int row = 0; row < kTile; ++row) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(xs + row * kDepth + ty * 4);
        const float4 r4 = *reinterpret_cast<const float4*>(hs + row * kL + tx * 4);
        const float xa[4] = {x4.x, x4.y, x4.z, x4.w};
        const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) aw[i][q] = fmaf(xa[i], ra[q], aw[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          accumulate(g_dw1 + static_cast<size_t>(kc + ty * 4 + i) * kL + tx * 4 + q,
                     aw[i][q], first);
      // dx rows 8ty.., column kc + tx
      if (dx != nullptr) {
        float ax[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ax[i] = 0.f;
#pragma unroll 4
        for (int l = 0; l < kL; l += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w1s + tx * kW1Stride + l);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 r4 =
                *reinterpret_cast<const float4*>(hs + (ty * 8 + i) * kL + l);
            ax[i] = fmaf(r4.x, w4.x, fmaf(r4.y, w4.y,
                    fmaf(r4.z, w4.z, fmaf(r4.w, w4.w, ax[i]))));
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = n0 + ty * 8 + i;
          if (row < n)
            store_dx(dx + (static_cast<size_t>(b) * n + row) * df + kc + tx, ax[i]);
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

template <typename T>
cudaError_t set_smem(int k_br) {
  return cudaFuncSetAttribute(pool_bwd_partial_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(partial_smem_bytes(k_br)));
}

// Blocks of the partial kernel the current device holds at once, or minus
// a cudaError_t.
template <typename T>
int max_blocks(int k_br) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem<T>(k_br);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pool_bwd_partial_kernel<T>, kThreads,
        partial_smem_bytes(k_br));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

template <typename T>
cudaError_t launch(const void* feats, const uint8_t* mask, const float* w1,
                   const float* b1, const float* v, const float* bv,
                   const float* u, const float* bu, const float* w,
                   const float* bw, const float* lse, const float* cc,
                   const float* dbag, const float* dlo, void* dx, float* work,
                   float* grads, int batch, int n, int df, int k_br,
                   int groups, cudaStream_t stream) {
  cudaError_t err = set_smem<T>(k_br);
  if (err != cudaSuccess) return err;
  pool_bwd_partial_kernel<T><<<groups, kThreads, partial_smem_bytes(k_br),
                               stream>>>(
      static_cast<const T*>(feats), mask, w1, b1, v, bv, u, bu, w, bw, lse,
      cc, dbag, dlo, static_cast<T*>(dx), work, batch, n, df, k_br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slice = df * kL + kL + 2 * (kL * kA + kA) + kA * k_br + k_br;
  grad_reduce_kernel<<<(slice + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, stream>>>(work, grads, groups, slice);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of x per tile.
int b2_tile_rows() { return kTile; }

// The most blocks (G) a launch should use on the current device for this K
// and feature dtype, or minus a cudaError_t. The caller sizes the workspace
// as G x slice floats, slice = Df*L + L + 2*(L*A + A) + A*K + K, and passes
// G = min(this, number of tiles).
int b2_max_blocks(int k_br, int feats_half) {
  return feats_half ? max_blocks<__half>(k_br) : max_blocks<float>(k_br);
}

// Launches kernel B2 on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers; `feats_half` selects fp16 (1) or f32
// (0) features (and dx). dx may be null (no input gradient). `grads`
// receives the summed gradients in the workspace slice's layout. Returns the
// cudaError_t of the launches.
int b2_attn_pool_backward(const void* feats, int feats_half, const void* mask,
                          const float* w1, const float* b1, const float* v,
                          const float* bv, const float* u, const float* bu,
                          const float* w, const float* bw, const float* lse,
                          const float* cc, const float* dbag, const float* dlo,
                          void* dx, float* work, float* grads, int batch,
                          int n, int df, int k_br, int groups, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_half)
    return static_cast<int>(launch<__half>(
        feats, m, w1, b1, v, bv, u, bu, w, bw, lse, cc, dbag, dlo, dx, work,
        grads, batch, n, df, k_br, groups, st));
  return static_cast<int>(launch<float>(
      feats, m, w1, b1, v, bv, u, bu, w, bw, lse, cc, dbag, dlo, dx, work,
      grads, batch, n, df, k_br, groups, st));
}

}  // extern "C"
