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
// C = 2). A small first kernel forms u and beta once per bag; the logits then
// differ from the Pallas kernel's only in the order of f32 sums.
//
// Design. The TPU walks a bag's N chunks in sequence on one core. With one
// bag per request that would leave all but one SM idle, so N is split as in
// kernel B1 (csrc/attn_pool.cu): one block per 64-row tile of one bag and
// one group of up to 8 classes (a third grid dimension: C = 128 is 16
// groups, each with its own logits, partials and merge, and each reading
// the tile's rows again, from L2 after the first group). The
// block stages its rows 16 at a time in shared memory, widened to f32 (fp16
// features are read as they come: the conversion is exact and no f32 copy of
// the bag exists), forms their logits, and runs the online softmax over its
// tile with the accumulator acc[c, d] in registers (each thread owns up to 6
// of the D columns for every class). Each tile writes its partial (m, s,
// acc[C, D]); a third kernel merges a bag's partials with the flash rule,
//
//   M = max_t m_t,  s = sum_t s_t e^(m_t - M),
//   bag = sum_t acc_t e^(m_t - M) / max(s, 1e-12),
//
// so an all-masked bag (s = 0, acc = 0) gives bag = 0 and no NaN, as the TPU
// kernel's max(s, 1e-12) does. Rows past N are masked in the kernel; nothing
// is padded by a copy. Every product and sum is f32 FMA on the CUDA cores.
//
// Bounds. At N = 65536, D = 384, Q = 128, C = 2 with fp16 features the op
// reads 50.3 MB of x and writes 0.5 MB of logits: about 15 us at 3.35 TB/s,
// against 6.6 GFLOP of the TPU kernel's work (7 us at the tensor-core peak).
// With the queries folded the kernel does 0.1 GFLOP, so it is bound by
// reading x once. The partials add C*D*4 bytes per 64-row tile (6% of the
// fp16 bytes at D = 384). Tensor cores, TMA and larger tiles are later work.
//
// Widths the kernel takes: D a multiple of 8 up to 1536, 1 <= C <= 128 (the
// TPU kernel's limit), any Q and N. The Python wrapper (acmil_tpu_torch/ops/dsmil_pool.py) checks them
// and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // rows of x per block
constexpr int kChunk = 16;                 // rows staged in shared memory per step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 8;                   // classes per group (block)
constexpr int kMaxClasses = 128;           // classes per bag
constexpr int kMaxCols = 6;                // columns of D per thread
constexpr int kMaxD = kThreads * kMaxCols; // 1536
constexpr int kFoldThreads = 128;
constexpr int kMergeCols = 32;             // columns of D per merge block
constexpr int kMergeGroups = 8;            // tile groups per merge block
constexpr float kNeg = -1e30f;             // logit at masked rows, as on the TPU

// small per-block state ahead of the staged rows, in floats: logits and p of
// the chunk [C][kChunk] each, beta, the running and the new max [C] each,
// and one validity flag per chunk row
constexpr int kSmall = 2 * kMaxC * kChunk + 3 * kMaxC + kChunk;
static_assert(kSmall % 4 == 0, "keeps the staged rows 16-byte aligned");

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

// One thread per column d of one bag and class group (d == D is beta's
// column, from bq): u[b, c, d] = inv_sqrt_q * sum_q wq_t[q, d] q_max[b, c, q].
__global__ void __launch_bounds__(kFoldThreads)
fold_queries_kernel(const float* __restrict__ wq_t,    // [Q, D]
                    const float* __restrict__ bq,      // [Q]
                    const float* __restrict__ q_max,   // [B, C, Q]
                    float* __restrict__ u,             // [B, C, D + 1]
                    int d_feat, int q_dim, int n_cls, float inv_sqrt_q) {
  extern __shared__ float qs[];                        // [group's C][Q]
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kMaxC;                   // the class group
  const int ncl = min(kMaxC, n_cls - c0);
  const float* qm = q_max + (static_cast<size_t>(b) * n_cls + c0) * q_dim;
  for (int i = threadIdx.x; i < ncl * q_dim; i += kFoldThreads) qs[i] = qm[i];
  __syncthreads();
  const int d = blockIdx.x * kFoldThreads + threadIdx.x;
  if (d > d_feat) return;
  const float* col = d < d_feat ? wq_t + d : bq;
  const size_t stride = d < d_feat ? static_cast<size_t>(d_feat) : 1;
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.f;
  for (int q = 0; q < q_dim; ++q) {
    const float w = col[q * stride];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < ncl) acc[c] = fmaf(w, qs[c * q_dim + q], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < ncl)
      u[(static_cast<size_t>(b) * n_cls + c0 + c) * (d_feat + 1) + d] =
          acc[c] * inv_sqrt_q;
}

// One block per (64-row tile, bag, group of up to 8 classes): the logits of
// its rows for the group's classes and its partial online-softmax state
// (m, s, acc[group's C, D]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_partial_kernel(const T* __restrict__ feats,       // [B, N, D]
                    const uint8_t* __restrict__ mask,  // [B, N]
                    const float* __restrict__ u,       // [B, C, D + 1]
                    float* __restrict__ logits,        // [B, C, N]
                    float* __restrict__ part_m,        // [B, T, C]
                    float* __restrict__ part_s,        // [B, T, C]
                    float* __restrict__ part_acc,      // [B, T, C, D]
                    int n, int d_feat, int n_cls) {
  extern __shared__ __align__(16) float smem[];
  float* ls = smem;                          // [kMaxC][kChunk] logits
  float* ps = ls + kMaxC * kChunk;           // [kMaxC][kChunk] p
  float* betas = ps + kMaxC * kChunk;        // [kMaxC]
  float* m_run = betas + kMaxC;              // [kMaxC] max before this chunk
  float* m_new = m_run + kMaxC;              // [kMaxC] max after it
  int* valid = reinterpret_cast<int*>(m_new + kMaxC);   // [kChunk]

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kMaxC;         // the group's first class
  const int ncl = min(kMaxC, n_cls - c0);    // and its number of classes
  float* us = smem + kSmall;                 // [ncl][D]
  float* xs = us + ncl * d_feat;             // [kChunk][D]
  const int tiles = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = tile * kTile;
  const T* xb = feats + static_cast<size_t>(b) * n * d_feat;
  const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
  const float* ub = u + (static_cast<size_t>(b) * n_cls + c0) * (d_feat + 1);

  for (int i = tid; i < ncl * d_feat; i += kThreads)
    us[i] = ub[(i / d_feat) * (d_feat + 1) + i % d_feat];
  if (tid < ncl) {
    betas[tid] = ub[tid * (d_feat + 1) + d_feat];
    m_new[tid] = kNeg;
  }

  float s[kMaxC], acc[kMaxC][kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    s[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[c][j] = 0.f;
  }

  const int row_end = min(n0 + kTile, n);
  for (int r0 = n0; r0 < row_end; r0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed; its new max is final
    if (tid < ncl) m_run[tid] = m_new[tid];
    // stage rows [r0, r0 + kChunk) as f32; rows past N become zeros
    {
      const T* src = xb + static_cast<size_t>(r0) * d_feat;
      const int avail = min(kChunk, n - r0) * d_feat;
      for (int e = tid * 8; e < kChunk * d_feat; e += kThreads * 8) {
        float v[8];
        if (e < avail) {
          load8(src + e, v);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(xs + e);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    if (tid < kChunk) {
      const int row = r0 + tid;
      valid[tid] = row < n && mask_b[row] != 0;
    }
    __syncthreads();

    // logits: one warp per (row, class), lanes over D
    for (int pr = warp; pr < kChunk * ncl; pr += kWarps) {
      const int r = pr % kChunk;
      const int c = pr / kChunk;
      const float* xr = xs + r * d_feat;
      const float* uc = us + c * d_feat;
      float dot = 0.f;
      for (int d = lane; d < d_feat; d += 32) dot = fmaf(xr[d], uc[d], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int row = r0 + r;
        const float val = valid[r] ? dot + betas[c] : kNeg;
        ls[c * kChunk + r] = val;
        if (row < n)
          logits[(static_cast<size_t>(b) * n_cls + c0 + c) * n + row] = val;
      }
    }
    __syncthreads();

    // p of each (class, row) against the class's new running max
    if (tid < ncl * kChunk) {
      const int c = tid / kChunk;
      const int r = tid % kChunk;
      float mx = m_run[c];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) mx = fmaxf(mx, ls[c * kChunk + i]);
      ps[c * kChunk + r] = valid[r] ? expf(ls[c * kChunk + r] - mx) : 0.f;
      if (r == 0) m_new[c] = mx;
    }
    __syncthreads();

    // rescale the running sum and accumulator, then add this chunk
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= ncl) break;
      const float scale = expf(m_run[c] - m_new[c]);
      const float* pc = ps + c * kChunk;
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) psum += pc[r];
      s[c] = fmaf(s[c], scale, psum);
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int col = tid + kThreads * j;
        if (col >= d_feat) break;
        float a = acc[c][j] * scale;
#pragma unroll
        for (int r = 0; r < kChunk; ++r) a = fmaf(pc[r], xs[r * d_feat + col], a);
        acc[c][j] = a;
      }
    }
  }
  __syncthreads();  // the last chunk's max is final

  const size_t part = static_cast<size_t>(b) * tiles + tile;
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= ncl) break;
      part_m[part * n_cls + c0 + c] = m_new[c];
      part_s[part * n_cls + c0 + c] = s[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= ncl) break;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int col = tid + kThreads * j;
      if (col >= d_feat) break;
      part_acc[(part * n_cls + c0 + c) * d_feat + col] = acc[c][j];
    }
  }
}

// One block per (32 columns, class, bag): flash merge of the bag's tiles.
__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
pool_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const float* __restrict__ part_acc,
                  float* __restrict__ bag,             // [B, C, D]
                  int tiles, int n_cls, int d_feat) {
  __shared__ float red_m[kMergeGroups];
  __shared__ float red_s[kMergeGroups];
  __shared__ float red_acc[kMergeGroups][kMergeCols];
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int l = threadIdx.x % kMergeCols;
  const int g = threadIdx.x / kMergeCols;
  const int d = blockIdx.x * kMergeCols + l;
  const size_t base = static_cast<size_t>(b) * tiles;

  float mx = kNeg;
  for (int t = threadIdx.x; t < tiles; t += kMergeCols * kMergeGroups)
    mx = fmaxf(mx, part_m[(base + t) * n_cls + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (l == 0) red_m[g] = mx;
  __syncthreads();
  float m_all = kNeg;
#pragma unroll
  for (int i = 0; i < kMergeGroups; ++i) m_all = fmaxf(m_all, red_m[i]);

  // an all-masked tile has m = -1e30, s = 0 and acc = 0: it adds nothing,
  // and an all-masked bag ends with s = 0 and bag = 0
  float s = 0.f, a = 0.f;
  for (int t = g; t < tiles; t += kMergeGroups) {
    const size_t o = (base + t) * n_cls + c;
    const float w = expf(part_m[o] - m_all);
    s = fmaf(part_s[o], w, s);
    if (d < d_feat) a = fmaf(part_acc[o * d_feat + d], w, a);
  }
  red_acc[g][l] = a;
  if (l == 0) red_s[g] = s;
  __syncthreads();
  if (g == 0 && d < d_feat) {
    float a_all = 0.f, s_all = 0.f;
#pragma unroll
    for (int i = 0; i < kMergeGroups; ++i) {
      a_all += red_acc[i][l];
      s_all += red_s[i];
    }
    bag[(static_cast<size_t>(b) * n_cls + c) * d_feat + d] =
        a_all / fmaxf(s_all, 1e-12f);
  }
}

template <typename T>
cudaError_t launch(const void* feats, const uint8_t* mask, const float* wq_t,
                   const float* bq, const float* q_max, float* u,
                   float* logits, float* bag, float* part_m, float* part_s,
                   float* part_acc, int batch, int n, int d_feat, int q_dim,
                   int n_cls, float inv_sqrt_q, cudaStream_t stream) {
  const int groups = (n_cls + kMaxC - 1) / kMaxC;
  const int group_cls = n_cls < kMaxC ? n_cls : kMaxC;
  const size_t fold_smem = sizeof(float) * group_cls * q_dim;
  cudaError_t err = cudaFuncSetAttribute(
      fold_queries_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fold_smem));
  if (err != cudaSuccess) return err;
  fold_queries_kernel<<<dim3((d_feat + kFoldThreads) / kFoldThreads, batch,
                             groups),
                        kFoldThreads, fold_smem, stream>>>(
      wq_t, bq, q_max, u, d_feat, q_dim, n_cls, inv_sqrt_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem =
      sizeof(float) * (kSmall + static_cast<size_t>(group_cls + kChunk) * d_feat);
  err = cudaFuncSetAttribute(pool_partial_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  pool_partial_kernel<T><<<dim3(tiles, batch, groups), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(feats), mask, u, logits, part_m, part_s, part_acc,
      n, d_feat, n_cls);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  pool_merge_kernel<<<dim3((d_feat + kMergeCols - 1) / kMergeCols, n_cls,
                           batch),
                      kMergeCols * kMergeGroups, 0, stream>>>(
      part_m, part_s, part_acc, bag, tiles, n_cls, d_feat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of x per tile; the caller sizes the partial workspace with it.
int b6_tile_rows() { return kTile; }

// Launches kernel B6 on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers: feats [B, N, D] (fp16 when feats_half
// is 1, else f32), mask [B, N] bytes, wq_t [Q, D] (Wq transposed: the torch
// Linear's weight), bq [Q], q_max [B, C, Q]; outputs logits [B, C, N] and bag
// [B, C, D]; workspace u [B, C, D + 1], part_m and part_s [B, T, C], part_acc
// [B, T, C, D] with T = ceil(N / b6_tile_rows()). Returns the cudaError_t of
// the launches.
int b6_dsmil_pool(const void* feats, int feats_half, const void* mask,
                  const float* wq_t, const float* bq, const float* q_max,
                  float* u, float* logits, float* bag, float* part_m,
                  float* part_s, float* part_acc, int batch, int n,
                  int d_feat, int q_dim, int n_cls, float inv_sqrt_q,
                  void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_cls < 1 || n_cls > kMaxClasses || d_feat % 8 || d_feat > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (feats_half)
    return static_cast<int>(launch<__half>(
        feats, m, wq_t, bq, q_max, u, logits, bag, part_m, part_s, part_acc,
        batch, n, d_feat, q_dim, n_cls, inv_sqrt_q, st));
  return static_cast<int>(launch<float>(
      feats, m, wq_t, bq, q_max, u, logits, bag, part_m, part_s, part_acc,
      batch, n, d_feat, q_dim, n_cls, inv_sqrt_q, st));
}

}  // extern "C"
