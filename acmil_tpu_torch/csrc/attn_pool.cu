// Kernel B1: fused gated-attention pooling, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acmil_tpu/ops/attn_pool.py::_kernel, which
// fused_gated_attn_pool_batched launches. For each padded bag b:
//
//   h      = relu(x W1 + b1)                                  [N, L]
//   logits = (tanh(h V + bv) * sigmoid(h U + bu)) w + bw      [N, K]
//   p      = softmax of logits over N, per branch, pads excluded
//   bag[k] = sum_n p[n, k] h[n]                               [K, L]
//
// It also emits the raw logits (-1e30 at pad slots) and the softmax's max m
// and sum s per (bag, branch), as the TPU kernel does.
//
// Design. The TPU walks the N chunks of one bag in sequence on one core and
// carries (m, s, acc) from chunk to chunk. On the H100, with one bag per
// request, that would leave all but one SM idle, so N is split across blocks:
// each block takes a tile of rows of one bag (64 rows at L = 128, 32 above:
// h [rows, L] must fit shared memory beside the staged slices), keeps h, the
// gates and the logits of its rows in shared memory, and writes its own
// partial (m, s, acc[K, L]) to a workspace that the caller allocates. A
// second kernel merges a bag's partials with the flash rule that
// acmil_tpu/ops/attn_pool.py applies across sequence shards:
//
//   M = max_t m_t,  s = sum_t s_t e^(m_t - M),
//   bag = sum_t acc_t e^(m_t - M) / max(s, 1e-12).
//
// Rows past N are masked inside the kernel; nothing is padded by a copy.
// Features are read as fp16 or f32 and widened in registers; every product
// and sum is f32 FMA on the CUDA cores.
//
// Bounds. At the serving width (Df=384, L=A=128) a 65536-row bag is 50 MB of
// fp16 features (100 MB in f32) and about 11 GFLOP, most of it x W1 and the two
// gate products. With tensor cores the op would be bound by HBM; in f32 FMA it
// is bound by the FMA rate (67 TFLOP/s peak), so this kernel is compute-bound.
// A register tile of rows x columns per thread (8 x 4 at L = 128, 4 x L/32
// above), with the operands staged in shared memory 32 columns of depth at a
// time, keeps the FMA units fed from shared memory rather than HBM.
// Tensor-core products (mma/wgmma), TMA and warp specialisation are later
// work.
//
// Widths the kernel takes: L in {128, 256, 384, 512, 768} (one instantiation
// each; every pretrain tag of the configs), A = 128, Df a multiple of 32,
// 1 <= K <= 128. The Python wrapper (acmil_tpu_torch/ops/attn_pool.py) checks
// them and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 128;            // gated-attention hidden width
constexpr int kDepth = 32;         // reduction depth staged per step
constexpr int kThreads = 256;      // 8 warps; warp y owns rows y*kRows..
constexpr int kWarps = kThreads / 32;
constexpr int kGStride = kA + 1;   // padded row stride of g in shared memory
constexpr int kPanel = 128;        // columns of h per merge block
constexpr int kMergeGroups = 8;    // tile groups per merge block
constexpr float kNeg = -1e30f;     // logit at pad slots, as on the TPU

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The per-width layout. One shared region ("stage") holds, in turn, the x
// and W1 slices, the V and U slices, then g.
template <int L>
struct Shape {
  static constexpr int kTile = L == 128 ? 64 : 32;   // rows of x per block
  static constexpr int kRows = kTile / kWarps;       // rows a thread owns
  static constexpr int kCols = L / 32;               // columns of h a thread owns
  static constexpr int kStage = cmax(cmax(kTile * kDepth + kDepth * L,
                                          2 * kDepth * kA),
                                     kTile * kGStride);
  static constexpr int kMinBlocks = L == 128 ? 2 : 1;
  static_assert(L % kPanel == 0 && kTile % 32 == 0, "widths");
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

// Copies `rows` rows of a [*, W] row-major f32 matrix into shared memory.
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * W / 4; q += kThreads) d[q] = s[q];
}

__device__ __forceinline__ bool row_valid(const uint8_t* mask_b, int row,
                                          int n) {
  return row < n && mask_b[row] != 0;
}

// One block per (tile of rows, bag): logits of its rows and its partial
// online-softmax state (m, s, acc).
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, Shape<L>::kMinBlocks)
pool_partial_kernel(const T* __restrict__ feats,       // [B, N, Df]
                    const uint8_t* __restrict__ mask,  // [B, N]
                    const float* __restrict__ w1,      // [Df, L]
                    const float* __restrict__ b1,      // [L]
                    const float* __restrict__ v,       // [L, A]
                    const float* __restrict__ bv,      // [A]
                    const float* __restrict__ u,       // [L, A]
                    const float* __restrict__ bu,      // [A]
                    const float* __restrict__ w,       // [A, K]
                    const float* __restrict__ bw,      // [K]
                    float* __restrict__ logits,        // [B, K, N]
                    float* __restrict__ part_m,        // [B, T, K]
                    float* __restrict__ part_s,        // [B, T, K]
                    float* __restrict__ part_acc,      // [B, T, K, L]
                    int n, int df, int k_br) {
  using S = Shape<L>;
  constexpr int kTile = S::kTile, kRows = S::kRows, kCols = S::kCols;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                 // S::kStage floats
  float* hs = stage + S::kStage;       // [kTile][L]
  float* ls = hs + kTile * L;          // [K][kTile]: logits, then p

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tiles = gridDim.x;
  const int n0 = tile * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 31;             // column group: columns tx + 32 j
  const int ty = tid >> 5;             // row group: rows kRows ty ..
  const T* xb = feats + static_cast<size_t>(b) * n * df;
  const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;

  // ---- h = relu(x W1 + b1) -------------------------------------------------
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  float* xs = stage;                   // [kTile][kDepth]
  float* ws = stage + kTile * kDepth;  // [kDepth][L]
  for (int kc = 0; kc < df; kc += kDepth) {
    __syncthreads();  // the previous slice has been read
    if (tid < kTile * (kDepth / 8)) {
      const int r = tid / (kDepth / 8);   // rows x 4 segments of 8 columns
      const int c = (tid % (kDepth / 8)) * 8;
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
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = tx + 32 * j;
    const float bias = b1[c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      hs[(ty * kRows + i) * L + c] = fmaxf(acc[i][j] + bias, 0.f);
  }

  // ---- g = tanh(h V + bv) * sigmoid(h U + bu) ------------------------------
  float av[kRows][4], au[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      av[i][j] = 0.f;
      au[i][j] = 0.f;
    }
  float* vs = stage;                   // [kDepth][kA]
  float* us = stage + kDepth * kA;     // [kDepth][kA]
  for (int lc = 0; lc < L; lc += kDepth) {
    __syncthreads();  // h is written; the previous slice has been read
    copy_rows<kA>(vs, v + static_cast<size_t>(lc) * kA, kDepth);
    copy_rows<kA>(us, u + static_cast<size_t>(lc) * kA, kDepth);
    __syncthreads();
#pragma unroll 4
    for (int ll = 0; ll < kDepth; ++ll) {
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
          av[i][j] = fmaf(hv[i], bvv[j], av[i][j]);
          au[i][j] = fmaf(hv[i], buu[j], au[i][j]);
        }
    }
  }
  __syncthreads();  // V and U slices are read: the stage now holds g
  float* gs = stage;                   // [kTile][kGStride]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 32 * j;
    const float bias_v = bv[c];
    const float bias_u = bu[c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float gate_v = tanhf(av[i][j] + bias_v);
      const float gate_u = 1.f / (1.f + expf(-(au[i][j] + bias_u)));
      gs[(ty * kRows + i) * kGStride + c] = gate_v * gate_u;
    }
  }
  __syncthreads();

  // ---- logits = g w + bw, -1e30 at pads; written to [B, K, N] --------------
  for (int idx = tid; idx < k_br * kTile; idx += kThreads) {
    const int r = idx % kTile;
    const int kb = idx / kTile;
    float dot = 0.f;
#pragma unroll 8
    for (int a = 0; a < kA; ++a)
      dot = fmaf(gs[r * kGStride + a], __ldg(w + a * k_br + kb), dot);
    const int row = n0 + r;
    const float val = row_valid(mask_b, row, n) ? dot + bw[kb] : kNeg;
    ls[kb * kTile + r] = val;
    if (row < n) logits[(static_cast<size_t>(b) * k_br + kb) * n + row] = val;
  }
  __syncthreads();

  // ---- tile softmax state per branch: one warp per branch ------------------
  constexpr int kPerLane = kTile / 32;
  for (int kb = ty; kb < k_br; kb += kWarps) {
    float xv[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) xv[q] = ls[kb * kTile + tx + 32 * q];
    float mx = xv[0];
#pragma unroll
    for (int q = 1; q < kPerLane; ++q) mx = fmaxf(mx, xv[q]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float pv[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      pv[q] = row_valid(mask_b, n0 + tx + 32 * q, n) ? expf(xv[q] - mx) : 0.f;
    float s = pv[0];
#pragma unroll
    for (int q = 1; q < kPerLane; ++q) s += pv[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) ls[kb * kTile + tx + 32 * q] = pv[q];
    if (tx == 0) {
      const size_t o = (static_cast<size_t>(b) * tiles + tile) * k_br + kb;
      part_m[o] = mx;
      part_s[o] = s;
    }
  }
  __syncthreads();

  // ---- acc[k, l] = sum_r p[k, r] h[r, l] -----------------------------------
  for (int idx = tid; idx < k_br * L; idx += kThreads) {
    const int l = idx % L;
    const int kb = idx / L;
    float a = 0.f;
#pragma unroll 8
    for (int r = 0; r < kTile; ++r)
      a = fmaf(ls[kb * kTile + r], hs[r * L + l], a);
    part_acc[((static_cast<size_t>(b) * tiles + tile) * k_br + kb) * L + l] = a;
  }
}

// One block per (branch, bag, panel of 128 columns): flash merge of the
// bag's tile partials.
__global__ void __launch_bounds__(kMergeGroups * kPanel)
pool_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const float* __restrict__ part_acc,
                  float* __restrict__ bag,      // [B, K, L]
                  float* __restrict__ m_out,    // [B, K]
                  float* __restrict__ s_out,    // [B, K]
                  int tiles, int k_br, int l_dim) {
  __shared__ float red_acc[kMergeGroups][kPanel];
  __shared__ float red_s[kMergeGroups];
  __shared__ float red_m[kMergeGroups];
  const int kb = blockIdx.x;
  const int b = blockIdx.y;
  const int lp = threadIdx.x % kPanel;
  const int l = blockIdx.z * kPanel + lp;
  const int g = threadIdx.x / kPanel;
  const size_t base = static_cast<size_t>(b) * tiles;

  float mx = kNeg;
  for (int t = g; t < tiles; t += kMergeGroups)
    mx = fmaxf(mx, part_m[(base + t) * k_br + kb]);
  if (lp == 0) red_m[g] = mx;
  __syncthreads();
  float m_all = kNeg;
#pragma unroll
  for (int i = 0; i < kMergeGroups; ++i) m_all = fmaxf(m_all, red_m[i]);

  // an all-masked tile has m = -1e30, s = 0 and acc = 0: it adds nothing,
  // and an all-masked bag ends with s = 0 and bag = 0
  float s = 0.f, a = 0.f;
  for (int t = g; t < tiles; t += kMergeGroups) {
    const size_t o = (base + t) * k_br + kb;
    const float wgt = expf(part_m[o] - m_all);
    s = fmaf(part_s[o], wgt, s);
    a = fmaf(part_acc[o * l_dim + l], wgt, a);
  }
  red_acc[g][lp] = a;
  if (lp == 0) red_s[g] = s;
  __syncthreads();
  if (g == 0) {
    float a_all = 0.f, s_all = 0.f;
#pragma unroll
    for (int i = 0; i < kMergeGroups; ++i) {
      a_all += red_acc[i][lp];
      s_all += red_s[i];
    }
    const size_t o = static_cast<size_t>(b) * k_br + kb;
    bag[o * l_dim + l] = a_all / fmaxf(s_all, 1e-12f);
    if (l == 0) {
      m_out[o] = m_all;
      s_out[o] = s_all;
    }
  }
}

template <typename T, int L>
cudaError_t launch(const void* feats, const uint8_t* mask, const float* w1,
                   const float* b1, const float* v, const float* bv,
                   const float* u, const float* bu, const float* w,
                   const float* bw, float* logits, float* bag, float* m_out,
                   float* s_out, float* part_m, float* part_s,
                   float* part_acc, int batch, int n, int df, int k_br,
                   cudaStream_t stream) {
  using S = Shape<L>;
  const int tiles = (n + S::kTile - 1) / S::kTile;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(S::kStage) + S::kTile * L + k_br * S::kTile);
  cudaError_t err = cudaFuncSetAttribute(
      pool_partial_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  pool_partial_kernel<T, L><<<dim3(tiles, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(feats), mask, w1, b1, v, bv, u, bu, w, bw, logits,
      part_m, part_s, part_acc, n, df, k_br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pool_merge_kernel<<<dim3(k_br, batch, L / kPanel), kMergeGroups * kPanel, 0,
                      stream>>>(part_m, part_s, part_acc, bag, m_out, s_out,
                                tiles, k_br, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int l_dim, const void* feats, const uint8_t* mask,
                         const float* w1, const float* b1, const float* v,
                         const float* bv, const float* u, const float* bu,
                         const float* w, const float* bw, float* logits,
                         float* bag, float* m_out, float* s_out,
                         float* part_m, float* part_s, float* part_acc,
                         int batch, int n, int df, int k_br,
                         cudaStream_t stream) {
#define B1_LAUNCH(LL)                                                         \
  case LL:                                                                    \
    return launch<T, LL>(feats, mask, w1, b1, v, bv, u, bu, w, bw, logits,    \
                         bag, m_out, s_out, part_m, part_s, part_acc, batch,  \
                         n, df, k_br, stream);
  switch (l_dim) {
    B1_LAUNCH(128)
    B1_LAUNCH(256)
    B1_LAUNCH(384)
    B1_LAUNCH(512)
    B1_LAUNCH(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef B1_LAUNCH
}

}  // namespace

extern "C" {

// Rows of x per block at this L (0 for an L the kernel does not take); the
// caller sizes the partial workspace with it.
int b1_tile_rows(int l_dim) {
  switch (l_dim) {
    case 128: return Shape<128>::kTile;
    case 256: return Shape<256>::kTile;
    case 384: return Shape<384>::kTile;
    case 512: return Shape<512>::kTile;
    case 768: return Shape<768>::kTile;
    default: return 0;
  }
}

// Launches kernel B1 on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers; `feats_half` selects fp16 (1) or f32
// (0) features. part_* is the workspace: [B, T, K] twice and [B, T, K, L],
// T = ceil(N / b1_tile_rows(L)). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for an L the kernel does not take).
int b1_attn_pool_forward(const void* feats, int feats_half,
                         const void* mask, const float* w1, const float* b1,
                         const float* v, const float* bv, const float* u,
                         const float* bu, const float* w, const float* bw,
                         float* logits, float* bag, float* m_out,
                         float* s_out, float* part_m, float* part_s,
                         float* part_acc, int batch, int n, int df, int k_br,
                         int l_dim, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_half)
    return static_cast<int>(launch_width<__half>(
        l_dim, feats, m, w1, b1, v, bv, u, bu, w, bw, logits, bag, m_out,
        s_out, part_m, part_s, part_acc, batch, n, df, k_br, st));
  return static_cast<int>(launch_width<float>(
      l_dim, feats, m, w1, b1, v, bv, u, bu, w, bw, logits, bag, m_out, s_out,
      part_m, part_s, part_acc, batch, n, df, k_br, st));
}

}  // extern "C"
