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
// carries (m, s, acc) from chunk to chunk, h never leaving VMEM. On the H100
// the products run on the tensor cores, which take operands from shared
// memory in tiles of their own shape, so B1 runs as five kernels around one
// [M, L] intermediate (M = B N rows):
//
//   the H stage (gated_h.cuh, shared with kernel B2): the norms of x's rows
//   and W1's columns; H = relu(X W1 + b1) in 128 x 128 tiles; the near-0
//   pre-activations recomputed in the forward's order. For the same inputs
//   B1's h and B2's H are the same bits, so the relu masks of the forward
//   and the backward agree by construction.
//   b1_row_kernel     per 64-row tile of one bag: H V + bv and H U + bu,
//                     each gate in its product's epilogue, the logits
//                     (stored to [B, K, N]), the tile's max m and sum s per
//                     branch, and acc = p^T H [K, L]: the tile's partial
//   b1_merge_kernel   the flash merge of each bag's partials, the rule that
//                     acmil_tpu/ops/attn_pool.py applies across shards:
//                     M = max_t m_t, s = sum_t s_t e^(m_t - M),
//                     bag = sum_t acc_t e^(m_t - M) / max(s, 1e-12)
//
// x W1 and the gate products are split-TF32 products (tf32x3.cuh:
// mma.sync m16n8k8 on hi/lo TF32 parts, f32 accumulation; two MMAs a
// product with fp16 x, which TF32 holds exactly, three otherwise), so they
// keep about f32's accuracy. The logits (A terms) and p^T H (64 rows) are
// f32 FMA chains in a fixed order. The row kernel runs one block per (bag,
// tile), each tile's partial written whole (a persistent grid was no
// faster: scripts/attn_variants.py --kernel b1). Its shared memory (the
// GEMM ring, which p^T H's sums reuse, the gates [64][A] and p [K][64])
// lets two blocks share an SM at K <= 8, so that one block's elementwise
// steps and barriers overlap the other's products.
//
// Bounds. At Df = 384, L = A = 128, N = 65536, B1 does about 11 GFLOP (x W1
// 6.4, the gates 4.3) and must move 50 MB of fp16 features; H adds 2 x 34
// MB of f32 traffic (written once, read by the row kernel). At Df = 1536,
// L = 768, 2 x 201 MB and 180 GFLOP. At two or three TF32 MMAs a product
// (495 TFLOP/s dense) the products bound it, not the bytes.
//
// Rows past N are masked inside the kernels; nothing is padded by a copy.
// An all-masked bag ends with bag 0, s 0 and m -1e30. No float atomics:
// every sum has a fixed order, so two launches give the same bits.
//
// Widths the kernel takes: L in {128, 256, 384, 512, 768} (one
// instantiation of the row kernel each; every pretrain tag of the configs),
// A = 128, Df a multiple of 32, 1 <= K <= 128, fp16 or f32 features. The
// Python wrapper (acmil_tpu_torch/ops/attn_pool.py) checks them, allocates
// the workspace and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_h.cuh"
#include "tf32x3.cuh"

namespace {

using namespace gated_h;

constexpr int kTile = 64;            // rows of a row-kernel tile
constexpr int kGStride = kA + 4;     // rows of the gates in shared memory
constexpr int kPanel = 128;          // columns of p^T H at a time
constexpr int kGroupRows = kTile / kWarps;  // rows a warp sums in p^T H
constexpr int kChunk = 8;            // branches p^T H takes at a time
constexpr int kMergeCols = 32;       // columns of the bag per merge block
constexpr int kMergeThreads = 512;
constexpr int kMergeGroups = kMergeThreads / kMergeCols;  // tile groups
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeChunk = 2048;    // tiles whose weights a block holds
constexpr float kNeg = -1e30f;       // logit at pad slots, as on the TPU

// Z = H V or H U, one half at a time: A = H (row, l), B(k = l, n = a) =
// V[l][a] (or U)
using GemmZ = tf32x3::BlockGemm<Op<float, true, kTile>, Op<float, false, kA>,
                                kTile, kA, kBK, 2, 4, kStages>;
// p^T H's per-warp sums, [kWarps][kChunk][kPanel], alias the GEMM ring
static_assert(kWarps * kChunk * kPanel * 4 <= GemmZ::kSmemBytes, "ring");

// bytes of the row kernel's shared memory: the GEMM ring, the gates,
// logits/p; at K <= 8 two blocks fit an SM
size_t row_smem_bytes(int k_br) {
  return GemmZ::kSmemBytes + sizeof(float) * (kTile * kGStride + k_br * kTile);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ bool row_valid(const uint8_t* mask_b, int row,
                                          int n) {
  return row < n && mask_b[row] != 0;
}

// ---- the row kernel ------------------------------------------------------
// Block g takes the (bag, 64-row tile) pairs g, g + G, ... (one pair each
// in the grid B1 launches); pair t writes part_m[t], part_s[t] (K floats
// each) and part_acc[t] (K x L floats).
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
b1_row_kernel(const float* __restrict__ hg,        // [B, N, L]
              const uint8_t* __restrict__ mask,    // [B, N]
              const float* __restrict__ v,         // [L, A]
              const float* __restrict__ bv,        // [A]
              const float* __restrict__ u,         // [L, A]
              const float* __restrict__ bu,        // [A]
              const float* __restrict__ w,         // [A, K]
              const float* __restrict__ bw,        // [K]
              float* __restrict__ logits,          // [B, K, N]
              float* __restrict__ part_m,          // [B, T, K]
              float* __restrict__ part_s,          // [B, T, K]
              float* __restrict__ part_acc,        // [B, T, K, L]
              int batch, int n, int k_br) {
  extern __shared__ __align__(16) char smem[];
  char* ring = smem;                                          // GEMM slices
  float* red = reinterpret_cast<float*>(smem);                // p^T H sums, in the ring
  float* gs = reinterpret_cast<float*>(smem + GemmZ::kSmemBytes);  // [kTile][kGStride]
  float* ls = gs + kTile * kGStride;                          // [K][kTile]: logits, then p

  const int tid = threadIdx.x;
  const int tx = tid & 31;             // lane
  const int ty = tid >> 5;             // warp
  const int tiles = (n + kTile - 1) / kTile;
  const int total = batch * tiles;
  // every write to shared memory below comes after the next tile's GEMM has
  // passed a __syncthreads, so the tiles need no barrier between them
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / tiles;
    const int n0 = (t - b * tiles) * kTile;
    const int rows = min(kTile, n - n0);                  // rows of this bag
    const float* hb = hg + (static_cast<size_t>(b) * n + n0) * L;
    const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;

    // ---- g = tanh(H V + bv) sigmoid(H U + bu), each gate in its product's
    // epilogue: the two products give a thread the same elements, so it
    // reads back only what it stored. Rows past N are staged as 0 ---------
    {
      float acc[GemmZ::kMT][GemmZ::kNT][4];
      GemmZ::zero(acc);
      GemmZ::run(acc, {hb, L, rows, L}, {v, kA, kA, L}, 0, 0, 0, L, ring);
      GemmZ::for_pairs(acc, 0, 0, [&](int r, int c, float v0, float v1) {
        store2(gs + r * kGStride + c, tanhf(v0 + bv[c]), tanhf(v1 + bv[c + 1]));
      });
      GemmZ::zero(acc);
      GemmZ::run(acc, {hb, L, rows, L}, {u, kA, kA, L}, 0, 0, 0, L, ring);
      GemmZ::for_pairs(acc, 0, 0, [&](int r, int c, float v0, float v1) {
        float* g = gs + r * kGStride + c;
        store2(g, g[0] * sigmoid(v0 + bu[c]), g[1] * sigmoid(v1 + bu[c + 1]));
      });
    }
    __syncthreads();

    // ---- logits = g w + bw, one thread a (row, branch), four chains summed
    // in order; -1e30 at masked rows and past N ----------------------------
    for (int idx = tid; idx < kTile * k_br; idx += kThreads) {
      const int row = idx / k_br, kb = idx % k_br;
      const float* g = gs + row * kGStride;
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int a = 0; a < kA; a += 4)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          d4[i] = fmaf(g[a + i], __ldg(w + (a + i) * k_br + kb), d4[i]);
      const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
      ls[kb * kTile + row] = row_valid(mask_b, n0 + row, n) ? dot + bw[kb] : kNeg;
    }
    __syncthreads();

    // ---- per branch, one warp: the logits to [B, K, N], the tile's max and
    // sum, and p in place of the logits -------------------------------------
    constexpr int kPerLane = kTile / 32;
    for (int kb = ty; kb < k_br; kb += kWarps) {
      float* lk = ls + kb * kTile;
      float* out = logits + (static_cast<size_t>(b) * k_br + kb) * n + n0;
      float xv[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        xv[q] = lk[tx + 32 * q];
        if (tx + 32 * q < rows) out[tx + 32 * q] = xv[q];
      }
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
      for (int q = 0; q < kPerLane; ++q) lk[tx + 32 * q] = pv[q];
      if (tx == 0) {
        part_m[static_cast<size_t>(t) * k_br + kb] = mx;
        part_s[static_cast<size_t>(t) * k_br + kb] = s;
      }
    }
    __syncthreads();

    // ---- acc[k][l] = sum over the tile's rows of p[k][r] H[r][l], per
    // panel of 128 columns and chunk of 8 branches: warp w sums rows 8 w ..
    // 8 w + 7 in order for four columns a lane (its eight loads issued
    // together), then the eight warps' sums are added in order ------------
#pragma unroll 1
    for (int lp = 0; lp < L; lp += kPanel) {
      for (int k0 = 0; k0 < k_br; k0 += kChunk) {
        float a[kChunk][4];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
        float4 h4[kGroupRows];
#pragma unroll
        for (int i = 0; i < kGroupRows; ++i) {
          const int r = ty * kGroupRows + i;
          h4[i] = r < rows ? __ldg(reinterpret_cast<const float4*>(
                                 hb + static_cast<size_t>(r) * L + lp + 4 * tx))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kGroupRows; ++i) {
          const float* pr = ls + ty * kGroupRows + i;   // p of row r, branch 0
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const float p = pr[min(k0 + j, k_br - 1) * kTile];
            a[j][0] = fmaf(p, h4[i].x, a[j][0]);
            a[j][1] = fmaf(p, h4[i].y, a[j][1]);
            a[j][2] = fmaf(p, h4[i].z, a[j][2]);
            a[j][3] = fmaf(p, h4[i].w, a[j][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          *reinterpret_cast<float4*>(red + (ty * kChunk + j) * kPanel + 4 * tx) =
              make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
        __syncthreads();
        for (int q = tid; q < kChunk * kPanel; q += kThreads) {
          const int j = q / kPanel, c = q % kPanel;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += red[(w * kChunk + j) * kPanel + c];
          if (k0 + j < k_br)
            part_acc[(static_cast<size_t>(t) * k_br + k0 + j) * L + lp + c] = sum;
        }
        __syncthreads();   // the sums (in the ring) have been read
      }
    }
  }
}

// ---- the merge: one block per (branch, bag, panel of 32 columns). Each
// tile's weight e^(m_t - M) is formed once, in shared memory; thread (g, c)
// sums the tiles g, g + 16, ... of column c, then the 16 groups are added in
// order. Every sum has a fixed order --------------------------------------
__global__ void __launch_bounds__(kMergeThreads)
b1_merge_kernel(const float* __restrict__ part_m,
                const float* __restrict__ part_s,
                const float* __restrict__ part_acc,
                float* __restrict__ bag,      // [B, K, L]
                float* __restrict__ m_out,    // [B, K]
                float* __restrict__ s_out,    // [B, K]
                int tiles, int k_br, int l_dim) {
  __shared__ float wgt[kMergeChunk];
  __shared__ float red_acc[kMergeGroups][kMergeCols];
  __shared__ float red_w[kMergeWarps];
  const int kb = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x % kMergeCols;
  const int g = threadIdx.x / kMergeCols;
  const int l = blockIdx.z * kMergeCols + c;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t base = static_cast<size_t>(b) * tiles;

  // M = max_t m_t (a max is exact in any order)
  float mx = kNeg;
  for (int t = threadIdx.x; t < tiles; t += kMergeThreads)
    mx = fmaxf(mx, part_m[(base + t) * k_br + kb]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red_w[warp] = mx;
  __syncthreads();
  float m_all = kNeg;
#pragma unroll
  for (int i = 0; i < kMergeWarps; ++i) m_all = fmaxf(m_all, red_w[i]);

  // an all-masked tile has m = -1e30, s = 0 and acc = 0: it adds nothing,
  // and an all-masked bag ends with s = 0 and bag = 0
  float s = 0.f, a = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += kMergeChunk) {
    const int len = min(kMergeChunk, tiles - t0);
    for (int i = threadIdx.x; i < len; i += kMergeThreads) {
      const size_t o = (base + t0 + i) * k_br + kb;
      const float wt = expf(part_m[o] - m_all);
      wgt[i] = wt;
      s = fmaf(part_s[o], wt, s);
    }
    __syncthreads();
    const float* acc_t = part_acc + ((base + t0) * k_br + kb) * l_dim + l;
    const size_t stride = static_cast<size_t>(k_br) * l_dim;   // a tile's
#pragma unroll 8
    for (int i = g; i < len; i += kMergeGroups)
      a = fmaf(acc_t[i * stride], wgt[i], a);
    __syncthreads();   // the weights have been read (and m_all, at first)
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red_w[warp] = s;
  red_acc[g][c] = a;
  __syncthreads();
  if (g == 0) {
    float a_all = 0.f, s_all = 0.f;
#pragma unroll
    for (int i = 0; i < kMergeGroups; ++i) a_all += red_acc[i][c];
#pragma unroll
    for (int i = 0; i < kMergeWarps; ++i) s_all += red_w[i];
    const size_t o = static_cast<size_t>(b) * k_br + kb;
    bag[o * l_dim + l] = a_all / fmaxf(s_all, 1e-12f);
    if (l == 0) {
      m_out[o] = m_all;
      s_out[o] = s_all;
    }
  }
}

// Raises the row kernel's shared memory limit to its size at K = kMaxK,
// once per width and device.
template <int L>
cudaError_t row_kernel_ready() {
  static SmemLimit limit;
  return raise_smem(b1_row_kernel<L>, row_smem_bytes(kMaxK), limit);
}

struct Args {
  const void* feats; const uint8_t* mask;
  const float *w1, *w1t, *b1, *v, *bv, *u, *bu, *w, *bw;
  float *logits, *bag, *m_out, *s_out, *norms, *hg;
  int2* near; int* near_counts;
  float *part_m, *part_s, *part_acc;
  int batch, n, df, k_br, l_dim;
  cudaStream_t stream;
};

template <int L>
cudaError_t launch_rows(const Args& a) {
  const cudaError_t err = row_kernel_ready<L>();
  if (err != cudaSuccess) return err;
  const int blocks = a.batch * ((a.n + kTile - 1) / kTile);   // one a tile
  b1_row_kernel<L><<<blocks, kThreads, row_smem_bytes(a.k_br), a.stream>>>(
      a.hg, a.mask, a.v, a.bv, a.u, a.bu, a.w, a.bw, a.logits, a.part_m,
      a.part_s, a.part_acc, a.batch, a.n, a.k_br);
  return cudaGetLastError();
}

// F(L) for the widths the kernel is instantiated at, else `otherwise`.
#define B1_WIDTHS(F, otherwise) \
  switch (l_dim) {              \
    case 128: return F(128);    \
    case 256: return F(256);    \
    case 384: return F(384);    \
    case 512: return F(512);    \
    case 768: return F(768);    \
    default: return otherwise;  \
  }

template <typename T>
cudaError_t launch(const Args& a) {
  const int l_dim = a.l_dim;
  cudaError_t err = launch_h_stage<T, false>(
      static_cast<const T*>(a.feats), a.w1, a.w1t, a.b1, a.norms, nullptr,
      a.hg, a.near, a.near_counts, nullptr, a.batch * a.n, a.n, a.df, l_dim,
      a.k_br, a.stream);
  if (err != cudaSuccess) return err;
#define B1_ROWS(LL) launch_rows<LL>(a)
  err = [&]() -> cudaError_t { B1_WIDTHS(B1_ROWS, cudaErrorInvalidValue) }();
#undef B1_ROWS
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + kTile - 1) / kTile;
  b1_merge_kernel<<<dim3(a.k_br, a.batch, l_dim / kMergeCols), kMergeThreads,
                    0, a.stream>>>(
      a.part_m, a.part_s, a.part_acc, a.bag, a.m_out, a.s_out, tiles, a.k_br,
      l_dim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches kernel B1 (the H stage, the row kernel and the merge) on
// `stream`. All pointers are device pointers to contiguous, 16-byte-aligned
// buffers; `feats_half` selects fp16 (1) or f32 (0) features; w1t is W1
// transposed ([L, Df]). The caller allocates the outputs logits [B, K, N],
// bag [B, K, L], m_out and s_out [B, K], and the workspace: norms (M + L
// floats, M = batch x n), hg (M x L floats), near (T x 512 int2) and
// near_counts (T ints), T = ceil(M / 128) L / 128, part_m and part_s
// ([B, T', K] floats) and part_acc ([B, T', K, L] floats), T' = ceil(n /
// 64). Returns the cudaError_t of the launches (cudaErrorInvalidValue for
// an L the kernel does not take).
int b1_attn_pool_forward(const void* feats, int feats_half, const void* mask,
                         const float* w1, const float* w1t, const float* b1,
                         const float* v, const float* bv, const float* u,
                         const float* bu, const float* w, const float* bw,
                         float* logits, float* bag, float* m_out,
                         float* s_out, float* norms, float* hg, void* near,
                         int* near_counts, float* part_m, float* part_s,
                         float* part_acc, int batch, int n, int df, int k_br,
                         int l_dim, void* stream) {
  const Args a{feats, static_cast<const uint8_t*>(mask), w1, w1t, b1, v, bv,
               u, bu, w, bw, logits, bag, m_out, s_out, norms, hg,
               static_cast<int2*>(near), near_counts, part_m, part_s,
               part_acc, batch, n, df, k_br, l_dim,
               static_cast<cudaStream_t>(stream)};
#define B1_KNOWN(LL) cudaSuccess
  const cudaError_t known = [&]() -> cudaError_t {
    B1_WIDTHS(B1_KNOWN, cudaErrorInvalidValue)
  }();
#undef B1_KNOWN
  if (known != cudaSuccess) return static_cast<int>(known);
  return static_cast<int>(feats_half ? launch<__half>(a) : launch<float>(a));
}

}  // extern "C"
