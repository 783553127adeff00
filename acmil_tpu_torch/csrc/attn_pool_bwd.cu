// Kernel B2: fused gated-attention pooling, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acmil_tpu/ops/attn_pool.py::_bwd_kernel,
// which _fused_pool_bwd_stats launches. Given the forward's inputs, the
// per-(bag, branch) softmax couplings lse [B, K] and c = sum_l d_bag * bag
// [B, K], and the cotangents d_bag [B, K, L] and d_logits [B, K, N], it
// computes, for every row:
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
// Design. The TPU kernel walks every (bag, chunk) in order on one core,
// recomputes h and the gates per chunk and carries the gradient
// accumulators in VMEM, so that no [N, L] intermediate leaves the chip. On
// the H100 blocks run in parallel and nothing carries over, and a block's
// shared memory cannot hold dW1 (Df x L x 4 bytes: 4.7 MB at 1536 x 768)
// beside its tiles. So B2 here writes its intermediates to device memory
// (M = B N rows) and runs as matrix products over them:
//
//   gated_h_norms_kernel  |x| of every row and |W1| of every column
//   K1 gated_h_kernel     H = relu(X W1 + b1)          [M, Df] [Df, L],
//                         and each 128-column panel's part of H d_bag^T
//   gated_h_fix_kernel    K1's near-0 elements (below)
//   K2 b2_row_kernel    per 64-row tile: Z = H [V | U] [L, 2A], the gates,
//                       p, d_log (d_p from K1's parts), d_av and d_au;
//                       D_a = [d_av | d_au | p] [M, 2A + K];
//                       R = [H > 0] ([d_av | d_au | p] [V | U | d_bag^T]^T)
//                       [M, L], in panels of 128 columns; db1, dbv, dbu,
//                       dw and dbw as per-block partials
//   K3 b2_wgrad_kernel  dW1 = X^T R and [dV | dU] = H^T D_a, each over S
//                       contiguous ranges of rows into S partials
//   b2_reduce_kernel    sums the partials of K3 and of K2, each in order
//   K4 b2_dx_kernel     dx = R W1^T in x's dtype (only when asked)
//
// Every product of more than K terms is a split-TF32 product on the tensor
// cores (tf32x3.cuh: mma.sync m16n8k8, hi/lo operands, f32 accumulation;
// two MMAs per product with fp16 x, which is exact in TF32, three
// otherwise), fed by a 3-stage cp.async ring of 32-deep slices: 128 x 128
// output tiles in K1, K3 and K4, 64 x 128 (each half of Z, and each panel
// of d_h) in K2; 8 warps a block. K3 sums each slice apart (tf32x3's
// kFlush), since the MMA's accumulation drifts over its long sums
// (thousands of rows).
//
// The relu mask. r is discontinuous in h: where h is within rounding of 0,
// two ways of summing x W1 can give the mask opposite signs, and the row's
// whole d_h then enters dW1 or not. The norms, K1 and its recompute are
// the H stage of gated_h.cuh, which kernel B1 runs too: B1's h and B2's H
// are the same bits, and every near-0 pre-activation is summed in the
// forward's order (gated_h.cuh says how).
//
// Bounds. At Df = 384, L = A = 128, N = 65536, without dx, B2 does about
// 25 GFLOP (x W1 and x^T R half of it, 80% at Df = 1536, L = 768) and
// moves 50 MB of fp16 features plus its intermediates (H, R: M L f32 each,
// written once and read twice; D_a: M 2A f32): about 0.3 GB at L = 128,
// 1.3 GB at L = 768, under 0.4 ms of HBM time. So it is bound by the
// tensor cores' TF32 rate, at two or three MMAs a product.
//
// Determinism: no float atomics; every sum runs in a fixed order (within a
// tile by the MMA's fixed order, across tiles and ranges by the reduce), so
// two launches on the same inputs give the same bits.
//
// Features are read as fp16 or f32; dx is written in the features' dtype;
// every weight gradient is f32. Widths taken: L in {128, 256, 384, 512, 768}
// (one instantiation of K2 each), A = 128, Df a multiple of 32, 1 <= K <=
// 128. The Python wrapper (acmil_tpu_torch/ops/attn_pool.py) checks them,
// sizes the intermediates and S, and raises on anything else.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_h.cuh"
#include "tf32x3.cuh"

namespace {

// the H stage's widths, tiles, slices and stages (gated_h.cuh): K1, K3 and
// K4 run 128 x 128 output tiles of 32-deep slices, warps 2 x 4 (64 x 32
// each), 3 stages
using namespace gated_h;
constexpr int kDa = 2 * kA;        // columns of D_a = [d_av | d_au], of [V | U]
constexpr int kReduceThreads = 256;

// K3: A(m = d, k = row) = x[row][d], B(k = row, n = l) = R[row][l]
template <typename T>
using GemmXtR = Gemm<Op<T, false, kBM>, Op<float, false, kBN>>;
// K3: A(m = l, k = row) = H[row][l], B(k = row, n = a) = D_a[row][a]
using GemmHtD = Gemm<Op<float, false, kBM>, Op<float, false, kBN>>;
// K4: A = R (row, l), B(k = l, n = d) = W1[d][l]
using GemmDx = Gemm<Op<float, true, kBM>, Op<float, true, kBN>>;

// K2: 64-row tiles, warps 2 x 4; its products share K1's slices and stages
constexpr int kTile = 64, kPanel = 128;
// Z = H [V | U], one half (V or U) at a time: A = H (row, l), B(k = l, n = a)
// = VU[l][half A + a]
using GemmZ = tf32x3::BlockGemm<Op<float, true, kTile>, Op<float, false, kA>,
                                kTile, kA, kBK, 2, 4, kStages>;
// d_h = [D_a | p] [[V | U]^T ; d_bag] over a panel of 128 columns:
// A = D_a's row (its last columns hold p), B(k = c, n = l) = VU[l][c] for
// c < 2A, d_bag^T[l][c - 2A] after
using GemmDh = tf32x3::BlockGemm<Op<float, true, kTile>,
                                 Op<float, true, kPanel>, kTile, kPanel, kBK,
                                 2, 4, kStages>;
constexpr int kZStride = kDa + 4;     // rows of Z, g, D_a in shared memory
constexpr int kRStride = kPanel + 4;  // rows of an R panel in shared memory

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int k) { return (k + 3) / 4 * 4; }
// bytes of K2's GEMM ring; an R panel aliases it
constexpr int kRowRing = cmax(cmax(GemmZ::kSmemBytes, GemmDh::kSmemBytes),
                              kTile * kRStride * 4);

// A block's private partial: the first tile stores, later ones add.
__device__ __forceinline__ void accumulate(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// sum over the tile's rows of p[row * kStride], as four chains in order
template <int kStride>
__device__ __forceinline__ float column_sum(const float* p) {
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int row = 0; row < kTile; row += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) s4[i] += p[(row + i) * kStride];
  return (s4[0] + s4[1]) + (s4[2] + s4[3]);
}

__device__ __forceinline__ bool row_valid(const uint8_t* mask_b, int row,
                                          int n) {
  return row < n && mask_b[row] != 0;
}

// bytes of K2's shared memory: the GEMM ring, Z/g/D_a and p, d_log
size_t row_smem_bytes(int k_br) {
  return kRowRing + sizeof(float) * (kTile * kZStride + 2 * k_br * kTile);
}

// floats of K3's partial: [dW1 (Df x L) | dV (L x A) | dU (L x A)]
__host__ __device__ size_t wgrad_floats(int df, int l_dim) {
  return static_cast<size_t>(df) * l_dim + 2 * static_cast<size_t>(l_dim) * kA;
}

// floats of K2's partial: [db1 (L) | dbv (A) | dbu (A) | dw (A x K) | dbw (K)]
__host__ __device__ int row_floats(int l_dim, int k_br) {
  return l_dim + 2 * kA + kA * k_br + k_br;
}

// ---- K2: the row kernel --------------------------------------------------
// Block g walks the (bag, 64-row tile) pairs g, g + G, ...; for each tile it
// reads H, writes D_a and R, and accumulates db1, dbv, dbu, dw and dbw into
// part[g] (row_floats floats). Thread (warp ty, lane tx) owns rows 8 ty..
// and columns tx + 32 j of the A-wide elementwise steps.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
b2_row_kernel(const float* __restrict__ hg,        // [B, N, L]
              const uint8_t* __restrict__ mask,    // [B, N]
              const float* __restrict__ vu,        // [L, 2A]: [V | U]
              const float* __restrict__ bv,        // [A]
              const float* __restrict__ bu,        // [A]
              const float* __restrict__ w,         // [A, K]
              const float* __restrict__ bw,        // [K]
              const float* __restrict__ lse,       // [B, K]
              const float* __restrict__ cc,        // [B, K]
              const float* __restrict__ dbag,      // [B, K, L]
              const float* __restrict__ dbag_t,    // [B, L, Kp]: d_bag^T
              const float* __restrict__ dlo,       // [B, K, N]
              const float* __restrict__ dp_part,   // [L / 128, B N, K]
              float* __restrict__ rg,              // [B, N, L]
              float* __restrict__ da,              // [B, N, 2A + Kp]: D_a | p
              float* __restrict__ part,            // [G, row_floats]
              int batch, int n, int k_br) {
  const int da_ld = kDa + round4(k_br);
  constexpr int kRows = kTile / kWarps;  // rows a thread owns
  extern __shared__ __align__(16) char smem[];
  char* ring = smem;                                       // GEMM slices
  float* rs = reinterpret_cast<float*>(smem);              // [kTile][kRStride], in the ring
  float* zs = reinterpret_cast<float*>(smem + kRowRing);   // [kTile][kZStride]
  float* ps = zs + kTile * kZStride;                       // [K][kTile]: p
  float* dls = ps + k_br * kTile;                          // [K][kTile]: d_log

  const int tid = threadIdx.x;
  const int tx = tid & 31;             // lane
  const int ty = tid >> 5;             // warp
  const int tiles_per_bag = (n + kTile - 1) / kTile;
  const int total = batch * tiles_per_bag;

  float* g_db1 = part + static_cast<size_t>(blockIdx.x) * row_floats(L, k_br);
  float* g_dbv = g_db1 + L;
  float* g_dbu = g_dbv + kA;
  float* g_dw = g_dbu + kA;
  float* g_dbw = g_dw + kA * k_br;

  // this thread's columns of dbv | dbu and of db1, summed over the block's
  // tiles in registers and stored once
  float sum_da = 0.f, sum_r[L / kPanel];
#pragma unroll
  for (int q = 0; q < L / kPanel; ++q) sum_r[q] = 0.f;
  bool first = true;
  for (int t = blockIdx.x; t < total; t += gridDim.x, first = false) {
    const int b = t / tiles_per_bag;
    const int n0 = (t - b * tiles_per_bag) * kTile;
    const int rows = min(kTile, n - n0);                  // rows of this bag
    const size_t row0 = static_cast<size_t>(b) * n + n0;  // of [M, *]
    const float* hb = hg + row0 * L;
    const uint8_t* mask_b = mask + static_cast<size_t>(b) * n;
    const float* lse_b = lse + static_cast<size_t>(b) * k_br;
    const float* cc_b = cc + static_cast<size_t>(b) * k_br;
    const float* dbag_b = dbag + static_cast<size_t>(b) * k_br * L;
    const float* dlo_b = dlo + static_cast<size_t>(b) * k_br * n;
    const float* dbag_tb = dbag_t + static_cast<size_t>(b) * L * (da_ld - kDa);

    // ---- Z = H [V | U] + [bv | bu]; rows past N (the next bag's) are 0 ----
    for (int half = 0; half < 2; ++half) {
      const float* bias = half ? bu : bv;
      float acc[GemmZ::kMT][GemmZ::kNT][4];
      GemmZ::zero(acc);
      GemmZ::run(acc, {hb, L, rows, L}, {vu + half * kA, kDa, kA, L}, 0, 0, 0,
                 L, ring);
      GemmZ::for_pairs(acc, 0, 0, [&](int r, int c, float v0, float v1) {
        store2(zs + r * kZStride + half * kA + c, v0 + bias[c], v1 + bias[c + 1]);
      });
    }
    __syncthreads();
    float gv[kRows][4], gu[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* z = zs + (ty * kRows + i) * kZStride + tx + 32 * j;
        gv[i][j] = tanhf(z[0]);
        gu[i][j] = 1.f / (1.f + expf(-z[kA]));
      }
    __syncthreads();  // Z has been read
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        zs[(ty * kRows + i) * kZStride + tx + 32 * j] = gv[i][j] * gu[i][j];
    __syncthreads();

    // ---- p and d_log per (row, branch), one thread each -------------------
    for (int idx = tid; idx < kTile * k_br; idx += kThreads) {
      const int row = idx / k_br, kb = idx % k_br;
      float p = 0.f, dl = 0.f;
      if (row_valid(mask_b, n0 + row, n)) {  // masked rows ignore d_logits
        float d_p = 0.f;   // K1's panels' parts, in order
        for (int q = 0; q < L / kBN; ++q)
          d_p += dp_part[(static_cast<size_t>(q) * batch * n + row0 + row) * k_br + kb];
        const float* g = zs + row * kZStride;
        float d4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, summed in order
#pragma unroll 8
        for (int a = 0; a < kA; a += 4)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            d4[i] = fmaf(g[a + i], __ldg(w + (a + i) * k_br + kb), d4[i]);
        const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
        p = expf(dot + bw[kb] - lse_b[kb]);
        dl = fmaf(p, d_p - cc_b[kb],
                  dlo_b[static_cast<size_t>(kb) * n + n0 + row]);
      }
      ps[kb * kTile + row] = p;
      dls[kb * kTile + row] = dl;
    }
    __syncthreads();

    // ---- dw = g^T d_log, dbw = sum d_log ----------------------------------
    for (int idx = tid; idx < kA * k_br; idx += kThreads) {
      const int a = idx % kA;
      const int kb = idx / kA;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int row = 0; row < kTile; row += 4)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s4[i] = fmaf(zs[(row + i) * kZStride + a], dls[kb * kTile + row + i], s4[i]);
      accumulate(g_dw + a * k_br + kb, (s4[0] + s4[1]) + (s4[2] + s4[3]), first);
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
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* z = zs + (ty * kRows + i) * kZStride + tx + 32 * j;
        z[0] = gv[i][j];
        z[kA] = gu[i][j];
      }
    __syncthreads();

    // ---- D_a rows to device memory; dbv = sum d_av, dbu = sum d_au --------
    for (int q = tid; q < kTile * kDa / 4; q += kThreads) {
      const int row = q / (kDa / 4);
      const int c4 = (q % (kDa / 4)) * 4;
      if (row < rows)
        *reinterpret_cast<float4*>(da + (row0 + row) * da_ld + c4) =
            *reinterpret_cast<const float4*>(zs + row * kZStride + c4);
    }
    // p after D_a, and 0 in the pad columns (the d_h product reads whole
    // 16-byte chunks)
    for (int q = tid; q < kTile * (da_ld - kDa); q += kThreads) {
      const int row = q % kTile, kb = q / kTile;
      if (row < rows)
        da[(row0 + row) * da_ld + kDa + kb] = kb < k_br ? ps[kb * kTile + row] : 0.f;
    }
    sum_da += column_sum<kZStride>(zs + tid);
    __syncthreads();  // D_a is in device memory for the d_h product

    // ---- r = [h > 0] (D_a [V | U]^T + p d_bag), 128 columns at a time -----
#pragma unroll 1
    for (int lp = 0; lp < L; lp += kPanel) {
      float acc[GemmDh::kMT][GemmDh::kNT][4];
      GemmDh::zero(acc);
      GemmDh::run(acc, {da + row0 * da_ld, da_ld, rows, kDa + k_br},
                  {vu, kDa, L, kDa + k_br, dbag_tb, da_ld - kDa, kDa},
                  0, lp, 0, kDa + k_br, ring);
      GemmDh::for_pairs(acc, 0, lp, [&](int r, int c, float v0, float v1) {
        store2(rs + r * kRStride + c - lp, v0, v1);
      });
      __syncthreads();
      for (int q = tid; q < kTile * kPanel / 4; q += kThreads) {
        const int row = q / (kPanel / 4);
        const int c4 = (q % (kPanel / 4)) * 4;
        float4* rp = reinterpret_cast<float4*>(rs + row * kRStride + c4);
        float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < rows) {
          const float4 h4 = __ldg(reinterpret_cast<const float4*>(
              hb + static_cast<size_t>(row) * L + lp + c4));
          const float4 d4 = *rp;
          r4 = make_float4(h4.x > 0.f ? d4.x : 0.f, h4.y > 0.f ? d4.y : 0.f,
                           h4.z > 0.f ? d4.z : 0.f, h4.w > 0.f ? d4.w : 0.f);
          *reinterpret_cast<float4*>(rg + (row0 + row) * L + lp + c4) = r4;
        }
        *rp = r4;
      }
      __syncthreads();
      if (tid < kPanel) {
        const float s = column_sum<kRStride>(rs + tid);
#pragma unroll
        for (int q = 0; q < L / kPanel; ++q)  // a register index known here
          if (q == lp / kPanel) sum_r[q] += s;
      }
      __syncthreads();  // the panel (in the ring) has been read
    }
  }
  (tid < kA ? g_dbv : g_dbu)[tid % kA] = sum_da;
  if (tid < kPanel) {
#pragma unroll
    for (int q = 0; q < L / kPanel; ++q) g_db1[q * kPanel + tid] = sum_r[q];
  }
}

// ---- K3: dW1 = x^T R and [dV | dU] = H^T D_a over one range of rows -------
// blockIdx.x walks the output tiles (those of dW1, then those of [dV | dU]),
// blockIdx.y the S ranges of `rows` rows; range s writes part[s]
// (wgrad_floats floats).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
b2_wgrad_kernel(const T* __restrict__ x, const float* __restrict__ hg,
                const float* __restrict__ rg, const float* __restrict__ da,
                float* __restrict__ part, int m, int df, int l_dim, int da_ld,
                int rows) {
  extern __shared__ __align__(16) char smem[];
  const int k0 = blockIdx.y * rows;
  const int k1 = min(m, k0 + rows);
  float* out = part + blockIdx.y * wgrad_floats(df, l_dim);
  const int l_tiles = l_dim / kBN;
  const int w1_tiles = (df + kBM - 1) / kBM * l_tiles;
  int t = blockIdx.x;
  if (t < w1_tiles) {
    using G = GemmXtR<T>;
    const int m0 = (t / l_tiles) * kBM, n0 = (t % l_tiles) * kBN;
    float acc[G::kMT][G::kNT][4];
    G::zero(acc);
    G::template run<true>(acc, {x, df, df, k1}, {rg, l_dim, l_dim, k1}, m0, n0,
                          k0, k1, smem);
    G::for_pairs(acc, m0, n0, [&](int r, int c, float v0, float v1) {
      if (r < df) store2(out + static_cast<size_t>(r) * l_dim + c, v0, v1);
    });
  } else {
    t -= w1_tiles;
    using G = GemmHtD;
    const int m0 = (t / 2) * kBM, n0 = (t % 2) * kBN;   // n0 = 0: dV, kA: dU
    float* dst = out + static_cast<size_t>(df) * l_dim +
                 (t % 2) * static_cast<size_t>(l_dim) * kA;
    float acc[G::kMT][G::kNT][4];
    G::zero(acc);
    G::template run<true>(acc, {hg, l_dim, l_dim, k1}, {da, da_ld, kDa, k1}, m0,
                          n0, k0, k1, smem);
    G::for_pairs(acc, m0, n0, [&](int r, int c, float v0, float v1) {
      store2(dst + static_cast<size_t>(r) * kA + c - n0, v0, v1);
    });
  }
}

// ---- K4: dx = R W1^T in x's dtype ------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
b2_dx_kernel(const float* __restrict__ rg, const float* __restrict__ w1,
             T* __restrict__ dx, int m, int df, int l_dim) {
  extern __shared__ __align__(16) char smem[];
  using G = GemmDx;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[G::kMT][G::kNT][4];
  G::zero(acc);
  G::run(acc, {rg, l_dim, m, l_dim}, {w1, l_dim, df, l_dim}, m0, n0, 0,
         l_dim, smem);
  G::for_pairs(acc, m0, n0, [&](int r, int c, float v0, float v1) {
    if (r < m && c < df) store2(dx + static_cast<size_t>(r) * df + c, v0, v1);
  });
}

// out[i] = sum over g = 0..G-1 of work[g][i], in that order, for K3's
// partials (out[0, nw)) and then K2's (out[nw, nw + nr)).
__global__ void __launch_bounds__(kReduceThreads)
b2_reduce_kernel(const float* __restrict__ work_w, int groups_w, size_t nw,
                 const float* __restrict__ work_r, int groups_r, size_t nr,
                 float* __restrict__ out) {
  size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const float* work = work_w;
  int groups = groups_w;
  size_t slice = nw;
  if (i >= nw) {
    i -= nw;
    work = work_r;
    groups = groups_r;
    slice = nr;
    out += nw;
    if (i >= nr) return;
  }
  float s = 0.f;
#pragma unroll 16
  for (int g = 0; g < groups; ++g) s += work[static_cast<size_t>(g) * slice + i];
  out[i] = s;
}

// Raises the row kernel's shared memory limit to its size at K = kMaxK,
// once per width and device.
template <int L>
cudaError_t row_kernel_ready() {
  static SmemLimit limit;
  return raise_smem(b2_row_kernel<L>, row_smem_bytes(kMaxK), limit);
}

// Blocks of the row kernel the current device holds at once, or minus a
// cudaError_t.
template <int L>
int row_blocks(int k_br) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = row_kernel_ready<L>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, b2_row_kernel<L>, kThreads, row_smem_bytes(k_br));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

struct Args {
  const void* feats; const uint8_t* mask;
  const float *w1, *w1t, *b1, *vu, *bv, *bu, *w, *bw, *lse, *cc, *dbag,
      *dbag_t, *dlo;
  void* dx; float *norms, *hg; int2* near; int* near_counts;
  float *dp_part, *rg, *da, *part_w, *part_r, *grads;
  int batch, n, df, k_br, l_dim, groups, splits, rows;
  cudaStream_t stream;
};

template <int L>
cudaError_t launch_rows(const Args& a) {
  const cudaError_t err = row_kernel_ready<L>();
  if (err != cudaSuccess) return err;
  b2_row_kernel<L><<<a.groups, kThreads, row_smem_bytes(a.k_br), a.stream>>>(
      a.hg, a.mask, a.vu, a.bv, a.bu, a.w, a.bw, a.lse, a.cc, a.dbag,
      a.dbag_t, a.dlo, a.dp_part, a.rg, a.da, a.part_r, a.batch, a.n,
      a.k_br);
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
cudaError_t launch(const Args& a) {
  const int m = a.batch * a.n, l_dim = a.l_dim;
  const int m_tiles = (m + kBM - 1) / kBM;
  const T* x = static_cast<const T*>(a.feats);
  // the norms, K1 with its d_p epilogue, and K1's recompute
  cudaError_t err = launch_h_stage<T, true>(
      x, a.w1, a.w1t, a.b1, a.norms, a.dbag, a.hg, a.near, a.near_counts,
      a.dp_part, m, a.n, a.df, l_dim, a.k_br, a.stream);
  if (err != cudaSuccess) return err;
  // K2
#define B2_ROWS(LL) launch_rows<LL>(a)
  err = [&]() -> cudaError_t { B2_WIDTHS(B2_ROWS, cudaErrorInvalidValue) }();
#undef B2_ROWS
  if (err != cudaSuccess) return err;
  // K3 and the two reductions
  constexpr int kWSmem = cmax(GemmXtR<T>::kSmemBytes, GemmHtD::kSmemBytes);
  static SmemLimit wgrad_limit;
  if ((err = raise_smem(b2_wgrad_kernel<T>, kWSmem, wgrad_limit)) != cudaSuccess)
    return err;
  const int tiles = (a.df + kBM - 1) / kBM * (l_dim / kBN) + (l_dim / kBM) * 2;
  b2_wgrad_kernel<T><<<dim3(tiles, a.splits), kThreads, kWSmem, a.stream>>>(
      x, a.hg, a.rg, a.da, a.part_w, m, a.df, l_dim, kDa + round4(a.k_br),
      a.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t nw = wgrad_floats(a.df, l_dim), nr = row_floats(l_dim, a.k_br);
  b2_reduce_kernel<<<static_cast<unsigned>((nw + nr + kReduceThreads - 1) /
                                           kReduceThreads),
                     kReduceThreads, 0, a.stream>>>(
      a.part_w, a.splits, nw, a.part_r, a.groups, nr, a.grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // K4
  if (a.dx != nullptr) {
    static SmemLimit dx_limit;
    if ((err = raise_smem(b2_dx_kernel<T>, GemmDx::kSmemBytes, dx_limit)) !=
        cudaSuccess)
      return err;
    b2_dx_kernel<T><<<dim3(m_tiles, (a.df + kBN - 1) / kBN), kThreads,
                      GemmDx::kSmemBytes, a.stream>>>(
        a.rg, a.w1, static_cast<T*>(a.dx), m, a.df, l_dim);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// Rows per tile of the row kernel at this L (0 for an L B2 does not take).
int b2_tile_rows(int l_dim) {
#define B2_TILE(LL) kTile
  B2_WIDTHS(B2_TILE, 0)
#undef B2_TILE
}

// The most blocks (G) the row kernel should use on the current device for
// this K and L, or minus a cudaError_t. The caller passes G = min(this,
// number of tiles) and a partial of G x (L + 2A + A K + K) floats.
int b2_max_blocks(int k_br, int l_dim) {
#define B2_BLOCKS(LL) row_blocks<LL>(k_br)
  B2_WIDTHS(B2_BLOCKS, -static_cast<int>(cudaErrorInvalidValue))
#undef B2_BLOCKS
}

// Launches kernel B2 (the norms, K1, K2, K3, the two reductions, and K4 when
// dx is not null) on `stream`. All pointers are device pointers to
// contiguous, 16-byte-aligned buffers; `feats_half` selects fp16 (1) or f32
// (0) features (and dx); w1t is W1 transposed ([L, Df]); vu is [V | U] as
// one [L, 2A] matrix, dbag_t is
// d_bag transposed to [B, L, Kp] with Kp = K rounded up to a multiple of 4
// and zeros past K. The caller allocates norms (M + L floats, M = batch x
// n), the intermediates h and r (M x L floats), near (T x 512 int2) and
// near_counts (T ints), T = ceil(M / 128) L / 128, dp_part (L / 128 x M x K),
// da (M x (2A + Kp)),
// part_w (splits x (Df L + 2 L A); range s
// covers rows [s rows, (s + 1) rows) of M, rows a multiple of 32) and
// part_r (groups x (L + 2A + A K + K)). `grads` receives, in order, dW1
// (Df x L), dV (L x A), dU (L x A), db1 (L), dbv (A), dbu (A), dw (A x K)
// and dbw (K). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for an L B2 does not take).
int b2_attn_pool_backward(const void* feats, int feats_half, const void* mask,
                          const float* w1, const float* w1t, const float* b1,
                          const float* vu,
                          const float* bv, const float* bu, const float* w,
                          const float* bw, const float* lse, const float* cc,
                          const float* dbag, const float* dbag_t,
                          const float* dlo, void* dx, float* norms,
                          float* hg, void* near, int* near_counts,
                          float* dp_part, float* rg, float* da,
                          float* part_w, float* part_r, float* grads,
                          int batch, int n, int df, int k_br, int l_dim,
                          int groups, int splits, int rows, void* stream) {
  const Args a{feats, static_cast<const uint8_t*>(mask), w1, w1t, b1, vu,
               bv, bu, w, bw, lse, cc, dbag, dbag_t, dlo, dx, norms, hg,
               static_cast<int2*>(near), near_counts, dp_part, rg, da,
               part_w,
               part_r, grads, batch, n, df, k_br, l_dim, groups, splits, rows,
               static_cast<cudaStream_t>(stream)};
  if (b2_tile_rows(l_dim) == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(feats_half ? launch<__half>(a) : launch<float>(a));
}

}  // extern "C"
