// Kernels B5' and B7 at float32 for Hopper (sm_90a): multi-head attention
// in one pass over the keys, its products in split-TF32 ("3xTF32") on the
// tensor cores.
//
// It replaces, at float32 and head widths 16, 32, 64 and 128 with rows
// 16-byte aligned,
//   acmil_tpu/ops/vit_attn.py::_mha_kernel (fused_vit_attention) and
//   acmil_tpu/ops/vit_attn_packed.py::_packed_kernel (fused_mha_packed).
// Per image b and head h both compute
//
//   o = softmax(q k^T * scale) v
//
// with the scores and the softmax in f32, keys past n masked before the
// max and value rows past n zero. The Pallas kernels round p to q's dtype
// after the normalisation, which at float32 is no rounding at all, so an
// online softmax in one pass (a running max and sum per row, the
// accumulator rescaled as the max grows, one division at the end) is the
// same function. csrc/vit_attn_generic.cu (B7's fma route) keeps two
// passes for the dtypes whose p is rounded; this route is float32 only.
//
// Operands are read through strides: element (b, h, t, d) of an operand
// lies at base + b*sb + h*sh + t*st + d, so strided views of a packed qkv
// and a token-major output buffer need no copy. Every stride must be a
// multiple of 4 floats and every base 16-byte aligned: rows are staged by
// 16-byte cp.async copies.
//
// Products. Each operand (q, k, p, v) is split into hi = tf32(a) and lo =
// tf32(a - hi) (csrc/tf32x3.cuh's split), and each product is lo hi + hi lo
// + hi hi (the small terms first) on mma.sync.m16n8k8 TF32 with f32 sums.
// q, k and v are split once, as a tile lands in shared memory: a cp.async
// copy brings the raw rows, then the block writes their hi and lo arrays,
// which every warp reads. The tensor cores' f32 accumulation drifts over
// long sums (tf32x3.cuh's kFlush), so each 8-deep step of a product (8
// terms of a score's d, 8 keys of p v) is summed in fresh registers and
// added to its sum in f32. That also leaves the three products of a step
// the only chain of dependent MMAs: a warp has many steps in flight.
//
// Order of the k slots. The m16n8k8 product reads A's k slots t and t + 4
// from a thread (t = lane % 4) and holds C's columns 2t and 2t + 1. Slot t
// is given column 2t and slot t + 4 column 2t + 1 of each 8-wide step, for
// the scores' d and for p v's keys alike: a sum does not depend on its
// order. So a thread's scores are already p's A fragment (no shuffle), and
// with q and v stored as interleaved pairs of rows (Layout) each fragment
// is one shared-memory load in operand order.
//
// Bounds on the H100 (3.35 TB/s, 495 TFLOP/s TF32 dense). At B5''s f32
// ViT-S/16 shape (B = 256, 6 heads of 64, N = 197) the two products are
// 15.3 GFLOP, 45.8 GFLOP of TF32 products at three each: 0.0925 ms; q, k,
// v and o are 310 MB: 0.0925 ms as well. The two bounds tie.
//
// Design: one block of 8 warps per (128-query tile, head, image), each
// warp 16 query rows; keys and values in 16-key tiles through a ring of
// two raw stages, each tile's copy issued two tiles ahead of its use. A
// warp whose rows all lie past n takes part in the copies and splits but
// skips its products, and 8-key steps past n are skipped. Shared memory at
// dh = 64 is 108.0 KB a block (q's hi and lo 73.7 KB): two blocks, 16
// warps, an SM. The kernel is bound by the mma.sync TF32 rate, not by its
// other instructions: with one product of three it runs in ~60% of the
// time (PERF.md); wgmma is the way past that.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kQ = 128;         // queries a block
constexpr int kK = 16;          // keys a tile
constexpr int kThreads = 256;   // 8 warps of 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kQ == 16 * (kThreads / 32), "16 query rows a warp");

// One operand, read through its strides in elements.
template <typename P>
struct Strided {
  P* base;
  long long sb, sh, st;
};

// Shared memory of one block, in 4-byte words: hi and lo of the query tile
// and of one key and value tile, then the raw staging ring. The query
// tile's raw rows are staged once over the key and value tiles and the
// ring, before either is used.
template <int DH>
struct Layout {
  // k rows: the 8-byte pairs of a warp's fragment loads (row g, columns
  // 2t, 2t + 1) fall on distinct banks with a row stride of 8 mod 32 words
  static constexpr int kKld = DH + 8;
  // q and v as pairs of rows, interleaved: the pair (r, r + gap) at a
  // stride of kQPair or kVPair words, its element (r + i gap, d) at word 2d
  // + i. q pairs rows g and g + 8 of a warp's 16 (gap 8), so a thread's A
  // fragment (rows g, g + 8 at columns 2t, 2t + 1) is one 16-byte load in
  // operand order; v pairs rows 2t and 2t + 1 (gap 1), so a B fragment is
  // one 8-byte load. The strides keep the loads of a quarter warp (q: 16
  // mod 32 words) and of a half warp (v: 8 mod 32) on distinct banks
  static constexpr int kQPair = 2 * DH + 16;
  static constexpr int kVPair = 2 * DH + 8;
  static constexpr int kQElems = kQ / 2 * kQPair;
  static constexpr int kKElems = kK * kKld;
  static constexpr int kVElems = kK / 2 * kVPair;
  // the raw ring: two stages of a key and a value tile
  static constexpr int kRawElems = 2 * 2 * kK * DH;
  static constexpr int kSmemBytes =
      4 * (2 * kQElems + 2 * kKElems + 2 * kVElems + kRawElems);
  static_assert(kQ * DH <= 2 * kKElems + 2 * kVElems + kRawElems,
                "the query tile's raw rows fit past its hi and lo");
};

// rows [row0, row0 + kRows) of one head's operand into raw[kRows][DH] by
// 16-byte copies (not waited for); rows past n are zero
template <int DH, int kRows>
__device__ __forceinline__ void stage(float* raw, const float* src,
                                      long long st, int row0, int n) {
  constexpr int kPerRow = DH / 4;
  constexpr int kChunks = kRows * kPerRow;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kChunks % kThreads != 0 && c >= kChunks) break;
    const int r = c / kPerRow, col = (c % kPerRow) * 4;
    const int row = row0 + r;
    const bool ok = row < n;
    tf32x3::cp16(raw + r * DH + col, ok ? src + row * st + col : src, ok);
  }
}

// raw[kRows][DH] -> hi[kRows][ld], lo[kRows][ld]: each element split once
template <int DH, int kRows>
__device__ __forceinline__ void split_rows(const float* raw, uint32_t* hi,
                                           uint32_t* lo, int ld) {
  constexpr int kPerRow = DH / 4;
  constexpr int kChunks = kRows * kPerRow;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kChunks % kThreads != 0 && c >= kChunks) break;
    const int r = c / kPerRow, col = (c % kPerRow) * 4;
    const float4 a = *reinterpret_cast<const float4*>(raw + r * DH + col);
    uint4 h, l;
    tf32x3::split<0>(a.x, h.x, l.x);
    tf32x3::split<0>(a.y, h.y, l.y);
    tf32x3::split<0>(a.z, h.z, l.z);
    tf32x3::split<0>(a.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * ld + col) = h;
    *reinterpret_cast<uint4*>(lo + r * ld + col) = l;
  }
}

// raw[kRows][DH] -> hi, lo as interleaved pairs of rows kGap apart, a pair
// every kPair words (Layout): each element split once
template <int DH, int kRows, int kGap, int kPair>
__device__ __forceinline__ void split_pairs(const float* raw, uint32_t* hi,
                                            uint32_t* lo) {
  constexpr int kPerRow = DH / 4;
  constexpr int kChunks = kRows / 2 * kPerRow;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kChunks % kThreads != 0 && c >= kChunks) break;
    const int pair = c / kPerRow, col = (c % kPerRow) * 4;
    const int r = pair / kGap * 2 * kGap + pair % kGap;
    const float4 a = *reinterpret_cast<const float4*>(raw + r * DH + col);
    const float4 b =
        *reinterpret_cast<const float4*>(raw + (r + kGap) * DH + col);
    uint4 h0, h1, l0, l1;
    tf32x3::split<0>(a.x, h0.x, l0.x);
    tf32x3::split<0>(b.x, h0.y, l0.y);
    tf32x3::split<0>(a.y, h0.z, l0.z);
    tf32x3::split<0>(b.y, h0.w, l0.w);
    tf32x3::split<0>(a.z, h1.x, l1.x);
    tf32x3::split<0>(b.z, h1.y, l1.y);
    tf32x3::split<0>(a.w, h1.z, l1.z);
    tf32x3::split<0>(b.w, h1.w, l1.w);
    const int at = pair * kPair + 2 * col;
    *reinterpret_cast<uint4*>(hi + at) = h0;
    *reinterpret_cast<uint4*>(hi + at + 4) = h1;
    *reinterpret_cast<uint4*>(lo + at) = l0;
    *reinterpret_cast<uint4*>(lo + at + 4) = l1;
  }
}

// d = a b over one 8-deep step from the splits of a and b: lo hi + hi lo +
// hi hi into fresh registers, the small terms first. A product over a
// longer sum adds these steps in f32: the tensor cores' f32 accumulation,
// which drifts over long sums, never runs past 8 terms.
__device__ __forceinline__ void product(float (&d)[4], const uint32_t* ah,
                                        const uint32_t* al,
                                        const uint32_t* bh,
                                        const uint32_t* bl) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  tf32x3::mma(d, al, bh);
  tf32x3::mma(d, ah, bl);
  tf32x3::mma(d, ah, bh);
}

// 2^x on the special function unit; results below 2^-126 flush to 0 (a
// softmax term that small is lost in the row's sum anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The running state of a warp's 16 query rows: the output accumulator,
// and for rows g and g + 8 the running max of x and this thread's share of
// the running sum (its keys only; the quad's shares add at the end).
template <int DH>
struct Rows {
  float acc[DH / 8][4];
  float m[2], l[2];
};

// A thread's fragments in shared memory, in hi (lo kQElems, kKElems,
// kVElems further on): q at the pair of rows r0 + g, r0 + g + 8, columns
// 2t, 2t + 1; k at row g, columns 2t, 2t + 1; v at the pair of rows 2t, 2t
// + 1, column g. Every fragment a tile reads lies at a constant offset from
// these.
struct Frags {
  const uint32_t* q;
  const uint32_t* k;
  const uint32_t* v;
};

// One key tile (kK keys from k0) for a warp: s = q k^T, the online
// softmax, acc += p v. kEdge: the tile holds keys past n, which are masked
// (8-key steps wholly past n are skipped).
template <int DH, bool kEdge>
__device__ __forceinline__ void tile(Rows<DH>& st, Frags f, int k0, int n,
                                     float c) {
  using L = Layout<DH>;
  constexpr int kNT = kK / 8;    // 8-key steps of a tile
  constexpr int kDT = DH / 8;    // 8-wide steps of d
  const int t = threadIdx.x % 4;

  // s = q k^T
  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    // slots t and t + 4 hold columns kk + 2t and kk + 2t + 1: a0..a3 are
    // (g, kk + 2t), (g + 8, kk + 2t), (g, kk + 2t + 1), (g + 8, kk + 2t + 1)
    const uint4 h4 = *reinterpret_cast<const uint4*>(f.q + 2 * kk);
    const uint4 l4 = *reinterpret_cast<const uint4*>(f.q + L::kQElems + 2 * kk);
    const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
    const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (kEdge && k0 + 8 * j >= n) continue;
      const uint32_t* ka = f.k + 8 * j * L::kKld + kk;
      const uint2 bh2 = *reinterpret_cast<const uint2*>(ka);
      const uint2 bl2 = *reinterpret_cast<const uint2*>(ka + L::kKElems);
      const uint32_t bh[2] = {bh2.x, bh2.y}, bl[2] = {bl2.x, bl2.y};
      float d[4];
      product(d, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += d[e];
    }
  }

  // online softmax in base 2, c = scale log2 e: m is the row's running max
  // of s c in f32, p = exp2(s c - m) with s c exact in the fma (m's rounding
  // is common to the row's terms and cancels). Element e of step j is row g
  // + 8 (e / 2), key k0 + 8j + 2t + e % 2
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!kEdge || k0 + 8 * j + 2 * t + (e & 1) < n)
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e] * c);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float mn = fmaxf(st.m[r], tmax[r]);  // finite: key k0 is < n
    alpha[r] = ex2(st.m[r] - mn);              // 0 on the first tile
    st.m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = !kEdge || k0 + 8 * j + 2 * t + (e & 1) < n
                          ? ex2(fmaf(s[j][e], c, -st.m[e >> 1]))
                          : 0.f;
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    st.acc[j][0] *= alpha[0];
    st.acc[j][1] *= alpha[0];
    st.acc[j][2] *= alpha[1];
    st.acc[j][3] *= alpha[1];
  }

  // p's A fragments: slot t of step j is key 8j + 2t, slot t + 4 key
  // 8j + 2t + 1, so a0..a3 are the scores' elements 0, 2, 1, 3
  uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    tf32x3::split<0>(s[j][0], ph[j][0], pl[j][0]);
    tf32x3::split<0>(s[j][2], ph[j][1], pl[j][1]);
    tf32x3::split<0>(s[j][1], ph[j][2], pl[j][2]);
    tf32x3::split<0>(s[j][3], ph[j][3], pl[j][3]);
  }
  // acc += p v; v's B fragment is rows 8j + 2t and 8j + 2t + 1 (the keys
  // of slots t and t + 4) at column 8 dj + g: one pair
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (kEdge && k0 + 8 * j >= n) continue;
#pragma unroll
    for (int dj = 0; dj < kDT; ++dj) {
      const uint32_t* va = f.v + 4 * j * L::kVPair + 16 * dj;
      const uint2 bh2 = *reinterpret_cast<const uint2*>(va);
      const uint2 bl2 = *reinterpret_cast<const uint2*>(va + L::kVElems);
      const uint32_t bh[2] = {bh2.x, bh2.y}, bl[2] = {bl2.x, bl2.y};
      float d[4];
      product(d, ph[j], pl[j], bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[dj][e] += d[e];
    }
  }
}

// c = scale log2(e). Raw rows land in a ring of two stages, key tile i in
// stage i % 2, each tile's copy issued two tiles ahead of its use.
template <int DH>
__global__ void __launch_bounds__(kThreads)
b7_tf32x3_kernel(Strided<const float> q, Strided<const float> k,
                 Strided<const float> v, Strided<float> o, int n, float c) {
  using L = Layout<DH>;
  constexpr int kDT = DH / 8;
  constexpr int kStage = kK * DH * 2;        // floats: a key and a value tile
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qh = smem;
  uint32_t* ql = qh + L::kQElems;
  uint32_t* kh = ql + L::kQElems;
  uint32_t* kl = kh + L::kKElems;
  uint32_t* vh = kl + L::kKElems;
  uint32_t* vl = vh + L::kVElems;
  float* raw = reinterpret_cast<float*>(vl + L::kVElems);

  const int q0 = blockIdx.x * kQ, h = blockIdx.y, b = blockIdx.z;
  const float* qp = q.base + b * q.sb + h * q.sh;
  const float* kp = k.base + b * k.sb + h * k.sh;
  const float* vp = v.base + b * v.sb + h * v.sh;
  const int r0 = threadIdx.x / 32 * 16;      // the warp's rows in the tile
  const bool active = q0 + r0 < n;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const Frags frags{qh + (r0 / 2 + g) * L::kQPair + 4 * t,
                    kh + g * L::kKld + 2 * t, vh + t * L::kVPair + 2 * g};
  const int tiles = (n + kK - 1) / kK;

  auto issue = [&](int i) {                  // key tile i into its stage
    if (i < tiles) {
      float* dst = raw + i % 2 * kStage;
      stage<DH, kK>(dst, kp, k.st, i * kK, n);
      stage<DH, kK>(dst + kK * DH, vp, v.st, i * kK, n);
    }
    tf32x3::cp_commit();
  };
  float* qraw = reinterpret_cast<float*>(kh);
  stage<DH, kQ>(qraw, qp, q.st, q0, n);
  tf32x3::cp_commit();
  tf32x3::cp_wait<0>();
  __syncthreads();                           // the query rows are in
  split_pairs<DH, kQ, 8, L::kQPair>(qraw, qh, ql);
  __syncthreads();                           // their staging area is free
  issue(0);
  issue(1);

  Rows<DH> st;
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[j][e] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const float* src = raw + i % 2 * kStage;
    tf32x3::cp_wait<1>();
    __syncthreads();                         // tile i in; tile i - 1 read
    split_rows<DH, kK>(src, kh, kl, L::kKld);
    split_pairs<DH, kK, 1, L::kVPair>(src + kK * DH, vh, vl);
    __syncthreads();                         // hi, lo written; stage free
    issue(i + 2);
    if (!active) continue;
    const int k0 = i * kK;
    if (k0 + kK <= n)
      tile<DH, false>(st, frags, k0, n, c);
    else
      tile<DH, true>(st, frags, k0, n, c);
  }
  tf32x3::cp_wait<0>();
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
  float* op = o.base + b * o.sb + h * o.sh;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int dj = 0; dj < kDT; ++dj) {
    const int col = 8 * dj + 2 * t;
    if (row0 < n)
      *reinterpret_cast<float2*>(op + row0 * o.st + col) =
          make_float2(st.acc[dj][0] / st.l[0], st.acc[dj][1] / st.l[0]);
    if (row1 < n)
      *reinterpret_cast<float2*>(op + row1 * o.st + col) =
          make_float2(st.acc[dj][2] / st.l[1], st.acc[dj][3] / st.l[1]);
  }
}

template <int DH>
cudaError_t launch(const float* q, const long long* qs, const float* k,
                   const long long* ks, const float* v, const long long* vs,
                   float* o, const long long* os, int batch, int heads, int n,
                   float scale, cudaStream_t stream) {
  static tf32x3::SmemLimit limit;
  cudaError_t err = tf32x3::raise_smem(b7_tf32x3_kernel<DH>,
                                       Layout<DH>::kSmemBytes, limit);
  if (err != cudaSuccess) return err;
  const Strided<const float> qa{q, qs[0], qs[1], qs[2]};
  const Strided<const float> ka{k, ks[0], ks[1], ks[2]};
  const Strided<const float> va{v, vs[0], vs[1], vs[2]};
  const Strided<float> oa{o, os[0], os[1], os[2]};
  const dim3 grid((n + kQ - 1) / kQ, heads, batch);
  b7_tf32x3_kernel<DH><<<grid, kThreads, Layout<DH>::kSmemBytes, stream>>>(
      qa, ka, va, oa, n, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the float32 route of kernels B5' and B7 on `stream`: q, k, v
// [batch, heads, n, dh] -> out [batch, heads, n, dh], all float32, each
// given by its device pointer and its (batch, head, token) strides in
// elements, every row of dh elements contiguous. Returns the cudaError_t
// of the launch: cudaErrorInvalidValue for an empty input, a grid past
// 65535 heads or images, or dh outside {16, 32, 64, 128};
// cudaErrorMisalignedAddress for a base not 16-byte aligned or a stride
// not a multiple of 4.
int b7_mha_tf32x3(const void* q, long long q_sb, long long q_sh,
                  long long q_st, const void* k, long long k_sb,
                  long long k_sh, long long k_st, const void* v,
                  long long v_sb, long long v_sh, long long v_st, void* out,
                  long long o_sb, long long o_sh, long long o_st, int batch,
                  int heads, int n, int dh, float scale, void* stream) {
  if (n < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qs[3] = {q_sb, q_sh, q_st}, ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st}, os[3] = {o_sb, o_sh, o_st};
  const void* bases[4] = {q, k, v, out};
  const long long* strides[4] = {qs, ks, vs, os};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(bases[i]) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    for (int j = 0; j < 3; ++j)
      if (strides[i][j] % 4)
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return static_cast<int>(launch<16>(qf, qs, kf, ks, vf, vs, of, os,
                                         batch, heads, n, scale, s));
    case 32:
      return static_cast<int>(launch<32>(qf, qs, kf, ks, vf, vs, of, os,
                                         batch, heads, n, scale, s));
    case 64:
      return static_cast<int>(launch<64>(qf, qs, kf, ks, vf, vs, of, os,
                                         batch, heads, n, scale, s));
    case 128:
      return static_cast<int>(launch<128>(qf, qs, kf, ks, vf, vs, of, os,
                                          batch, heads, n, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
