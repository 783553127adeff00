// Kernels B5' and B7: multi-head attention for Hopper (sm_90a).
//
// B5' replaces the Pallas TPU kernel acmil_tpu/ops/vit_attn_packed.py::
// _packed_kernel, which fused_mha_packed launches, and serves as the
// attention step of kernels B3 and B4 (acmil_tpu/ops/vit_layer.py::
// _layer_kernel and _attn_half_kernel). From the token-major output of a
// ViT's fused qkv projection it computes, per image b and head h,
//
//   q, k, v = qkv[b, :, h*dh : (h+1)*dh] of the q, k and v thirds
//   s       = (q k^T) * (1 / sqrt(dh)),  keys >= N masked to -inf   (f32)
//   p       = softmax of s over the keys, rounded to bf16
//   o[b, :, h*dh : (h+1)*dh] = p v   (f32 sums, stored as bf16)
//
// so heads are split inside the kernel and no [B, H, N, dh] copy of q, k, v
// or o ever reaches device memory.
//
// B7 replaces acmil_tpu/ops/vit_attn.py::_mha_kernel (fused_vit_attention):
// the same function with q, k and v given as separate [B, H, N, dh] tensors
// and a caller's scale. Both entries run one kernel body, which reads each
// operand through strides: element (b, h, t, d) of an operand lies at
// base + b*sb + h*sh + t*st + d. The packed entry passes the strides of the
// qkv layout, the B7 entry those of its tensors, so any layout whose rows
// are contiguous and 16-byte aligned works without a copy.
//
// Design. One block per (64-query tile, head, image), four warps, each warp
// owning 16 query rows. The block streams the image's keys and values in
// tiles of 64 rows through shared memory, so any N works (197, 577, 785);
// the TPU kernel's VMEM limit on N does not apply.
// Pass 1 runs the online softmax over the key tiles and keeps each row's
// running max m and sum l in registers. Pass 2 recomputes the scores of each
// key tile, forms p = exp(s - m) / l, rounds p to bf16 exactly where the TPU
// kernels do (vit_attn_packed.py:66, vit_attn.py:62: after the normalisation
// and before the product with v), and accumulates p v. Both products run on
// the tensor cores through nvcuda::wmma bf16 fragments (16x16x16, f32
// accumulation). Keys past N get -inf and value rows past N are loaded as
// zeros (0 * NaN = NaN otherwise); query rows past N are never written.
//
// Bounds. At CLIP-L/336 (N=577, D=1024, 16 heads) one image is 1.36 GFLOP of
// QK^T and PV against 4.73 MB of qkv read and o written: about 1.38 us of
// bf16 tensor-core time against 1.41 us of HBM time, so the op sits at the
// ridge. This first kernel computes the scores twice (one pass for the
// statistics, one for p), re-reads the key and value tiles from L2 for every
// query tile, and uses wmma without TMA or wgmma, so it is bound by issue
// rate rather than by either roof; a single-pass flash form with wgmma is
// later work.
//
// Widths the kernel takes: bf16 operands with dh in {16, 32, 64, 128}, each
// row of dh elements contiguous and 16-byte aligned. The Python wrappers
// (acmil_tpu_torch/ops/vit_attn_packed.py, ops/vit_attn.py) check them and
// raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kQTile = 64;       // query rows per block
constexpr int kKTile = 64;       // key rows per step
constexpr int kWarps = 4;        // warp w owns query rows 16w .. 16w+15
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;          // bf16 padding of each shared row
constexpr int kSPad = 4;         // f32 padding of each shared row

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// One operand of the attention, read through its strides in elements:
// element (b, h, t, d) at base + b*sb + h*sh + t*st + d.
template <typename P>
struct Strided {
  P* base;
  long long sb, sh, st;
  __device__ __forceinline__ P* head(int b, int h) const {
    return base + b * sb + h * sh;
  }
};

template <int DH>
struct Layout {
  static constexpr int kLd = DH + kPad;                         // Q, K, V rows
  static constexpr int kSLd = (DH > kKTile ? DH : kKTile) + kSPad;  // S, then O
  static constexpr int kPLd = kKTile + kPad;                    // P rows
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(sizeof(__nv_bfloat16) * kQTile * kLd);
  static constexpr size_t kV = kK + align128(sizeof(__nv_bfloat16) * kKTile * kLd);
  static constexpr size_t kS = kV + align128(sizeof(__nv_bfloat16) * kKTile * kLd);
  static constexpr size_t kP = kS + align128(sizeof(float) * kQTile * kSLd);
  static constexpr size_t kBytes = kP + align128(sizeof(__nv_bfloat16) * kQTile * kPLd);
};

// Copies rows [row0, row0 + 64) of one head of one image (rows st apart
// from src) into shared memory; rows past N become zeros.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n, long long st) {
  constexpr int kChunks = DH / 8;               // 16-byte chunks per row
  constexpr int kLd = Layout<DH>::kLd;
  for (int q = threadIdx.x; q < kKTile * kChunks; q += kThreads) {
    const int r = q / kChunks;
    const int c = (q % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    const int row = row0 + r;
    if (row < n)
      val = *reinterpret_cast<const uint4*>(src + row * st + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Scores of this warp's 16 query rows against the 64 keys in shared memory,
// unscaled f32, into its rows of S.
template <int DH>
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* qs,
                                            const __nv_bfloat16* ks,
                                            float* ss, int warp) {
  constexpr int kLd = Layout<DH>::kLd;
  constexpr int kSLd = Layout<DH>::kSLd;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kKTile / 16];
#pragma unroll
  for (int j = 0; j < kKTile / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + 16 * warp * kLd + 16 * kk, kLd);
#pragma unroll
    for (int j = 0; j < kKTile / 16; ++j) {
      // B[k][n] = K[n][k]: the key tile read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + 16 * j * kLd + 16 * kk, kLd);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kKTile / 16; ++j)
    wmma::store_matrix_sync(ss + 16 * warp * kSLd + 16 * j, acc[j], kSLd,
                            wmma::mem_row_major);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_kernel(Strided<const __nv_bfloat16> q, Strided<const __nv_bfloat16> k,
           Strided<const __nv_bfloat16> v, Strided<__nv_bfloat16> o, int n,
           float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);

  const int q0 = blockIdx.x * kQTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* qh = q.head(b, head);
  const __nv_bfloat16* kh = k.head(b, head);
  const __nv_bfloat16* vh = v.head(b, head);

  // two lanes per query row, each over half of a key tile's 64 columns
  const int row = 16 * warp + lane / 2;
  const int c0 = (lane % 2) * (kKTile / 2);
  float* srow = ss + row * L::kSLd + c0;

  load_tile<DH>(qs, qh, q0, n, q.st);

  // pass 1: each row's max m and sum l of exp(s - m) over all keys
  float m = -INFINITY, l = 0.0f;
  for (int kt = 0; kt < n; kt += kKTile) {
    __syncthreads();                    // the previous key tile is consumed
    load_tile<DH>(ks, kh, kt, n, k.st);
    __syncthreads();
    warp_scores<DH>(qs, ks, ss, warp);
    __syncwarp();
    float tmax = -INFINITY;
    for (int c = 0; c < kKTile / 2; ++c)
      if (kt + c0 + c < n) tmax = fmaxf(tmax, srow[c] * scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float sum = 0.0f;
    for (int c = 0; c < kKTile / 2; ++c)
      if (kt + c0 + c < n) sum += expf(srow[c] * scale - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * expf(m - m_new) + sum;      // m = -inf on the first tile: 0 * 0
    m = m_new;
    __syncwarp();
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, then o += p v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
  for (int d = 0; d < DH / 16; ++d) wmma::fill_fragment(oacc[d], 0.0f);
  __nv_bfloat16* prow = ps + row * L::kPLd + c0;
  for (int kt = 0; kt < n; kt += kKTile) {
    __syncthreads();
    load_tile<DH>(ks, kh, kt, n, k.st);
    load_tile<DH>(vs, vh, kt, n, v.st);
    __syncthreads();
    warp_scores<DH>(qs, ks, ss, warp);
    __syncwarp();
    for (int c = 0; c < kKTile / 2; ++c) {
      const float p = (kt + c0 + c < n) ? expf(srow[c] * scale - m) / l : 0.0f;
      prow[c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + 16 * warp * L::kPLd + 16 * kk, L::kPLd);
#pragma unroll
      for (int d = 0; d < DH / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, vs + 16 * kk * L::kLd + 16 * d, L::kLd);
        wmma::mma_sync(oacc[d], a, bv, oacc[d]);
      }
    }
  }

  // this warp's 16 rows of o through its own rows of S, then bf16 to memory
  __syncwarp();
#pragma unroll
  for (int d = 0; d < DH / 16; ++d)
    wmma::store_matrix_sync(ss + 16 * warp * L::kSLd + 16 * d, oacc[d],
                            L::kSLd, wmma::mem_row_major);
  __syncwarp();
  constexpr int kChunks = DH / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = 16 * warp + i / kChunks;
    const int c = (i % kChunks) * 8;
    const int tok = q0 + r;
    if (tok >= n) continue;
    const float* src = ss + r * L::kSLd + c;
    __align__(16) __nv_bfloat16 v8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v8[j] = __float2bfloat16_rn(src[j]);
    *reinterpret_cast<uint4*>(o.head(b, head) + tok * o.st + c) =
        *reinterpret_cast<const uint4*>(v8);
  }
}

template <int DH>
cudaError_t launch(Strided<const __nv_bfloat16> q, Strided<const __nv_bfloat16> k,
                   Strided<const __nv_bfloat16> v, Strided<__nv_bfloat16> o,
                   int batch, int heads, int n, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile - 1) / kQTile, heads, batch);
  mha_kernel<DH><<<grid, kThreads, smem, stream>>>(q, k, v, o, n, scale);
  return cudaGetLastError();
}

cudaError_t launch_dh(int dh, Strided<const __nv_bfloat16> q,
                      Strided<const __nv_bfloat16> k,
                      Strided<const __nv_bfloat16> v, Strided<__nv_bfloat16> o,
                      int batch, int heads, int n, float scale,
                      cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, batch, heads, n, scale, stream);
    case 32: return launch<32>(q, k, v, o, batch, heads, n, scale, stream);
    case 64: return launch<64>(q, k, v, o, batch, heads, n, scale, stream);
    case 128: return launch<128>(q, k, v, o, batch, heads, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches kernel B5' on `stream`: qkv [batch, n, 3*dim] bf16 -> out
// [batch, n, dim] bf16, device pointers to contiguous 16-byte-aligned
// buffers. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// a head width it is not compiled for).
int b5_mha_packed(const void* qkv, void* out, int batch, int n, int dim,
                  int heads, void* stream) {
  if (heads <= 0 || dim % heads) return static_cast<int>(cudaErrorInvalidValue);
  const int dh = dim / heads;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  const long long sb = static_cast<long long>(n) * 3 * dim;
  const Strided<const __nv_bfloat16> q{in, sb, dh, 3LL * dim};
  const Strided<const __nv_bfloat16> k{in + dim, sb, dh, 3LL * dim};
  const Strided<const __nv_bfloat16> v{in + 2 * dim, sb, dh, 3LL * dim};
  const Strided<__nv_bfloat16> o{static_cast<__nv_bfloat16*>(out),
                                 static_cast<long long>(n) * dim, dh, dim};
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return static_cast<int>(launch_dh(dh, q, k, v, o, batch, heads, n, scale,
                                    static_cast<cudaStream_t>(stream)));
}

// Launches kernel B7 on `stream`: q, k, v [batch, heads, n, dh] bf16 ->
// out [batch, heads, n, dh] bf16, each given by its device pointer and its
// (batch, head, token) strides in elements; every row of dh elements must
// be contiguous and 16-byte aligned. Returns the cudaError_t of the launch.
int b7_mha_strided(const void* q, long long q_sb, long long q_sh,
                   long long q_st, const void* k, long long k_sb,
                   long long k_sh, long long k_st, const void* v,
                   long long v_sb, long long v_sh, long long v_st, void* out,
                   long long o_sb, long long o_sh, long long o_st, int batch,
                   int heads, int n, int dh, float scale, void* stream) {
  using In = Strided<const __nv_bfloat16>;
  const In qs{static_cast<const __nv_bfloat16*>(q), q_sb, q_sh, q_st};
  const In ks{static_cast<const __nv_bfloat16*>(k), k_sb, k_sh, k_st};
  const In vs{static_cast<const __nv_bfloat16*>(v), v_sb, v_sh, v_st};
  const Strided<__nv_bfloat16> os{static_cast<__nv_bfloat16*>(out), o_sb, o_sh,
                                  o_st};
  return static_cast<int>(launch_dh(dh, qs, ks, vs, os, batch, heads, n, scale,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
