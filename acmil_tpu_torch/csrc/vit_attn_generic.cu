// Kernel B7's generic route for Hopper (sm_90a): multi-head attention over
// separate q, k, v at float32, float16 and bfloat16, any head width up to
// 256.
//
// It replaces acmil_tpu/ops/vit_attn.py::_mha_kernel (fused_vit_attention)
// wherever csrc/vit_attn.cu's tensor-core route does not apply: that route
// takes bfloat16 at dh in {16, 32, 64, 128} only, while the Pallas kernel
// takes any float dtype and any dh. Per image b and head h it computes
//
//   s = (q k^T) * scale                                             (f32)
//   p = exp(s - max s) / sum exp(s - max s), rounded to q's dtype
//   o = p v   (f32 sums, rounded once to q's dtype)
//
// with the Pallas kernel's rounding points. p is rounded after the
// normalisation, so every row's max and sum must be known before any p is
// formed: the kernel takes two passes over the keys, the first for the
// row's max and sum (online), the second forming p again and running p v.
// At float32 the rounding is a no-op and the function is the same either
// way.
//
// Operands are read through strides: element (b, h, t, d) of an operand
// lies at base + b*sb + h*sh + t*st + d, so strided views of a packed qkv
// and a token-major output buffer need no copy. Rows need no alignment.
//
// Bounds on the H100 (67 TFLOP/s float32 outside the tensor cores, 3.35
// TB/s): at a float32 ViT-S/16 shape (B=256, 6 heads of 64, N=197) the two
// products are 15.3 GFLOP -> 0.228 ms, against 310 MB of q, k, v and o ->
// 92.6 us: bound by operations. The kernel's products run on the f32 FMA
// units at every dtype, and its two passes form the scores twice.
//
// Design, simple on purpose: one block of 256 threads per (64-query tile,
// head, image). The query tile is held in shared memory as f32 (64 x 256
// x 4 B = 64 KB at the widest); keys and values are streamed in 64-row
// tiles through one shared buffer. Each thread owns a 4 x 4 micro-tile of
// a 64 x 64 score tile (rows tr + 16i, keys tc + 16j) and, for p v, 4 rows
// by dh/16 columns of the output, in registers. Rows of q and k are
// stored at an odd stride, so the 16 lanes that read 16 keys at one d meet
// 16 banks. The 16 lanes of one row group merge their running max and sum
// with shuffles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // queries a block
constexpr int kK = 64;          // keys a tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One operand, read through its strides in elements.
template <typename P>
struct Strided {
  P* base;
  long long sb, sh, st;
};

// rows [row0, row0 + kRows) of one head's operand into shared memory as
// f32 at row stride `ld`: columns past dh and rows past n are zero (a zero
// value row keeps 0 * garbage out of p v)
template <int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long st, int row0, int n,
                                          int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = row0 + r;
    const T* s = src + row * st;
    for (int c = lane; c < ld; c += 32)
      dst[r * ld + c] = (row < n && c < dh) ? to_f32(s[c]) : 0.f;
  }
}

// the 4 x 4 scores of this thread: query rows tr + 16i of the tile against
// key rows tc + 16j, times scale
__device__ __forceinline__ void scores(float (&s)[4][4], const float* qs,
                                       const float* ks, int ld, int dh,
                                       int tr, int tc, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(tr + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tc + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

// (m, l) <- the running max and sum of two sets of exp(s - m) terms
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;                 // neither has a key yet
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
  m = mn;
}

// J: output columns a thread holds in groups of 16, dh <= 16 * J
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
b7_generic_kernel(Strided<const T> q, Strided<const T> k, Strided<const T> v,
                  Strided<T> o, int n, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = dh | 1;                       // odd: conflict-free columns
  constexpr int kVld = 16 * J;                 // value rows, zero-padded
  float* qs = smem;                            // [kQ][ld]
  float* kv = qs + kQ * ld;                    // [kK][max(ld, kVld)]
  const int kv_size = kK * (ld > kVld ? ld : kVld);
  float* ps = kv + kv_size;                    // [kQ][kK + 1]
  constexpr int kPld = kK + 1;

  const int q0 = blockIdx.x * kQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qoff = b * q.sb + h * q.sh;
  const long long koff = b * k.sb + h * k.sh;
  const long long voff = b * v.sb + h * v.sh;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_tile<kQ>(qs, ld, q.base + qoff, q.st, q0, n, dh);

  // pass 1: each row's max and sum of exp(s - max) over every key
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kK) {
    __syncthreads();                           // kv free, qs written
    load_tile<kK>(kv, ld, k.base + koff, k.st, k0, n, dh);
    __syncthreads();
    float s[4][4];
    scores(s, qs, kv, ld, dh, tr, tc, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tc + 16 * j < n) tm = fmaxf(tm, s[i][j]);
      if (tm == -INFINITY) continue;
      float tl = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tc + 16 * j < n) tl += expf(s[i][j] - tm);
      merge(m[i], l[i], tm, tl);
    }
  }
  // the 16 lanes of a row group hold disjoint keys of the same rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      merge(m[i], l[i], mo, lo);
    }

  // pass 2: p = exp(s - m) / l rounded to T, then o += p v
  float acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kK) {
    __syncthreads();                           // kv and ps free
    load_tile<kK>(kv, ld, k.base + koff, k.st, k0, n, dh);
    __syncthreads();
    float s[4][4];
    scores(s, qs, kv, ld, dh, tr, tc, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tc + 16 * j < n ? expf(s[i][j] - m[i]) / l[i]
                                             : 0.f;
        ps[(tr + 16 * i) * kPld + tc + 16 * j] = to_f32(from_f32<T>(p));
      }
    __syncthreads();                           // ps written, kv read
    load_tile<kK>(kv, kVld, v.base + voff, v.st, k0, n, dh);
    __syncthreads();
    const int keys = n - k0 < kK ? n - k0 : kK;
    for (int key = 0; key < keys; ++key) {
      float vv[J];
#pragma unroll
      for (int j = 0; j < J; ++j) vv[j] = kv[key * kVld + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(tr + 16 * i) * kPld + key];
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* out = o.base + b * o.sb + h * o.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tc + 16 * j;
      if (c < dh) out[row * o.st + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int J>
cudaError_t launch(const void* q, const long long* qs, const void* k,
                   const long long* ks, const void* v, const long long* vs,
                   void* o, const long long* os, int batch, int heads, int n,
                   int dh, float scale, cudaStream_t stream) {
  const int ld = dh | 1;
  const int kv_cols = ld > 16 * J ? ld : 16 * J;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kQ * ld + kK * kv_cols + kQ * (kK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      b7_generic_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const Strided<const T> qa{static_cast<const T*>(q), qs[0], qs[1], qs[2]};
  const Strided<const T> ka{static_cast<const T*>(k), ks[0], ks[1], ks[2]};
  const Strided<const T> va{static_cast<const T*>(v), vs[0], vs[1], vs[2]};
  const Strided<T> oa{static_cast<T*>(o), os[0], os[1], os[2]};
  const dim3 grid((n + kQ - 1) / kQ, heads, batch);
  b7_generic_kernel<T, J><<<grid, kThreads, smem, stream>>>(qa, ka, va, oa,
                                                            n, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const long long* qs, const void* k,
                      const long long* ks, const void* v, const long long* vs,
                      void* o, const long long* os, int batch, int heads,
                      int n, int dh, float scale, cudaStream_t stream) {
  if (dh <= 16)
    return launch<T, 1>(q, qs, k, ks, v, vs, o, os, batch, heads, n, dh,
                        scale, stream);
  if (dh <= 32)
    return launch<T, 2>(q, qs, k, ks, v, vs, o, os, batch, heads, n, dh,
                        scale, stream);
  if (dh <= 64)
    return launch<T, 4>(q, qs, k, ks, v, vs, o, os, batch, heads, n, dh,
                        scale, stream);
  if (dh <= 128)
    return launch<T, 8>(q, qs, k, ks, v, vs, o, os, batch, heads, n, dh,
                        scale, stream);
  return launch<T, 16>(q, qs, k, ks, v, vs, o, os, batch, heads, n, dh,
                       scale, stream);
}

}  // namespace

extern "C" {

// Launches kernel B7's generic route on `stream`: q, k, v [batch, heads, n,
// dh] -> out [batch, heads, n, dh], all of one dtype (0 float32, 1 float16,
// 2 bfloat16), each given by its device pointer and its (batch, head,
// token) strides in elements, every row of dh elements contiguous. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an empty input,
// dh outside [1, 256] or an unknown dtype).
int b7_mha_generic(int dtype, const void* q, long long q_sb, long long q_sh,
                   long long q_st, const void* k, long long k_sb,
                   long long k_sh, long long k_st, const void* v,
                   long long v_sb, long long v_sh, long long v_st, void* out,
                   long long o_sb, long long o_sh, long long o_st, int batch,
                   int heads, int n, int dh, float scale, void* stream) {
  if (n < 1 || batch < 1 || heads < 1 || dh < 1 || dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qs[3] = {q_sb, q_sh, q_st}, ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st}, os[3] = {o_sb, o_sh, o_st};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dh<float>(q, qs, k, ks, v, vs, out, os,
                                               batch, heads, n, dh, scale, s));
    case 1:
      return static_cast<int>(launch_dh<__half>(q, qs, k, ks, v, vs, out, os,
                                                batch, heads, n, dh, scale,
                                                s));
    case 2:
      return static_cast<int>(launch_dh<__nv_bfloat16>(
          q, qs, k, ks, v, vs, out, os, batch, heads, n, dh, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
