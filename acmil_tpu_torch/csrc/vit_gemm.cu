// The GEMM of kernels B3 and B4 for Hopper (sm_90a):
//
//   out[M, N] = epilogue(prologue(A)[M, K] . W[N, K]^T)
//
// Kernels B3 (acmil_tpu/ops/vit_layer.py::_layer_kernel, the whole ViT
// layer) and B4 (::_attn_half_kernel, its attention half) keep a layer's
// weights in the TPU's VMEM and run LN1 -> qkv -> attention -> proj
// (-> LN2 -> fc1 -> gelu -> fc2) in one program. A layer's weights (3.5 MB
// bf16 for ViT-S) do not fit the 227 KB of an SM's shared memory, so on the
// H100 each layer becomes a chain of launches with the same contract: this
// GEMM for every product, with the layernorm in its prologue and the bias,
// gelu, layerscale and residual in its epilogue, and kernel B5'
// (csrc/vit_attn.cu) for the attention. No activation other than the
// chain's hand-offs (qkv, o, h, m: bf16, or f32 for the residual h) goes to
// device memory.
//
// Prologue: optional LayerNorm of the A rows. Each block first takes the
// f32 mean and variance of its 128 rows over the full K (as _ln_f32 does:
// mean, then the mean of the squared deviations), then normalises every A
// element as it is staged, ((a - mu) * rsqrt(var + 1e-6)) * scale + bias,
// and rounds it to bf16, which is _ln_f32(...).astype(x.dtype). A is bf16
// (the layer input x) or f32 (the residual h of B3).
//
// Epilogues (f32, then stored as bf16 or f32):
//   0  acc + bias                    qkv
//   1  gelu_tanh(acc + bias)         fc1 of B3 (tanh-approximate at any dtype)
//   2  (res + acc) + bias            proj and fc2 of B3: h = x + o.Wp + bp
//   3  res + (acc + bias) * ls       proj of B4, ls = layerscale (or none)
// The residual is read as bf16 or f32.
//
// Design. 128x128 output tile per block, 8 warps of 64x32, depth 32 per
// step; bf16 operands on the tensor cores through nvcuda::wmma 16x16x16
// fragments with f32 accumulation. The next A and W slices are loaded into
// registers while the current ones are multiplied, and shared memory holds
// two stages. The ragged edges in M and N are masked in the kernel.
//
// Bounds. ViT-S/16 at B=256 (M = 50432 tokens): qkv is 44.6 GFLOP against
// 43 MB moved, fc1 59.5 GFLOP: at 989 TFLOP/s bf16 every product of the chain
// is compute-bound (about 300 operations per byte for the large ones). wmma
// reaches a fraction of the wgmma rate; TMA, wgmma and a persistent
// warp-specialised schedule are the later work that this kernel's time in
// PERF.md measures against.
//
// Widths the kernel takes: K a multiple of 32, N a multiple of 8, contiguous
// 16-byte-aligned buffers, W bf16 [N, K] (torch's Linear layout). The
// Python wrapper (acmil_tpu_torch/ops/vit_layer.py) checks them and raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kLd = kBK + 8;      // bf16 row stride of the staged slices
constexpr int kChunks = kBM * kBK / 8 / kThreads;   // 16-byte chunks a thread
constexpr float kLnEps = 1e-6f;

enum Epilogue { kBias = 0, kBiasGelu = 1, kResBias = 2, kBiasLsRes = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive elements of A as f32
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 out;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// jax.nn.gelu(x, approximate=True)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float t = tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)));
  return x * (0.5f * (1.0f + t));
}

template <typename TA, bool kLn>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a,                // [M, K]
            const float* __restrict__ ln_scale,      // [K] (kLn)
            const float* __restrict__ ln_bias,       // [K] (kLn)
            const __nv_bfloat16* __restrict__ w,     // [N, K]
            const float* __restrict__ bias,          // [N]
            const float* __restrict__ ls,            // [N] or null
            const void* __restrict__ res,            // [M, N] or null
            int res_f32, void* __restrict__ out, int out_f32, int epilogue,
            int m_rows, int n_cols, int k_depth) {
  __shared__ __align__(128) __nv_bfloat16 as[2][kBM * kLd];
  __shared__ __align__(128) __nv_bfloat16 ws[2][kBN * kLd];
  __shared__ float mu[kBM];
  __shared__ float rstd[kBM];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (kLn) {
    // row statistics over the full K: warp w takes rows 16w .. 16w+15
    for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
      const int gm = m0 + r;
      float mean = 0.0f, var = 1.0f;
      if (gm < m_rows) {
        const TA* row = a + static_cast<size_t>(gm) * k_depth;
        float s = 0.0f;
        for (int k = lane; k < k_depth; k += 32) s += to_f32(row[k]);
#pragma unroll
        for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        mean = s / k_depth;
        float d2 = 0.0f;
        for (int k = lane; k < k_depth; k += 32) {
          const float d = to_f32(row[k]) - mean;
          d2 += d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          d2 += __shfl_xor_sync(0xffffffffu, d2, o);
        var = d2 / k_depth;
      }
      if (lane == 0) {
        mu[r] = mean;
        rstd[r] = rsqrtf(var + kLnEps);
      }
    }
    __syncthreads();
  }

  uint4 a_reg[kChunks], w_reg[kChunks];
  // global -> registers: the A slice (normalised and rounded to bf16 when
  // kLn) and the W slice at depth k0; rows past the edge become zeros
  auto load_slice = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / (kBK / 8);
      const int c = (q % (kBK / 8)) * 8;
      const int gm = m0 + r;
      a_reg[i] = make_uint4(0, 0, 0, 0);
      if (gm < m_rows) {
        const TA* src = a + static_cast<size_t>(gm) * k_depth + k0 + c;
        if (!kLn && sizeof(TA) == 2) {
          a_reg[i] = *reinterpret_cast<const uint4*>(src);
        } else {
          float v[8];
          load8(src, v);
          if (kLn) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float t = (v[j] - mu[r]) * rstd[r];
              t = t * ln_scale[k0 + c + j];
              v[j] = t + ln_bias[k0 + c + j];
            }
          }
          a_reg[i] = pack8(v);
        }
      }
      const int gn = n0 + r;
      w_reg[i] = make_uint4(0, 0, 0, 0);
      if (gn < n_cols)
        w_reg[i] = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(gn) * k_depth + k0 + c);
    }
  };
  auto store_slice = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / (kBK / 8);
      const int c = (q % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&as[stage][r * kLd + c]) = a_reg[i];
      *reinterpret_cast<uint4*>(&ws[stage][r * kLd + c]) = w_reg[i];
    }
  };

  const int wm = warp / 4;          // rows 64 wm .. 64 wm + 63 of the tile
  const int wn = warp % 4;          // columns 32 wn .. 32 wn + 31
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = k_depth / kBK;
  load_slice(0);
  store_slice(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int stage = s % 2;
    if (s + 1 < steps) load_slice((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &as[stage][(64 * wm + 16 * i) * kLd + 16 * kk], kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &ws[stage][(32 * wn + 16 * j) * kLd + 16 * kk], kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (s + 1 < steps) store_slice(1 - stage);
    __syncthreads();
  }

  // epilogue: each 16x16 fragment through a per-warp f32 scratch (the first
  // A stage, free now), two lanes per row, eight columns each
  float* scratch = reinterpret_cast<float*>(as[0]) + warp * 256;
  const int r = lane / 2;
  const int c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + 64 * wm + 16 * i + r;
      const int gn = n0 + 32 * wn + 16 * j + c;
      if (gm < m_rows && gn < n_cols) {
        const size_t off = static_cast<size_t>(gm) * n_cols + gn;
        float v[8], rv[8];
        if (epilogue >= kResBias) {
          if (res_f32) load8(static_cast<const float*>(res) + off, rv);
          else load8(static_cast<const __nv_bfloat16*>(res) + off, rv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float acc_v = scratch[r * 16 + c + e];
          const float b = bias[gn + e];
          float y;
          if (epilogue == kBias) {
            y = acc_v + b;
          } else if (epilogue == kBiasGelu) {
            y = gelu_tanh(acc_v + b);
          } else if (epilogue == kResBias) {
            y = (rv[e] + acc_v) + b;
          } else {
            float t = acc_v + b;
            if (ls != nullptr) t = t * ls[gn + e];
            y = rv[e] + t;
          }
          v[e] = y;
        }
        if (out_f32) {
          float* dst = static_cast<float*>(out) + off;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
              pack8(v);
        }
      }
      __syncwarp();
    }
  }
}

template <typename TA, bool kLn>
cudaError_t launch(const void* a, const float* ln_scale, const float* ln_bias,
                   const __nv_bfloat16* w, const float* bias, const float* ls,
                   const void* res, int res_f32, void* out, int out_f32,
                   int epilogue, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<TA, kLn><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), ln_scale, ln_bias, w, bias, ls, res, res_f32,
      out, out_f32, epilogue, m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the GEMM on `stream`. A is [m, k] bf16 (a_f32 = 0) or f32;
// ln_scale/ln_bias [k] turn the LayerNorm prologue on (both null: off);
// w [n, k] bf16; bias [n] f32; ls [n] f32 or null; res [m, n] bf16 or f32
// (epilogues 2 and 3); out [m, n] bf16 (out_f32 = 0) or f32. All device
// pointers, contiguous and 16-byte aligned. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for widths it does not take).
int vit_gemm(const void* a, int a_f32, const float* ln_scale,
             const float* ln_bias, const void* w, const float* bias,
             const float* ls, const void* res, int res_f32, void* out,
             int out_f32, int epilogue, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK || n % 8 || epilogue < kBias ||
      epilogue > kBiasLsRes || (epilogue >= kResBias && res == nullptr) ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ln = ln_scale != nullptr;
  cudaError_t err;
  if (a_f32)
    err = ln ? launch<float, true>(a, ln_scale, ln_bias, wb, bias, ls, res,
                                   res_f32, out, out_f32, epilogue, m, n, k, st)
             : launch<float, false>(a, ln_scale, ln_bias, wb, bias, ls, res,
                                    res_f32, out, out_f32, epilogue, m, n, k, st);
  else
    err = ln ? launch<__nv_bfloat16, true>(a, ln_scale, ln_bias, wb, bias, ls,
                                           res, res_f32, out, out_f32,
                                           epilogue, m, n, k, st)
             : launch<__nv_bfloat16, false>(a, ln_scale, ln_bias, wb, bias, ls,
                                            res, res_f32, out, out_f32,
                                            epilogue, m, n, k, st);
  return static_cast<int>(err);
}

}  // extern "C"
