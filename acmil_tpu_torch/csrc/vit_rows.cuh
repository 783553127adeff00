// Row work shared by the two GEMMs of kernels B3 and B4: csrc/vit_gemm.cu
// (bf16 and fp16 operands on wgmma) and csrc/vit_gemm_f32.cu (f32 operands
// on split-TF32 mma.sync). It holds the LayerNorm prologue, which writes
// A's rows in the chain's dtype, the epilogues' arithmetic and the
// tanh-approximate gelu.
//
// The prologue (ln_rows_kernel) replaces the LayerNorm at the head of the
// Pallas kernels (acmil_tpu/ops/vit_layer.py:62-64, _ln_f32 then
// .astype(x.dtype)): one warp a row, the f32 mean and then the f32 mean of
// the squared deviations over the full K, then every element ((a - mu) *
// rsqrt(var + 1e-6)) * scale + bias rounded to TO, the chain's dtype (bf16
// or fp16: to nearest; f32: not rounded). Without the LayerNorm it only
// converts (an f32 residual h read by a bf16 or fp16 product). It is bound
// by bytes: one read of [M, K] TA and one write of [M, K] TO.
//
// Internal linkage, as for the other headers: each library keeps its own
// copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kLnThreads = 256;   // the prologue: one warp per row
constexpr int kLnChunks = 12;     // 4-element chunks a lane holds: K <= 1536
constexpr float kLnEps = 1e-6f;

enum Epilogue { kBias = 0, kBiasGelu = 1, kResBias = 2, kBiasLsRes = 3 };

// 4 consecutive elements as f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void load4(const f16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// 4 f32 rounded to T (bf16 or fp16, to nearest), as 8 bytes
template <typename T>
__device__ __forceinline__ uint2 pack4(const float* v) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 lo = __floats2half2_rn(v[0], v[1]);
    const __half2 hi = __floats2half2_rn(v[2], v[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// 4 f32 stored as TO at p (16-byte aligned for f32, 8 for 2-byte types)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = pack4<bf16>(v);
}

__device__ __forceinline__ void store4(f16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = pack4<f16>(v);
}

// One warp per row of A: out = TO(LN(a)) with kLn, else TO(a). The row is
// read once into registers, 4 elements a lane at a time (up to kLnChunks
// chunks a lane: K <= 32 * 4 * kLnChunks); wider rows are read again from
// L2 chunk by chunk.
template <typename TA, typename TO, bool kLn>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const TA* __restrict__ a, const float* __restrict__ scale,
               const float* __restrict__ shift, TO* __restrict__ out,
               int m_rows, int k_depth) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32;
  if (row >= m_rows) return;
  const TA* src = a + static_cast<size_t>(row) * k_depth;
  TO* dst = out + static_cast<size_t>(row) * k_depth;
  const bool held = k_depth <= 128 * kLnChunks;   // the row fits the registers
  float v[kLnChunks][4];
#pragma unroll
  for (int i = 0; i < kLnChunks; ++i) {
    const int c = 4 * lane + 128 * i;
    if (held && c < k_depth) load4(src + c, v[i]);
  }
  float mean = 0.f, rstd = 1.f;
  if (kLn) {
    float s = 0.f;
    if (held) {
#pragma unroll
      for (int i = 0; i < kLnChunks; ++i)
        if (4 * lane + 128 * i < k_depth)
          s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    } else {
      for (int c = 4 * lane; c < k_depth; c += 128) {
        float t[4];
        load4(src + c, t);
        s += (t[0] + t[1]) + (t[2] + t[3]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    mean = s / k_depth;
    float d2 = 0.f;
    if (held) {
#pragma unroll
      for (int i = 0; i < kLnChunks; ++i)
        if (4 * lane + 128 * i < k_depth)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = v[i][j] - mean;
            d2 += d * d;
          }
    } else {
      for (int c = 4 * lane; c < k_depth; c += 128) {
        float t[4];
        load4(src + c, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = t[j] - mean;
          d2 += d * d;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) d2 += __shfl_xor_sync(0xffffffffu, d2, o);
    rstd = rsqrtf(d2 / k_depth + kLnEps);
  }
  auto emit = [&](int c, float* t) {
    if (kLn) {
      const float4 g = *reinterpret_cast<const float4*>(scale + c);
      const float4 b = *reinterpret_cast<const float4*>(shift + c);
      t[0] = ((t[0] - mean) * rstd) * g.x + b.x;
      t[1] = ((t[1] - mean) * rstd) * g.y + b.y;
      t[2] = ((t[2] - mean) * rstd) * g.z + b.z;
      t[3] = ((t[3] - mean) * rstd) * g.w + b.w;
    }
    store4(dst + c, t);
  };
  if (held) {
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c < k_depth) emit(c, v[i]);
    }
  } else {
    for (int c = 4 * lane; c < k_depth; c += 128) {
      float t[4];
      load4(src + c, t);
      emit(c, t);
    }
  }
}

template <typename TA, typename TO, bool kLn>
cudaError_t launch_prologue(const void* a, const float* scale,
                            const float* shift, TO* out, int m, int k,
                            cudaStream_t stream) {
  const int rows = kLnThreads / 32;
  ln_rows_kernel<TA, TO, kLn><<<(m + rows - 1) / rows, kLnThreads, 0,
                                stream>>>(static_cast<const TA*>(a), scale,
                                          shift, out, m, k);
  return cudaGetLastError();
}

// jax.nn.gelu(x, approximate=True), in f32, with tanh(u) = 1 - 2 / (e^2u +
// 1) on the special-function unit: within a few f32 ulps of tanhf where
// |tanh| is large and within 1e-7 where it is small (a few instructions
// against tanhf's range reductions: fc1's epilogue applies it to 77 M
// elements at ViT-S/16, B = 256). The Pallas kernels' gelu is
// tanh-approximate at every dtype (acmil_tpu/ops/vit_layer.py:101-104).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  const float t = 1.0f - __fdividef(2.0f, __expf(2.0f * u) + 1.0f);
  return x * (0.5f * (1.0f + t));
}

// One output element through epilogue kEpi, in f32: acc the product, b and
// g the column's bias and layerscale (1 without one), r the residual
// (epilogues 2 and 3).
template <int kEpi>
__device__ __forceinline__ float epilogue_value(float acc, float b, float g,
                                                float r) {
  if (kEpi == kBiasGelu) return gelu_tanh(acc + b);
  if (kEpi == kResBias) return (r + acc) + b;
  if (kEpi == kBiasLsRes) return r + (acc + b) * g;
  return acc + b;
}

}  // namespace
