// The GEMM of kernels B3 and B4 at float32 for Hopper (sm_90a):
//
//   out[M, N] = epilogue(prologue(A)[M, K] . W[N, K]^T),  all f32
//
// The Pallas kernels B3 (acmil_tpu/ops/vit_layer.py::_layer_kernel) and B4
// (::_attn_half_kernel) take any float dtype; at float32 they multiply f32
// operands with f32 accumulation. csrc/vit_gemm.cu runs the chain at bf16
// and fp16 on wgmma; this is its float32 twin, with the same contract
// (the four epilogues of csrc/vit_rows.cuh: bias; tanh-approximate gelu;
// residual + bias; residual + (acc + bias) * layerscale), its residual and
// its output in f32, and nothing rounded below f32: not to bf16 and not
// to plain TF32.
//
// Products. Each f32 operand is split into hi = tf32(a) and lo = tf32(a -
// hi), and a b = lo hi + hi lo + hi hi (the small terms first) on
// mma.sync.m16n8k8 TF32 with f32 sums: csrc/tf32x3.cuh's block product,
// which B1, B2 and B6 use. Each 32-deep slice is summed apart and added to
// the tile's accumulators in f32 (kFlush), so the tensor cores' f32
// accumulation never runs over more than 32 terms.
//
// Prologue. With the LayerNorm, ln_rows_kernel (csrc/vit_rows.cuh) writes
// the normalised rows in f32 (nothing rounded) to a workspace the caller
// allocates and the product reads them; without it the product reads A as
// it lies.
//
// Bounds on the H100. ViT-S/16 at B = 256 (M = 50432 tokens) does 178.5
// GFLOP of products a layer; split-TF32 issues three TF32 products for
// each, so by operations the bound is 3 x 2MNK / 495 TFLOP/s (TF32 dense),
// 1.08 ms a layer, against 2MNK / 67 TFLOP/s = 2.66 ms on the f32 FMA
// units. The bytes (A, W, the residual and the output once: 0.35 GB a
// layer, 0.10 ms) are far below, so the design keeps the tensor cores
// busy: 128 x 128 output tiles of 256 threads (warps 2 x 4, 64 x 32 each),
// a ring of three 32-deep slices of A and W staged by cp.async, the splits
// done from shared memory as the fragments load. It is a simple kernel
// that is right first; its time is in PERF.md.
//
// Widths the kernel takes: K a multiple of 32, N a multiple of 8,
// contiguous 16-byte-aligned f32 buffers, W [N, K] (torch's Linear
// layout). The Python wrapper (acmil_tpu_torch/ops/vit_layer.py) checks
// them and raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "vit_rows.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
using OpA = tf32x3::Operand<float, true, kBM, kBK>;   // A[m][k]
using OpW = tf32x3::Operand<float, true, kBN, kBK>;   // W[n][k]
using Gemm = tf32x3::BlockGemm<OpA, OpW, kBM, kBN, kBK, 2, 4, kStages>;

struct F32Epilogue {
  const float* bias;   // [N]
  const float* ls;     // [N] or null
  const float* res;    // [M, N] or null
  float* out;          // [M, N]
};

// Grid (N tiles, M tiles): one 128 x 128 output tile a block, the N tiles
// of one row band launched together so that they share its A rows in L2.
template <int kEpi>
__global__ void __launch_bounds__(Gemm::kThreads, 1)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                F32Epilogue e, int m_rows, int n_cols, int k_depth) {
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  float acc[Gemm::kMT][Gemm::kNT][4];
  Gemm::zero(acc);
  Gemm::run<true>(acc, OpA{a, k_depth, m_rows, k_depth},
                  OpW{w, k_depth, n_cols, k_depth}, m0, n0, 0, k_depth, smem);
  Gemm::for_pairs(acc, m0, n0, [&](int r, int c, float v0, float v1) {
    if (r >= m_rows || c >= n_cols) return;      // N % 8 == 0: c + 1 too
    const size_t off = static_cast<size_t>(r) * n_cols + c;
    const float2 b = *reinterpret_cast<const float2*>(e.bias + c);
    float2 g = make_float2(1.f, 1.f), res = make_float2(0.f, 0.f);
    if (kEpi == kBiasLsRes && e.ls != nullptr)
      g = *reinterpret_cast<const float2*>(e.ls + c);
    if (kEpi >= kResBias) res = *reinterpret_cast<const float2*>(e.res + off);
    *reinterpret_cast<float2*>(e.out + off) =
        make_float2(epilogue_value<kEpi>(v0, b.x, g.x, res.x),
                    epilogue_value<kEpi>(v1, b.y, g.y, res.y));
  });
}

template <int kEpi>
cudaError_t launch_gemm(const float* a, const float* w, const F32Epilogue& e,
                        int m, int n, int k, cudaStream_t stream) {
  static tf32x3::SmemLimit limit;
  cudaError_t err =
      tf32x3::raise_smem(gemm_f32_kernel<kEpi>, Gemm::kSmemBytes, limit);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_f32_kernel<kEpi><<<grid, Gemm::kThreads, Gemm::kSmemBytes, stream>>>(
      a, w, e, m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the f32 GEMM on `stream`. A is [m, k] f32; ln_scale/ln_bias [k]
// turn the LayerNorm prologue on (both null: off), which writes f32 rows to
// a_rows [m, k] (else null: the product reads A itself); w [n, k]; bias
// [n]; ls [n] or null; res [m, n] (epilogues 2 and 3); out [m, n]; all f32
// device pointers, contiguous and 16-byte aligned. Returns the cudaError_t
// of the launches (cudaErrorInvalidValue for widths it does not take).
int vit_gemm_f32(const float* a, const float* ln_scale, const float* ln_bias,
                 float* a_rows, const float* w, const float* bias,
                 const float* ls, const float* res, float* out, int epilogue,
                 int m, int n, int k, void* stream) {
  const bool ln = ln_scale != nullptr;
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 || n % 8 || epilogue < kBias ||
      epilogue > kBiasLsRes || (epilogue >= kResBias && res == nullptr) ||
      (ln && a_rows == nullptr) || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) {
    const cudaError_t err = launch_prologue<float, float, true>(
        a, ln_scale, ln_bias, a_rows, m, k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    a = a_rows;
  }
  const F32Epilogue e{bias, ls, res, out};
  cudaError_t err;
  switch (epilogue) {
    case kBias: err = launch_gemm<kBias>(a, w, e, m, n, k, st); break;
    case kBiasGelu: err = launch_gemm<kBiasGelu>(a, w, e, m, n, k, st); break;
    case kResBias: err = launch_gemm<kResBias>(a, w, e, m, n, k, st); break;
    default: err = launch_gemm<kBiasLsRes>(a, w, e, m, n, k, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
