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
// chain's hand-offs (qkv, o, h, m: the chain's dtype T, or f32 for the
// residual h, and the T rows of the prologue) goes to device memory.
//
// Element type. T, the chain's dtype, is bf16 or fp16 (x's dtype: the
// Pallas kernels cast the weights to it and round at it,
// acmil_tpu/ops/vit_layer.py:196-201): A, W, the prologue's rows and the
// T outputs are T; the tensor cores run both at 989 TFLOP/s. The chain at
// float32 runs csrc/vit_gemm_f32.cu instead (split-TF32, f32 accuracy).
//
// Prologue: optional LayerNorm of the A rows, in its own small kernel
// (ln_rows_kernel of csrc/vit_rows.cuh) that writes T rows to a workspace
// the caller allocates, which is _ln_f32(...).astype(x.dtype). The product
// then reads those rows by TMA. Since the prologue rounds to T before the
// product either way, this gives the same numbers as normalising each
// staged tile in place; it costs one extra write and read of [M, K] T (39
// MB at ViT-S/16, B = 256). An f32 A without LayerNorm passes through the
// same kernel, rounded to T. A is T (the layer input x) or f32 (the
// residual h of B3).
//
// Epilogues (f32, then stored as T or f32; csrc/vit_rows.cuh):
//   0  acc + bias                    qkv
//   1  gelu_tanh(acc + bias)         fc1 of B3 (tanh-approximate at any dtype)
//   2  (res + acc) + bias            proj and fc2 of B3: h = x + o.Wp + bp
//   3  res + (acc + bias) * ls       proj of B4, ls = layerscale (or none)
// The residual is read as T or f32.
//
// Design (gemm_kernel). A persistent grid of one block per SM walks the
// 128 x 128 output tiles, N fastest, so that the blocks in flight share
// their A rows in L2 and W (at most a few MB) stays there. Each block runs
// three warpgroups. One producer thread (warpgroup 2) keeps a ring of four
// stages full, each stage one 128 x 64 tile of A and one 128 x 64 tile of W
// (a depth step of 64 T is one 128-byte row), brought by TMA
// (cp.async.bulk.tensor, a CUtensorMap per operand built on the host) with
// the 128-byte swizzle and completed on a "full" mbarrier per stage. Two
// consumer warpgroups take 64 rows each of the same tile and issue wgmma
// m64n128k16 (T, f32 accumulators in 64 registers a thread) straight
// from the swizzled tiles, four per stage; each keeps one stage's products
// in flight while it releases the one before through an "empty" mbarrier
// (one arrival a warp). setmaxnreg moves registers from the producer to
// the consumers. The producer runs ahead into the next tile's stages while
// the consumers apply the epilogue: each warpgroup stages its 64 x 128 f32
// accumulators in shared memory (padded rows, so the pair writes meet no
// bank conflict), then every warp takes whole rows, four columns a lane,
// applies bias, gelu, residual and layerscale, and stores 16 (f32) or 8
// (T) contiguous bytes a lane: whole rows per instruction. A lane asks
// for its residuals before the tile's products, so that they arrive while
// the products run, and the stores are not waited on, so they drain
// during the next tile's products. Ragged M, N and K are zero-filled by
// TMA and masked at the store.
//
// Measured in development on the H100 (PERF.md): with the accumulators
// stored straight from their registers (two columns a lane, eight row
// segments a warp instruction) the epilogue took longer than the products
// at K = 384; a ping-pong schedule (each warpgroup a whole tile, mainloops
// in turn) ran its mainloop at half the rate; and a TMA-store epilogue from
// a swizzled tile was slower than these plain row stores.
//
// Bounds. ViT-S/16 at B=256 (M = 50432 tokens): qkv is 44.6 GFLOP against
// 43 MB moved, fc1 59.5 GFLOP: at 989 TFLOP/s bf16 every product of the
// chain is compute-bound (about 300 operations per byte for the large ones),
// so the design keeps the tensor cores fed from shared memory and moves each
// operand through device memory once; the prologue and the epilogue's
// stores are bound by bytes.
//
// Widths the kernel takes: K a multiple of 32, N a multiple of 8, contiguous
// 16-byte-aligned buffers, W T [N, K] (torch's Linear layout). The
// Python wrapper (acmil_tpu_torch/ops/vit_layer.py) checks them and raises.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"        // TMA, mbarriers, wgmma, the tensor-map encoder
#include "vit_rows.cuh"      // the LayerNorm prologue, gelu, the epilogues

namespace {

constexpr int kBM = 128;          // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;          // columns of a tile
constexpr int kBK = 64;           // depth of a stage: one 128-byte row of T
constexpr int kStages = 4;
constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBM * kBK * 2;          // one operand tile
constexpr uint32_t kStageBytes = 2 * kTileBytes;
// a consumer warpgroup's 64 x 128 f32 accumulators, staged for the
// epilogue; 8 words of padding keep the pair writes free of bank conflicts
constexpr int kOutStride = kBN + 8;
constexpr uint32_t kOutBytes = 64 * kOutStride * 4;
constexpr int kSmemBytes = kStages * kStageBytes + kConsumers * kOutBytes +
                           1024 + 2 * kStages * 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// d (+)= a b^T for one k16 step of a 64 x 128 tile: A (64 rows of the
// activations) and B (128 rows of W, K-major) by descriptor, f32 sums in
// 64 registers a thread (the m64n128 accumulator layout); T operands (TY:
// "bf16" or "f16").
#define WGMMA_M64N128K16(TY)                                                \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %66, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63"                              \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                 \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                 \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                 \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                 \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                 \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                 \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                 \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                 \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, f16>::value) WGMMA_M64N128K16("f16");
  else WGMMA_M64N128K16("bf16");
}

struct EpilogueArgs {
  const float* bias;   // [N]
  const float* ls;     // [N] or null
  const void* res;     // [M, N] or null: T or f32
  void* out;           // [M, N]: T or f32
  int res_f32, out_f32;
};

// Four adjacent columns (col .. col + 3) of one row through epilogue
// kEpi, stored as f32 or T: a are the accumulators, b and g the bias and
// layerscale of those columns, r the residual (epilogues 2 and 3).
template <typename T, int kEpi>
__device__ __forceinline__ void epilogue_quad(const EpilogueArgs& e, int row,
                                              int col, int n_cols, float4 a,
                                              float4 b, float4 g, float4 r) {
  const size_t off = static_cast<size_t>(row) * n_cols + col;
  const float y[4] = {epilogue_value<kEpi>(a.x, b.x, g.x, r.x),
                      epilogue_value<kEpi>(a.y, b.y, g.y, r.y),
                      epilogue_value<kEpi>(a.z, b.z, g.z, r.z),
                      epilogue_value<kEpi>(a.w, b.w, g.w, r.w)};
  if (e.out_f32)
    store4(static_cast<float*>(e.out) + off, y);
  else
    *reinterpret_cast<uint2*>(static_cast<T*>(e.out) + off) = pack4<T>(y);
}

// The residual of four adjacent columns of one row as it lies in memory
// (f32: all of it; T: x and y), loaded without waiting for it.
template <typename T>
__device__ __forceinline__ uint4 load_residual(const EpilogueArgs& e,
                                               size_t off) {
  if (e.res_f32)
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const float*>(e.res) + off));
  const uint2 v =
      __ldg(reinterpret_cast<const uint2*>(static_cast<const T*>(e.res) + off));
  return make_uint4(v.x, v.y, 0u, 0u);
}

// ... and as four f32 values.
template <typename T>
__device__ __forceinline__ float4 residual_f32(const EpilogueArgs& e,
                                               uint4 raw) {
  if (e.res_f32)
    return make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                       __uint_as_float(raw.z), __uint_as_float(raw.w));
  float v[4];
  load4(reinterpret_cast<const T*>(&raw), v);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Persistent, warp-specialised: see the header. kEpi is the epilogue (a
// template argument, so that the bias and gelu epilogues hold no residual
// registers). Shared memory: the stages'
// A tiles, then their W tiles, then each consumer warpgroup's staged
// accumulators (all 1024-byte aligned), then the full and empty mbarriers.
template <typename T, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,   // A T [M, K]
            const __grid_constant__ CUtensorMap map_w,   // W T [N, K]
            EpilogueArgs e, int m_rows, int n_cols, int k_depth) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t tiles_a = base;
  const uint32_t tiles_w = base + kStages * kTileBytes;
  const uint32_t staged = tiles_w + kStages * kTileBytes;
  const uint32_t full = staged + kConsumers * kOutBytes;
  const uint32_t empty = full + kStages * 8;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = (n_cols + kBN - 1) / kBN;
  const int tiles = ((m_rows + kBM - 1) / kBM) * tiles_n;
  const int k_steps = (k_depth + kBK - 1) / kBK;

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM;
        const int n0 = (t % tiles_n) * kBN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);   // the consumers freed it
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load(tiles_a + stage * kTileBytes, &map_a, full + 8 * stage,
                   ks * kBK, m0);
          tma_load(tiles_w + stage * kTileBytes, &map_w, full + 8 * stage,
                   ks * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wrow = 16 * (warp % 4) + lane / 4;   // this lane's first row
    const int wcol = 2 * (lane % 4);               // and first column
    float* out_tile = reinterpret_cast<float*>(
        smem_raw + (staged - smem_addr(smem_raw)) + wg * kOutBytes);
    constexpr int kRowsPerWarp = 64 / 4;           // of the epilogue
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM;
      const int n0 = (t % tiles_n) * kBN;
      // the epilogue's lane: rows row0 + 4 i of the tile, four columns from
      // col; its residuals are requested now and arrive during the products
      const int col = n0 + 4 * lane;
      const int row0 = m0 + 64 * wg + warp % 4;
      uint4 res[kRowsPerWarp];
      if constexpr (kEpi >= kResBias) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          res[i] = make_uint4(0u, 0u, 0u, 0u);
          if (col < n_cols && row0 + 4 * i < m_rows)
            res[i] = load_residual<T>(
                e, static_cast<size_t>(row0 + 4 * i) * n_cols + col);
        }
      }
      int held = -1;                                // stage still being read
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da =
            sw128_desc(tiles_a + stage * kTileBytes + wg * (kTileBytes / 2));
        const uint64_t dw = sw128_desc(tiles_w + stage * kTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)    // +2: a k16 step, 32 bytes
          wgmma_m64n128k16<T>(acc, da + 2 * kk, dw + 2 * kk, ks > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();   // the previous stage's products are done
        if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + 8 * held);

      // the epilogue: stage the accumulators (acc[4j + 2h + c] is row
      // wrow + 8h, column 8j + wcol + c of this warpgroup's 64 x 128 tile)
      // in shared memory, then each warp takes whole rows, four columns a
      // lane, so that every store is 16 or 8 contiguous bytes of a row
      named_barrier(1 + wg, 128);                   // the last tile is read
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out_tile + (wrow + 8 * h) * kOutStride +
                                     8 * j + wcol) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      named_barrier(1 + wg, 128);
      if (col < n_cols) {                           // N % 8 == 0: all four
        const float4 b = *reinterpret_cast<const float4*>(e.bias + col);
        const float4 g = e.ls != nullptr
                             ? *reinterpret_cast<const float4*>(e.ls + col)
                             : make_float4(1.f, 1.f, 1.f, 1.f);
        float4 a[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              out_tile + (warp % 4 + 4 * i) * kOutStride + 4 * lane);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kEpi >= kResBias) r = residual_f32<T>(e, res[i]);
          if (row0 + 4 * i < m_rows)
            epilogue_quad<T, kEpi>(e, row0 + 4 * i, col, n_cols, a[i], b, g, r);
        }
      }
    }
  }
}

// The map of a row-major [rows, k] matrix of 2-byte elements (bf16, or
// fp16 with half), read in 128-row x 64-column boxes with the 128-byte
// swizzle; elements past the edges read as 0.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int k, bool half) {
  return make_sw128_map(map, half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, ptr, rows, k, kBK, kBM);
}

template <typename T, int kEpi>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_w,
                        const EpilogueArgs& e, int m, int n, int k, int grid,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  gemm_kernel<T, kEpi><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_w, e,
                                                               m, n, k);
  return cudaGetLastError();
}

// The prologue (if any) and the product at element type T.
template <typename T>
cudaError_t run(const void* a, int a_f32, const float* ln_scale,
                const float* ln_bias, void* a_rows, const void* w,
                const EpilogueArgs& e, int epilogue, int m, int n, int k,
                cudaStream_t st) {
  const bool ln = ln_scale != nullptr;
  cudaError_t err = cudaSuccess;
  const void* a_t = a;
  if (ln || a_f32) {
    T* rows = static_cast<T*>(a_rows);
    if (a_f32)
      err = ln ? launch_prologue<float, T, true>(a, ln_scale, ln_bias, rows, m, k, st)
               : launch_prologue<float, T, false>(a, nullptr, nullptr, rows, m, k, st);
    else
      err = launch_prologue<T, T, true>(a, ln_scale, ln_bias, rows, m, k, st);
    if (err != cudaSuccess) return err;
    a_t = rows;
  }
  constexpr bool kHalfT = std::is_same<T, f16>::value;
  CUtensorMap map_a, map_w;
  if (!make_map(&map_a, a_t, m, k, kHalfT) ||
      !make_map(&map_w, w, n, k, kHalfT))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  switch (epilogue) {
    case kBias:
      return launch_gemm<T, kBias>(map_a, map_w, e, m, n, k, grid, st);
    case kBiasGelu:
      return launch_gemm<T, kBiasGelu>(map_a, map_w, e, m, n, k, grid, st);
    case kResBias:
      return launch_gemm<T, kResBias>(map_a, map_w, e, m, n, k, grid, st);
    default:
      return launch_gemm<T, kBiasLsRes>(map_a, map_w, e, m, n, k, grid, st);
  }
}

}  // namespace

extern "C" {

// Launches the GEMM on `stream` at element type T: bf16 (half = 0) or fp16
// (half = 1). A is [m, k] T (a_f32 = 0) or f32; ln_scale/ln_bias [k] turn
// the LayerNorm prologue on (both null: off); a_rows is a T [m, k]
// workspace for the prologue's rows, needed when the prologue is on or A is
// f32 (else null: the product reads A itself); w [n, k] T; bias [n] f32; ls
// [n] f32 or null; res [m, n] T or f32 (epilogues 2 and 3); out [m, n] T
// (out_f32 = 0) or f32. All device pointers, contiguous and 16-byte
// aligned. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for widths it does not take).
int vit_gemm(const void* a, int a_f32, const float* ln_scale,
             const float* ln_bias, void* a_rows, const void* w,
             const float* bias, const float* ls, const void* res, int res_f32,
             void* out, int out_f32, int epilogue, int m, int n, int k,
             int half, void* stream) {
  const bool ln = ln_scale != nullptr;
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 || n % 8 || epilogue < kBias ||
      epilogue > kBiasLsRes || (epilogue >= kResBias && res == nullptr) ||
      ((ln || a_f32) && a_rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EpilogueArgs e{bias, ls, res, out, res_f32, out_f32};
  return static_cast<int>(
      half ? run<f16>(a, a_f32, ln_scale, ln_bias, a_rows, w, e, epilogue, m,
                      n, k, st)
           : run<bf16>(a, a_f32, ln_scale, ln_bias, a_rows, w, e, epilogue, m,
                       n, k, st));
}

}  // extern "C"
