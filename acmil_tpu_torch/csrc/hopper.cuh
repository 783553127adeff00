// Hopper's TMA, mbarrier and warpgroup-product (wgmma) primitives, and the
// host's tensor-map encoder, shared by the GEMMs of kernels B3 and B4:
// csrc/vit_gemm.cu (bf16 and fp16) and csrc/vit_gemm_f32.cu (f32,
// split-TF32). Both run the same skeleton: a persistent grid, one TMA
// producer thread keeping a ring of stages full through "full" and "empty"
// mbarriers, two consumer warpgroups issuing wgmma from the 128-byte
// swizzled stages.
//
// Internal linkage, as for the other headers: each library keeps its own
// copy.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// the producer's arrival, announcing the bytes TMA will complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 2-D tile from global memory into shared memory by TMA: columns
// c0.., rows c1.. of the map's tensor; out-of-bounds elements read as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Hopper's warpgroup products (wgmma), as in csrc/vit_attn.cu: a
// warpgroup's four warps issue together; the sums land in registers
// asynchronously, so the registers are fenced before the products and read
// only after the wait.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of x across a wgmma fence
// or wait (and keeps x in its registers up to this point).
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// The descriptor of a 128-byte-swizzled K-major operand in shared memory
// whose rows are 128 bytes (64 bf16/fp16 or 32 f32 elements of depth) and
// whose 8-row atoms lie 1024 bytes apart, as TMA's 128-byte swizzle writes
// it from a 1024-byte-aligned base (sw128_desc of csrc/vit_attn.cu). A
// 32-byte step of depth within the row (k16 at 2 bytes, k8 at 4) adds 2 to
// the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (so the library needs no link against libcuda); null if missing.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major [rows, k] matrix of `type`, read in boxes of
// box_rows rows and box_k elements of depth, with `swizzle`; elements past
// the edges read as 0.
bool make_tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                    size_t elem_bytes, const void* ptr, int rows, int k,
                    int box_k, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same with one 128-byte row of depth a box (box_k elements) and the
// 128-byte swizzle, as wgmma's descriptors (sw128_desc) read it.
bool make_sw128_map(CUtensorMap* map, CUtensorMapDataType type,
                    size_t elem_bytes, const void* ptr, int rows, int k,
                    int box_k, int box_rows) {
  return make_tiled_map(map, type, elem_bytes, ptr, rows, k, box_k, box_rows,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

}  // namespace
