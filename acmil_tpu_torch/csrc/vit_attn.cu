// Kernels B5' and B7: multi-head attention for Hopper (sm_90a).
//
// B5' replaces the Pallas TPU kernel acmil_tpu/ops/vit_attn_packed.py::
// _packed_kernel, which fused_mha_packed launches, and serves as the
// attention step of kernels B3 and B4 (acmil_tpu/ops/vit_layer.py::
// _layer_kernel and _attn_half_kernel). From the token-major output of a
// ViT's fused qkv projection it computes, per image b and head h,
//
//   q, k, v = qkv[b, :, h*dh : (h+1)*dh] of the q, k and v thirds
//   s       = (q k^T) * scale,  keys >= N masked to -inf              (f32)
//   p       = exp(s - max s) / sum exp(s - max s), rounded to T
//   o[b, :, h*dh : (h+1)*dh] = p v   (f32 sums, stored as T)
//
// where T, the operands' type, is bf16 or fp16: the tensor cores' rate is
// the same for both (989 TFLOP/s dense), and every route below is one
// template over T that differs only in the instructions' type (mma.sync
// and wgmma .bf16 or .f16) and in the rounding of p and o (to nearest).
//
// with scale = 1/sqrt(dh), so heads are split inside the kernel and no
// [B, H, N, dh] copy of q, k, v or o reaches device memory. p is rounded
// after the normalisation and before the product with v, exactly where the
// TPU kernels round it (vit_attn_packed.py:66, vit_attn.py:62); a one-pass
// flash form would round the unnormalised exp(s - m_j) instead.
//
// B7 replaces acmil_tpu/ops/vit_attn.py::_mha_kernel (fused_vit_attention):
// the same function with q, k and v given as separate [B, H, N, dh] tensors
// and a caller's scale. Both entries run one kernel, which reads each
// operand through strides: element (b, h, t, d) of an operand lies at
// base + b*sb + h*sh + t*st + d. The packed entry passes the strides of the
// qkv layout, the B7 entry those of its tensors, so any layout whose rows
// are contiguous and 16-byte aligned works without a copy.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s), counting q, k, v read
// once and o written once, and the two products QK^T and PV:
//   ViT-S/16, B=256 (N=197, 6 heads of 64): 155 MB -> 46.2 us; 15.3 GFLOP
//     -> 15.4 us: bound by bytes. This is Step2's main path (inside B3).
//   UNI, B=32 (N=197, 16 heads of 64): 51.6 MB -> 15.4 us; 5.1 us of
//     products: bound by bytes.
//   CLIP-L/336, B=32 (N=577, 16 heads of 64): 151 MB -> 45.2 us; 43.6 GFLOP
//     -> 44.1 us: at the ridge.
//   ViT-S/8 (N=785, 6 heads of 64): 392 FLOP a byte: bound by operations.
// So each head's q, k and v are read once from device memory, the products
// stay on the tensor cores, and neither the scores nor p touch shared
// memory. The rounding contract (p rounded after the normalisation) needs
// every row's max and sum before any p: the scores are either held in
// registers until they are known (one pass) or formed twice (two passes).
//
// Design. One block per (head, image). It copies the head's keys and values
// whole into shared memory with cp.async (16-byte copies; rows past N
// zero-filled, as 0 * NaN would poison p v), keys as one copy group and
// values as a second, so the values arrive while the scores are formed;
// other blocks on the SM overlap one block's copies with their products.
// Rows are 16-byte units XOR-swizzled by the row (the 128-byte swizzle at
// dh = 64), so that ldmatrix phases and wgmma reads meet no bank conflict.
// q becomes A fragments in registers. p =
// 2^(s*scale*log2e - m) * (1/l) is formed in registers, rounded to T and
// fed back as the A operand of p v (the C layout of two n8 score tiles is
// the A layout of one k16 step); row max and sum take two shuffles over the
// 4 lanes that share a row. Three routes:
//   Warpgroup, one pass (dh = 64, N in [145, 208]: every 224-px ViT at
//     N=197). A warpgroup takes 64-query tiles in turn: wgmma
//     m64n208k16 forms the tile's scores against all 208 (padded) keys in
//     104 registers a thread, from q in registers and keys by a shared-
//     memory descriptor; p v is wgmma m64n64k16 with p from registers and
//     values by descriptor (transposed B). The next tile's queries are
//     copied into shared memory while the current tile is computed (the
//     first with the keys) and read by ldmatrix. One warpgroup a block,
//     three blocks an SM.
//   Warpgroup, split (dh = 64, N in [209, 624]: CLIP-L/336's 577). One
//     warpgroup per 208-key step, all on one 64-query tile; the rows' maxima
//     and sums meet in shared memory, each warpgroup forms p v over its
//     keys, and the partial sums are added in f32: still one pass.
//   mma.sync, two passes (every other N or dh, ViT-S/8's 785). Warps take
//     16-query tiles; pass 1 forms the scores in 64-key steps with
//     mma.sync.m16n8k16 and ldmatrix and keeps each row's running max and
//     sum, pass 2 forms them again for p and runs p v. Up to 16 warps (8
//     at dh=128) share the resident keys; when the keys do not fit (N >
//     896 at dh=64, > 448 at dh=128) they are streamed in spans as large
//     as shared memory holds.
// Keys are padded to the next 16 on the mma.sync route and to the next 208
// on the warpgroup routes (197 -> 208, 577 -> 624).
//
// Widths the kernel takes: bf16 or fp16 operands with dh in {16, 32, 64,
// 128}, each row of dh elements contiguous and 16-byte aligned. The Python
// wrappers (acmil_tpu_torch/ops/vit_attn_packed.py, ops/vit_attn.py) check
// them and send float32 and other head widths to B7's fma route
// (csrc/vit_attn_generic.cu).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the operands' type T (bf16 or f16) names the tensor-core instructions
template <typename T>
constexpr bool kHalf = std::is_same<T, f16>::value;

// The warpgroup routes (dh = 64): 64-query tiles against steps of 13
// chunks (208 keys), one warpgroup a step, for N in [145, 624]
constexpr int kWgChunks = 13;
constexpr int kWgKeys = 16 * kWgChunks;
constexpr int kWgMinChunks = 10;
constexpr int kWgMaxSteps = 3;
constexpr uint32_t kWgStepBytes = kWgKeys * 64 * 2;
constexpr uint32_t kQTileBytes = 64 * 64 * 2;     // a 64-query tile
constexpr int kTwoPassWarps = 16;      // mma.sync route: 8 at dh = 128
constexpr int kStepChunks = 4;         // mma.sync route: 64 keys a step
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// The kernel's routes: warpgroup products in one pass over the keys, on
// one warpgroup (N <= 208) or split over a warpgroup per key step (N <=
// 624), at dh = 64; mma.sync in two passes everywhere else.
enum Route { kMmaSync = 0, kWgOnePass = 1, kWgSplit = 2 };

// most warps a block of each route runs, and the blocks an SM should hold
template <int DH, int kRoute>
struct Config {
  static constexpr int kWarps =
      kRoute == kWgOnePass ? 4
      : kRoute == kWgSplit ? 4 * kWgMaxSteps
                           : (DH > 64 ? kTwoPassWarps / 2 : kTwoPassWarps);
  static constexpr int kMinBlocks = kRoute == kWgOnePass ? 3 : 1;
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte unit u of row r in a [rows, DH] tile of 2-byte
// elements. The unit
// is XOR-swizzled by the row so that the 8 rows an ldmatrix phase reads at
// one logical unit fall in 8 distinct 16-byte bank groups.
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int u) {
  constexpr int kUnits = DH / 8;
  const int x = kUnits >= 8 ? (r & 7) : ((r / (8 / kUnits)) & (kUnits - 1));
  return static_cast<uint32_t>(r * DH * 2 + ((u ^ x) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: T operands (TY: "bf16" or "f16"), f32
// sums
#define MMA16816(TY)                                                        \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"   \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kHalf<T>) MMA16816("f16"); else MMA16816("bf16");
}

// two f32 rounded to T (to nearest), as the low and high halves of a word
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Hopper's warpgroup products (wgmma). A warpgroup's four warps issue
// together; the sums land in registers asynchronously, so the registers
// are fenced before the first product and read only after the wait.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of x across a wgmma fence
// or wait.
template <int N, int M>
__device__ __forceinline__ void fence_operands(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

template <int N, int M, int L>
__device__ __forceinline__ void fence_operands(float (&x)[N][M][L]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operands(x[i]);
}

// The descriptor of a 128-byte-swizzled 2-byte operand in shared memory whose
// rows are 128 bytes (dh = 64) and whose 8-row atoms lie 1024 bytes apart:
// the layout swz<64> gives from a 1024-byte-aligned base. Both byte offsets
// are 1024 (the leading one is unused at these shapes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// s += q k^T for one k16 step of a 64-query tile against 208 keys: A (q)
// from registers, B (keys, dims contiguous: K-major) by descriptor; T
// operands (TY: "bf16" or "f16").
#define WGMMA_SCORES(TY)                                                    \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %109, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n208k16.f32." TY "." TY " "          \
      "{"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                            \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                            \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                            \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                            \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                            \
      "%96, %97, %98, %99, %100, %101, %102, %103"                          \
      "}, {%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"                 \
      : "+f"(s[0][0][0]), "+f"(s[0][0][1]), "+f"(s[0][0][2]), "+f"(s[0][0][3]), \
        "+f"(s[0][1][0]), "+f"(s[0][1][1]), "+f"(s[0][1][2]), "+f"(s[0][1][3]), \
        "+f"(s[1][0][0]), "+f"(s[1][0][1]), "+f"(s[1][0][2]), "+f"(s[1][0][3]), \
        "+f"(s[1][1][0]), "+f"(s[1][1][1]), "+f"(s[1][1][2]), "+f"(s[1][1][3]), \
        "+f"(s[2][0][0]), "+f"(s[2][0][1]), "+f"(s[2][0][2]), "+f"(s[2][0][3]), \
        "+f"(s[2][1][0]), "+f"(s[2][1][1]), "+f"(s[2][1][2]), "+f"(s[2][1][3]), \
        "+f"(s[3][0][0]), "+f"(s[3][0][1]), "+f"(s[3][0][2]), "+f"(s[3][0][3]), \
        "+f"(s[3][1][0]), "+f"(s[3][1][1]), "+f"(s[3][1][2]), "+f"(s[3][1][3]), \
        "+f"(s[4][0][0]), "+f"(s[4][0][1]), "+f"(s[4][0][2]), "+f"(s[4][0][3]), \
        "+f"(s[4][1][0]), "+f"(s[4][1][1]), "+f"(s[4][1][2]), "+f"(s[4][1][3]), \
        "+f"(s[5][0][0]), "+f"(s[5][0][1]), "+f"(s[5][0][2]), "+f"(s[5][0][3]), \
        "+f"(s[5][1][0]), "+f"(s[5][1][1]), "+f"(s[5][1][2]), "+f"(s[5][1][3]), \
        "+f"(s[6][0][0]), "+f"(s[6][0][1]), "+f"(s[6][0][2]), "+f"(s[6][0][3]), \
        "+f"(s[6][1][0]), "+f"(s[6][1][1]), "+f"(s[6][1][2]), "+f"(s[6][1][3]), \
        "+f"(s[7][0][0]), "+f"(s[7][0][1]), "+f"(s[7][0][2]), "+f"(s[7][0][3]), \
        "+f"(s[7][1][0]), "+f"(s[7][1][1]), "+f"(s[7][1][2]), "+f"(s[7][1][3]), \
        "+f"(s[8][0][0]), "+f"(s[8][0][1]), "+f"(s[8][0][2]), "+f"(s[8][0][3]), \
        "+f"(s[8][1][0]), "+f"(s[8][1][1]), "+f"(s[8][1][2]), "+f"(s[8][1][3]), \
        "+f"(s[9][0][0]), "+f"(s[9][0][1]), "+f"(s[9][0][2]), "+f"(s[9][0][3]), \
        "+f"(s[9][1][0]), "+f"(s[9][1][1]), "+f"(s[9][1][2]), "+f"(s[9][1][3]), \
        "+f"(s[10][0][0]), "+f"(s[10][0][1]), "+f"(s[10][0][2]), "+f"(s[10][0][3]), \
        "+f"(s[10][1][0]), "+f"(s[10][1][1]), "+f"(s[10][1][2]), "+f"(s[10][1][3]), \
        "+f"(s[11][0][0]), "+f"(s[11][0][1]), "+f"(s[11][0][2]), "+f"(s[11][0][3]), \
        "+f"(s[11][1][0]), "+f"(s[11][1][1]), "+f"(s[11][1][2]), "+f"(s[11][1][3]), \
        "+f"(s[12][0][0]), "+f"(s[12][0][1]), "+f"(s[12][0][2]), "+f"(s[12][0][3]), \
        "+f"(s[12][1][0]), "+f"(s[12][1][1]), "+f"(s[12][1][2]), "+f"(s[12][1][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),              \
        "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_scores(float (&s)[kWgChunks][2][4],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  if constexpr (kHalf<T>) WGMMA_SCORES("f16"); else WGMMA_SCORES("bf16");
}

// o += p v for one k16 step (16 keys) of a 64-query tile: A (p) from
// registers, B (values, dims contiguous: MN-major, so transposed) by
// descriptor; T operands (TY: "bf16" or "f16").
#define WGMMA_PV(TY)                                                        \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %37, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),         \
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),         \
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),         \
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),         \
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),         \
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),         \
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),         \
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),              \
        "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&o)[8][4],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  if constexpr (kHalf<T>) WGMMA_PV("f16"); else WGMMA_PV("bf16");
}

// Starts the copy of rows [row0, row0 + rows) of one head (rows st apart
// from src) into a swizzled shared tile; rows past n become zeros.
template <int DH, typename T>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src,
                                          long long st, int row0, int rows,
                                          int n) {
  constexpr int kUnits = DH / 8;
  for (int i = threadIdx.x; i < rows * kUnits; i += blockDim.x) {
    const int r = i / kUnits, u = i % kUnits;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + swz<DH>(r, u), src + (valid ? row : 0) * st + 8 * u,
               valid);
  }
}

// This lane's ldmatrix offsets in a shared key or value tile, for chunk 0;
// chunk c adds c * kChunkBytes (the swizzle repeats every 8 rows).
template <int DH>
struct LaneOffsets {
  static constexpr uint32_t kChunkBytes = 16 * DH * 2;
  uint32_t k[DH / 16];    // keys: matrices keys 0-7 x dims 0-7, 0-7 x 8-15,
                          // 8-15 x 0-7, 8-15 x 8-15 of each 16-dim block
  uint32_t v[DH / 16];    // values (.trans): keys 0-7 x dims 0-7, 8-15 x 0-7,
                          // 0-7 x 8-15, 8-15 x 8-15
  __device__ __forceinline__ explicit LaneOffsets(int lane) {
    const int kr = (lane & 7) + ((lane >> 4) << 3), ku = (lane >> 3) & 1;
    const int vr = (lane & 7) + (((lane >> 3) & 1) << 3), vu = lane >> 4;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      k[i] = swz<DH>(kr, 2 * i + ku);
      v[i] = swz<DH>(vr, 2 * i + vu);
    }
  }
};

// The A fragments of query rows [row0, row0 + 16) over all dh, straight
// from device memory; rows past n are zeros.
template <int DH, typename T>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4],
                                       const T* qh, long long st, int row0,
                                       int n, int lane) {
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
  const int c = 2 * (lane & 3);
  const unsigned* p0 = reinterpret_cast<const unsigned*>(qh + r0 * st + c);
  const unsigned* p1 = reinterpret_cast<const unsigned*>(qh + r1 * st + c);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qa[kk][0] = r0 < n ? __ldg(p0 + 8 * kk) : 0u;
    qa[kk][1] = r1 < n ? __ldg(p1 + 8 * kk) : 0u;
    qa[kk][2] = r0 < n ? __ldg(p0 + 8 * kk + 4) : 0u;
    qa[kk][3] = r1 < n ? __ldg(p1 + 8 * kk + 4) : 0u;
  }
}

// The same A fragments of rows 16w .. 16w + 15 of a shared 64-query tile
// (dh = 64): the values' lane offsets, read without .trans, give the
// matrices rows 0-7 x dims 0-7, rows 8-15 x 0-7, then dims 8-15.
__device__ __forceinline__ void load_q_shared(uint32_t (&qa)[4][4],
                                              uint32_t tile,
                                              const LaneOffsets<64>& lo,
                                              int w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(tile + w * LaneOffsets<64>::kChunkBytes + lo.v[kk], qa[kk]);
}

// -inf for the keys at or past n of a chunk whose first key is key0.
__device__ __forceinline__ void mask_chunk(float (&s)[2][4], int key0, int n,
                                           int lane) {
  if (key0 + 16 > n) {                     // the ragged last chunk only
    const int col = key0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + 8 * h + (i & 1) >= n) s[h][i] = -INFINITY;
  }
}

// The scores of a warp's 16 query rows against the 16 keys of each chunk
// c .. c + N - 1 of the shared key tile, as two n8 C fragments a chunk
// (rows g and g + 8), scaled into the log2 domain; for each k16 step the N
// chunks' products issue back to back.
template <typename T, int DH, int N>
__device__ __forceinline__ void scores(const uint32_t (&qa)[DH / 16][4],
                                       uint32_t kbase,
                                       const LaneOffsets<DH>& lo, int c,
                                       float c2, float (&s)[N][2][4]) {
  constexpr uint32_t kChunk = LaneOffsets<DH>::kChunkBytes;
#pragma unroll
  for (int cc = 0; cc < N; ++cc)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[cc][0][i] = s[cc][1][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int cc = 0; cc < N; ++cc) {
      uint32_t b[4];
      ldsm_x4(kbase + (c + cc) * kChunk + lo.k[kk], b);
      mma16816<T>(s[cc][0], qa[kk], b[0], b[1]);
      mma16816<T>(s[cc][1], qa[kk], b[2], b[3]);
    }
#pragma unroll
  for (int cc = 0; cc < N; ++cc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[cc][0][i] *= c2;
      s[cc][1][i] *= c2;
    }
}

// Masks the ragged chunk of s[N] (chunk i's first key is key0 + 16 i), then
// the row maxima m[0] (row g) and m[1] (row g + 8) over this lane's scores,
// reduced as a tree.
template <int N>
__device__ __forceinline__ void mask_and_max(float (&s)[N][2][4], int key0,
                                             int n, int lane, float (&m)[2]) {
  float t[N][2];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    mask_chunk(s[c], key0 + 16 * c, n, lane);
    t[c][0] = fmaxf(fmaxf(s[c][0][0], s[c][0][1]), fmaxf(s[c][1][0], s[c][1][1]));
    t[c][1] = fmaxf(fmaxf(s[c][0][2], s[c][0][3]), fmaxf(s[c][1][2], s[c][1][3]));
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int c = 0; c + w < N; c += 2 * w) {
      t[c][0] = fmaxf(t[c][0], t[c + w][0]);
      t[c][1] = fmaxf(t[c][1], t[c + w][1]);
    }
  m[0] = t[0][0];
  m[1] = t[0][1];
}

// s = 2^(s - m) in place, m[0] for row g and m[1] for row g + 8.
template <int N>
__device__ __forceinline__ void exp_rows(float (&s)[N][2][4],
                                         const float (&m)[2]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[c][h][0] = ex2(s[c][h][0] - m[0]);
      s[c][h][1] = ex2(s[c][h][1] - m[0]);
      s[c][h][2] = ex2(s[c][h][2] - m[1]);
      s[c][h][3] = ex2(s[c][h][3] - m[1]);
    }
}

// s = 2^(s - m) in place, and this lane's sums of each row, as a tree.
template <int N>
__device__ __forceinline__ void exp_and_sum(float (&s)[N][2][4],
                                            const float (&m)[2],
                                            float (&l)[2]) {
  float t[N][2];
  exp_rows<N>(s, m);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    t[c][0] = (s[c][0][0] + s[c][0][1]) + (s[c][1][0] + s[c][1][1]);
    t[c][1] = (s[c][0][2] + s[c][0][3]) + (s[c][1][2] + s[c][1][3]);
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int c = 0; c + w < N; c += 2 * w) {
      t[c][0] += t[c + w][0];
      t[c][1] += t[c + w][1];
    }
  l[0] = t[0][0];
  l[1] = t[0][1];
}

// p = 2^(s - m) of rows g and g + 8 times 1/l, rounded to T, as the A
// fragment of one k16 step of p v: the C layout of two n8 score tiles is
// the A layout.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&p)[2][4], float inv0,
                                       float inv1, uint32_t (&a)[4]) {
  a[0] = pack2<T>(p[0][0] * inv0, p[0][1] * inv0);
  a[1] = pack2<T>(p[0][2] * inv1, p[0][3] * inv1);
  a[2] = pack2<T>(p[1][0] * inv0, p[1][1] * inv0);
  a[3] = pack2<T>(p[1][2] * inv1, p[1][3] * inv1);
}

// o += p v for the 16 keys of chunk c, p given as its A fragment.
template <typename T, int DH>
__device__ __forceinline__ void chunk_pv(const uint32_t (&a)[4],
                                         uint32_t vbase,
                                         const LaneOffsets<DH>& lo, int c,
                                         float (&o)[DH / 8][4]) {
  const uint32_t base = vbase + c * LaneOffsets<DH>::kChunkBytes;
#pragma unroll
  for (int dd = 0; dd < DH / 16; ++dd) {
    uint32_t b[4];
    ldsm_x4_trans(base + lo.v[dd], b);
    mma16816<T>(o[2 * dd], a, b[0], b[1]);
    mma16816<T>(o[2 * dd + 1], a, b[2], b[3]);
  }
}

template <int DH, typename T>
__device__ __forceinline__ void store_o(const float (&o)[DH / 8][4], T* oh,
                                        long long st, int row0, int n,
                                        int lane) {
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(oh + r0 * st + 8 * j + c) =
          pack2<T>(o[j][0], o[j][1]);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(oh + r1 * st + 8 * j + c) =
          pack2<T>(o[j][2], o[j][3]);
  }
}

// Pass 1 over kCount chunks from chunk c of the shared keys: fold their
// scores into the running max m and this lane's share of the sum l (m is
// the same on the 4 lanes of a row, so the shares add up at the end).
template <typename T, int DH, int kCount>
__device__ __forceinline__ void stats_step(const uint32_t (&qa)[DH / 16][4],
                                           uint32_t kbase,
                                           const LaneOffsets<DH>& lo, int c,
                                           int key0, int n, float c2,
                                           int lane, float (&m)[2],
                                           float (&l)[2]) {
  float s[kCount][2][4], t[2], sum[2];
  scores<T, DH, kCount>(qa, kbase, lo, c, c2, s);
  mask_and_max<kCount>(s, key0, n, lane, t);
  // a step's first key is < n, so the new max is finite
  const float mn[2] = {fmaxf(m[0], quad_max(t[0])),
                       fmaxf(m[1], quad_max(t[1]))};
  exp_and_sum<kCount>(s, mn, sum);
  l[0] = l[0] * ex2(m[0] - mn[0]) + sum[0];   // m = -inf at first: 0 * 0
  l[1] = l[1] * ex2(m[1] - mn[1]) + sum[1];
  m[0] = mn[0];
  m[1] = mn[1];
}

// Pass 2 over kCount chunks from chunk c: the scores again, p, o += p v.
template <typename T, int DH, int kCount>
__device__ __forceinline__ void pv_step(const uint32_t (&qa)[DH / 16][4],
                                        uint32_t kbase, uint32_t vbase,
                                        const LaneOffsets<DH>& lo, int c,
                                        int key0, int n, float c2, int lane,
                                        const float (&m)[2], float inv0,
                                        float inv1, float (&o)[DH / 8][4]) {
  float s[kCount][2][4];
  scores<T, DH, kCount>(qa, kbase, lo, c, c2, s);
#pragma unroll
  for (int cc = 0; cc < kCount; ++cc)
    mask_chunk(s[cc], key0 + 16 * cc, n, lane);
  exp_rows<kCount>(s, m);
#pragma unroll
  for (int cc = 0; cc < kCount; ++cc) {
    uint32_t a[4];
    pack_p<T>(s[cc], inv0, inv1, a);
    chunk_pv<T, DH>(a, vbase, lo, c + cc, o);
  }
}

// The scores of a warpgroup's 64-query tile against key step j (chunks
// 13j .. 13j + 12 of the shared keys), 104 registers a thread in the C
// layout of 26 n8 tiles, scaled into the log2 domain; this warp's A
// fragments (q) from registers.
template <typename T>
__device__ __forceinline__ void wg_scores(const uint32_t (&qa)[4][4],
                                          uint32_t kbase, int j, float c2,
                                          float (&s)[kWgChunks][2][4]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)               // 32 bytes of dims a step;
    wgmma_scores<T>(s, qa[kk],                    // the first overwrites s
                 sw128_desc(kbase + j * kWgStepBytes + 32 * kk), kk);
  wgmma_commit_and_wait();
  fence_operands(s);
#pragma unroll
  for (int c = 0; c < kWgChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[c][0][i] *= c2;
      s[c][1][i] *= c2;
    }
}

// Shared memory where the warpgroups of a split tile meet: each row's max
// and sum over every key step, and the partial p v of steps 1 and 2, laid
// out [step - 1][value][thread] so that a warp's stores hit 32 banks.
struct WgExchange {
  float max[kWgMaxSteps][64], sum[kWgMaxSteps][64];
  float o[kWgMaxSteps - 1][32][128];
};

// One 64-query tile in one pass on warpgroups (dh = 64). Warpgroup `group`
// holds key step `group` (208 keys) of the scores in 104 registers a thread;
// with several (kSplit: N in [209, 624]) the rows' maxima and sums meet in
// shared memory, each warpgroup forms p v over its own keys, and warpgroup
// 0 adds the partial sums and stores. This warp's rows are row0 .. row0 +
// 15 (qa), rows 16 (warp % 4) .. of the tile. The caller waits for the keys
// before; wait_values runs on every thread.
template <bool kSplit, typename T, typename WaitValues>
__device__ __forceinline__ void wg_tile(const uint32_t (&qa)[4][4],
                                        uint32_t kbase, uint32_t vbase, int n,
                                        float c2, int lane, int group,
                                        int groups, WgExchange* x,
                                        WaitValues wait_values, T* orow,
                                        long long st, int row0) {
  float s[kWgChunks][2][4], m[2], l[2];
  wg_scores<T>(qa, kbase, group, c2, s);
  mask_and_max<kWgChunks>(s, kWgKeys * group, n, lane, m);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  // this thread's rows within the tile; one lane of four writes them
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), r1 = r0 + 8;
  if constexpr (kSplit) {
    if ((lane & 3) == 0) {
      x->max[group][r0] = m[0];
      x->max[group][r1] = m[1];
    }
    __syncthreads();
    for (int w = 0; w < groups; ++w) {
      m[0] = fmaxf(m[0], x->max[w][r0]);
      m[1] = fmaxf(m[1], x->max[w][r1]);
    }
  }
  exp_and_sum<kWgChunks>(s, m, l);
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if constexpr (kSplit) {
    if ((lane & 3) == 0) {
      x->sum[group][r0] = l[0];
      x->sum[group][r1] = l[1];
    }
    __syncthreads();
    l[0] = l[1] = 0.0f;
    for (int w = 0; w < groups; ++w) {         // in step order on every group
      l[0] += x->sum[w][r0];
      l[1] += x->sum[w][r1];
    }
  }
  const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
  // p, packed to T as soon as l is known: half the registers of s
  uint32_t pa[kWgChunks][4];
#pragma unroll
  for (int c = 0; c < kWgChunks; ++c) pack_p<T>(s[c], inv0, inv1, pa[c]);
  wait_values();
  float acc[8][4];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kWgChunks; ++c)          // 16 keys of 128 bytes a step;
    wgmma_pv<T>(acc, pa[c],                       // the first overwrites acc
             sw128_desc(vbase + group * kWgStepBytes + 2048 * c), c);
  wgmma_commit_and_wait();
  fence_operands(acc);
  if constexpr (kSplit) {
    const int t = threadIdx.x & 127;
    if (group > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x->o[group - 1][4 * j + i][t] = acc[j][i];
    }
    __syncthreads();
    if (group == 0) {
      for (int w = 1; w < groups; ++w)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += x->o[w - 1][4 * j + i][t];
      store_o<64>(acc, orow, st, row0, n, lane);
    }
    __syncthreads();                           // x is free for the next tile
  } else {
    store_o<64>(acc, orow, st, row0, n, lane);
  }
}

// Grid (1, heads, batch): one block per (head, image). On the warpgroup
// route its blockDim.x / 128 warpgroups take the head's 64-query tiles in
// turn; on the mma.sync route its blockDim.x / 32 warps take the 16-query
// tiles in turn.
// Shared memory, from a 1024-byte-aligned base: keys then values,
// span_rows rows each, every key resident when span_rows covers them, else
// streamed span by span.
template <typename T, int DH, int kRoute>
__global__ void __launch_bounds__(32 * Config<DH, kRoute>::kWarps,
                                  Config<DH, kRoute>::kMinBlocks)
mha_kernel(Strided<const T> q, Strided<const T> k, Strided<const T> v,
           Strided<T> o, int n, float scale, int span_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const LaneOffsets<DH> lo(lane);
  const T* qh = q.head(b, head);
  const T* kh = k.head(b, head);
  const T* vh = v.head(b, head);
  T* oh = o.head(b, head);
  const uint32_t kbase = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t vbase = kbase + span_rows * DH * 2;
  const int chunks = (n + 15) / 16;        // 16-key chunks = 16-query tiles
  const int span = span_rows / 16;         // chunks a shared span holds
  const bool resident = span >= chunks;
  const float c2 = scale * kLog2e;

  if (resident) {                          // keys: group 0, values: group 1
    // the warpgroup routes form scores for whole key steps (zero rows past
    // n), and copy the first tile's queries with the keys
    const int rows = kRoute != kMmaSync
                         ? kWgKeys * ((chunks + kWgChunks - 1) / kWgChunks)
                         : 16 * chunks;
    load_rows<DH>(kbase, kh, k.st, 0, rows, n);
    if constexpr (kRoute != kMmaSync)
      load_rows<DH>(vbase + span_rows * DH * 2, qh, q.st, 0, 64, n);
    cp_async_commit();
    load_rows<DH>(vbase, vh, v.st, 0, rows, n);
    cp_async_commit();
  }
  // the copies are read by ldmatrix and by wgmma (the async proxy)
  auto wait_keys = [] {
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  auto wait_values = [] {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  if constexpr (kRoute != kMmaSync) {
    // every key resident; one warpgroup per 208-key step, all on one
    // 64-query tile at a time, whose queries were copied to qbuf during the
    // previous tile (the first with the keys)
    const uint32_t qbuf = vbase + span_rows * DH * 2;
    WgExchange* x = reinterpret_cast<WgExchange*>(
        smem + (qbuf + 2 * kQTileBytes - smem_addr(smem)));
    const int tiles = (n + 63) / 64;
    for (int t = 0; t < tiles; ++t) {
      if (t == 0) cp_async_wait<1>(); else cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                     // and the previous tile is done
      if (t + 1 < tiles)
        load_rows<64>(qbuf + ((t + 1) & 1) * kQTileBytes, qh, q.st,
                      64 * (t + 1), 64, n);
      cp_async_commit();
      uint32_t qa[4][4];
      load_q_shared(qa, qbuf + (t & 1) * kQTileBytes, lo, warp % 4);
      wg_tile<kRoute == kWgSplit>(
          qa, kbase, vbase, n, c2, lane, warp / 4, warps / 4, x,
          [&] { if (t == 0) wait_values(); }, oh, o.st,
          64 * t + 16 * (warp % 4));
    }
  } else {
    const int rounds = (chunks + warps - 1) / warps;
    for (int r = 0; r < rounds; ++r) {
      const int tile = r * warps + warp;
      const bool active = tile < chunks;     // the same on every lane
      uint32_t qa[DH / 16][4];
      if (active) load_q<DH>(qa, qh, q.st, 16 * tile, n, lane);
      // pass 1: each row's max m and sum l over all keys
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
      for (int c0 = 0; c0 < chunks; c0 += span) {
        const int c1 = min(chunks, c0 + span);
        if (!resident) {
          __syncthreads();                 // the previous span is consumed
          load_rows<DH>(kbase, kh, k.st, 16 * c0, 16 * (c1 - c0), n);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        } else if (r == 0) {
          wait_keys();
        }
        if (active) {
          int c = c0;
          for (; c + kStepChunks <= c1; c += kStepChunks)
            stats_step<T, DH, kStepChunks>(qa, kbase, lo, c - c0, 16 * c, n, c2,
                                        lane, m, l);
          for (; c < c1; ++c)
            stats_step<T, DH, 1>(qa, kbase, lo, c - c0, 16 * c, n, c2, lane, m,
                              l);
        }
      }
      const float inv0 = 1.0f / quad_sum(l[0]);
      const float inv1 = 1.0f / quad_sum(l[1]);
      // pass 2: p = exp(s - m) / l rounded to T, then o += p v
      float acc[DH / 8][4] = {};
      for (int c0 = 0; c0 < chunks; c0 += span) {
        const int c1 = min(chunks, c0 + span);
        if (!resident) {
          __syncthreads();
          load_rows<DH>(kbase, kh, k.st, 16 * c0, 16 * (c1 - c0), n);
          load_rows<DH>(vbase, vh, v.st, 16 * c0, 16 * (c1 - c0), n);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        } else if (r == 0) {
          wait_values();
        }
        if (active) {
          int c = c0;
          for (; c + kStepChunks <= c1; c += kStepChunks)
            pv_step<T, DH, kStepChunks>(qa, kbase, vbase, lo, c - c0, 16 * c, n,
                                     c2, lane, m, inv0, inv1, acc);
          for (; c < c1; ++c)
            pv_step<T, DH, 1>(qa, kbase, vbase, lo, c - c0, 16 * c, n, c2, lane,
                           m, inv0, inv1, acc);
        }
      }
      if (active) store_o<DH>(acc, oh, o.st, 16 * tile, n, lane);
    }
  }
}

// How a launch at (n, dh) is shaped: the route, warps a block, and the rows
// of keys (and of values) one shared span holds.
struct Shape {
  Route route;
  int warps, span_rows;
  // with 1024 bytes to align the base, and where the warpgroups meet
  int smem(int dh) const {
    return 2 * span_rows * dh * 2 + 1024 +
           (route != kMmaSync ? 2 * static_cast<int>(kQTileBytes) : 0) +
           (route == kWgSplit ? static_cast<int>(sizeof(WgExchange)) : 0);
  }
  int rows(int n) const {                      // key rows the kernel reads
    const int chunks = (n + 15) / 16;
    return route != kMmaSync
               ? kWgKeys * ((chunks + kWgChunks - 1) / kWgChunks)
               : 16 * chunks;
  }
};

Shape shape_for(int n, int dh) {
  const int chunks = (n + 15) / 16;
  const int steps = (chunks + kWgChunks - 1) / kWgChunks;
  Shape s;
  s.route = dh != 64 || chunks < kWgMinChunks || steps > kWgMaxSteps
                ? kMmaSync
                : (steps == 1 ? kWgOnePass : kWgSplit);
  if (s.route != kMmaSync) {
    s.warps = 4 * steps;                       // a warpgroup per key step
  } else {
    const int max_warps = dh > 64 ? kTwoPassWarps / 2 : kTwoPassWarps;
    const int rounds = (chunks + max_warps - 1) / max_warps;
    s.warps = (chunks + rounds - 1) / rounds;
  }
  // rows of k and v that fit beside the 1024 bytes of alignment
  const int cap = (kMaxSmem - 1024) / (4 * dh) / 16 * 16;
  s.span_rows = s.rows(n) <= cap ? s.rows(n) : cap;
  return s;
}

template <typename T, int DH, int kRoute>
cudaError_t launch(Strided<const T> q, Strided<const T> k, Strided<const T> v,
                   Strided<T> o, int batch, int heads, int n, float scale,
                   const Shape& s, cudaStream_t stream) {
  const int smem = s.smem(DH);
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T, DH, kRoute>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(1, heads, batch);
  mha_kernel<T, DH, kRoute><<<grid, 32 * s.warps, smem, stream>>>(
      q, k, v, o, n, scale, s.span_rows);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_route(Strided<const T> q, Strided<const T> k,
                         Strided<const T> v, Strided<T> o, int batch,
                         int heads, int n, float scale, cudaStream_t stream) {
  const Shape s = shape_for(n, DH);
  if constexpr (DH == 64) {
    if (s.route == kWgOnePass)
      return launch<T, DH, kWgOnePass>(q, k, v, o, batch, heads, n, scale, s,
                                       stream);
    if (s.route == kWgSplit)
      return launch<T, DH, kWgSplit>(q, k, v, o, batch, heads, n, scale, s,
                                     stream);
  }
  return launch<T, DH, kMmaSync>(q, k, v, o, batch, heads, n, scale, s,
                                 stream);
}

template <typename T>
cudaError_t launch_dh(int dh, Strided<const T> q, Strided<const T> k,
                      Strided<const T> v, Strided<T> o, int batch, int heads,
                      int n, float scale, cudaStream_t stream) {
  if (n < 1 || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_route<T, 16>(q, k, v, o, batch, heads, n, scale, stream);
    case 32: return launch_route<T, 32>(q, k, v, o, batch, heads, n, scale, stream);
    case 64: return launch_route<T, 64>(q, k, v, o, batch, heads, n, scale, stream);
    case 128: return launch_route<T, 128>(q, k, v, o, batch, heads, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// B5' on the packed qkv layout of T elements
template <typename T>
cudaError_t launch_packed(const void* qkv, void* out, int batch, int n,
                          int dim, int heads, cudaStream_t stream) {
  const int dh = dim / heads;
  const T* in = static_cast<const T*>(qkv);
  const long long sb = static_cast<long long>(n) * 3 * dim;
  const Strided<const T> q{in, sb, dh, 3LL * dim};
  const Strided<const T> k{in + dim, sb, dh, 3LL * dim};
  const Strided<const T> v{in + 2 * dim, sb, dh, 3LL * dim};
  const Strided<T> o{static_cast<T*>(out), static_cast<long long>(n) * dim,
                     dh, dim};
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return launch_dh<T>(dh, q, k, v, o, batch, heads, n, scale, stream);
}

// B7 on separate strided q, k, v and out of T elements
template <typename T>
cudaError_t launch_strided(const void* q, const long long* qs, const void* k,
                           const long long* ks, const void* v,
                           const long long* vs, void* out,
                           const long long* os, int batch, int heads, int n,
                           int dh, float scale, cudaStream_t stream) {
  using In = Strided<const T>;
  const In qt{static_cast<const T*>(q), qs[0], qs[1], qs[2]};
  const In kt{static_cast<const T*>(k), ks[0], ks[1], ks[2]};
  const In vt{static_cast<const T*>(v), vs[0], vs[1], vs[2]};
  const Strided<T> ot{static_cast<T*>(out), os[0], os[1], os[2]};
  return launch_dh<T>(dh, qt, kt, vt, ot, batch, heads, n, scale, stream);
}

}  // namespace

extern "C" {

// Launches kernel B5' on `stream`: qkv [batch, n, 3*dim] -> out [batch, n,
// dim], bf16 (half = 0) or fp16 (half = 1), device pointers to contiguous
// 16-byte-aligned buffers. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a head width it is not compiled for).
int b5_mha_packed(const void* qkv, void* out, int batch, int n, int dim,
                  int heads, int half, void* stream) {
  if (heads <= 0 || dim % heads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      half ? launch_packed<f16>(qkv, out, batch, n, dim, heads, st)
           : launch_packed<bf16>(qkv, out, batch, n, dim, heads, st));
}

// Launches kernel B7 on `stream`: q, k, v [batch, heads, n, dh] -> out
// [batch, heads, n, dh], bf16 (half = 0) or fp16 (half = 1), each given by
// its device pointer and its (batch, head, token) strides in elements;
// every row of dh elements must be contiguous and 16-byte aligned. Returns
// the cudaError_t of the launch.
int b7_mha_strided(const void* q, long long q_sb, long long q_sh,
                   long long q_st, const void* k, long long k_sb,
                   long long k_sh, long long k_st, const void* v,
                   long long v_sb, long long v_sh, long long v_st, void* out,
                   long long o_sb, long long o_sh, long long o_st, int batch,
                   int heads, int n, int dh, float scale, int half,
                   void* stream) {
  const long long qs[3] = {q_sb, q_sh, q_st}, ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st}, os[3] = {o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      half ? launch_strided<f16>(q, qs, k, ks, v, vs, out, os, batch, heads,
                                 n, dh, scale, st)
           : launch_strided<bf16>(q, qs, k, ks, v, vs, out, os, batch, heads,
                                  n, dh, scale, st));
}

// How kernel B5'/B7 is launched at n tokens of head width dh: on warpgroup
// products (1) or mma.sync (0), in one pass over the keys or two, the warps
// of a block, its dynamic shared memory in bytes, and whether every key and
// value of a head is resident in it (1) or streamed in spans (0). Returns
// 0, or cudaErrorInvalidValue for an unknown dh.
int b5_launch_shape(int n, int dh, int* warpgroup, int* passes, int* warps,
                    int* smem, int* resident) {
  if (n < 1 || (dh != 16 && dh != 32 && dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_for(n, dh);
  *warpgroup = s.route != kMmaSync;
  *passes = s.route == kMmaSync ? 2 : 1;
  *warps = s.warps;
  *smem = s.smem(dh);
  *resident = s.span_rows >= s.rows(n);
  return 0;
}

}  // extern "C"
