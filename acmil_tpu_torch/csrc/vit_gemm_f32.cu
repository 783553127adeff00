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
// hi) (rounded to nearest, ties away: csrc/tf32x3.cuh's split), and a b =
// lo hi + hi lo + hi hi (the small terms first) on wgmma
// m64n128k8.f32.tf32.tf32 with f32 sums. wgmma reads an f32 operand as
// TF32 by dropping its low 13 bits, so raw f32 in shared memory is not hi:
// both splits are made explicitly.
//  - W: split_w_kernel turns W, once a call, into W_hi and W_lo ([2, N, K]
//    f32, TF32 values), each read by TMA through its own map. W is small
//    (1.77 M floats a ViT-S layer: ~21 MB moved by the split, a few
//    microseconds), so splitting it once beats splitting each staged tile.
//  - A: each consumer loads its raw A fragment from the staged tile and
//    splits it in registers, then issues wgmma with A in registers. The
//    other form, a warpgroup writing hi and lo tiles of A into shared
//    memory, adds ~110 GB/s of writes to an SM whose wgmma already reads
//    ~170 of its ~225 GB/s at the TF32 peak (A and B by descriptor); with
//    A in registers wgmma reads only W's tiles.
//  - Order of depth. A thread holds A's k slots t and t + 4 of each k8
//    step (t = lane % 4) for rows g and g + 8 (g = lane / 4 of its warp's
//    16). A sum does not depend on its order, so slot s of step j of a
//    32-deep stage is given column 8 (s % 4) + 2 j + s / 4: a thread's
//    eight A values of a row over the stage are then columns 8t .. 8t + 7,
//    two 16-byte loads, and the split kernel stores W_hi and W_lo with
//    each 32-wide slice of a row in that order (k_position).
//
// f32 accuracy. The tensor cores' f32 accumulation loses more than an f32
// sum over many terms (tf32x3.cuh's kFlush; a chain of 16 steps drifted
// to 1.4e-5 off float64 in csrc/vit_attn_f32.cu). So the products of
// kFlushStages stages (32 terms of depth each) go into a fresh set of
// accumulators (scale-d 0 on its first wgmma), added to the running sums
// in f32 once their wgmma group is waited for; 0 chains all of K on the
// tensor cores. PERF.md has what each depth gave against float64 and what
// it cost.
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
// busy, on the skeleton of csrc/vit_gemm.cu (csrc/hopper.cuh): a
// persistent grid of one block an SM walking 128 x 128 output tiles, N
// fastest; one TMA producer thread keeping a ring of three stages full
// (each the 128 x 32 tiles of A, W_hi and W_lo: 48 KB), on full and empty
// mbarriers; two consumer warpgroups of 64 rows each, 12 wgmma a stage
// (3 products x 4 k8 steps), registers moved to them by setmaxnreg; the
// epilogue staging each warpgroup's accumulators in shared memory (69.6
// KB; so the ring holds three stages, not four) and storing whole rows,
// 16 bytes a lane. A warpgroup loads and splits the next stage's A while
// the current stage's products run (two sets of A registers, in turn), so
// that its only step between two stages' products is the wait and the f32
// add. The residual's rows are prefetched to L2 at a tile's start. Ragged
// M and N are zero-filled by TMA and masked at the store.
//
// The bf16-A mode (vit_gemm_f32_bf16a). The MLP half of a bf16 trunk
// (acmil_tpu/models/encoders/fast.py::_mlp_half) multiplies bf16 rows (LN2's
// output, then gelu's, each rounded to bf16) by the f32 weights in f32. A
// bf16 value is exact in TF32, so A's lo is 0, the products lo hi add
// exact zeros, and a b = hi lo + hi hi: two TF32 products, the same bits as
// the three of the f32 mode on a.float() (the same order, the same
// flushes). A is staged by TMA as bf16 (a 32-deep stage is one 64-byte row:
// 8 KB a tile, stored unswizzled, whose 16-byte fragment loads, two rows of
// four chunks a quarter warp, meet no bank conflict) and widened to f32 in
// registers by a 16-bit shift. The LayerNorm prologue writes bf16 rows
// (_ln_f32(x).astype(bf16)); the residual is read as bf16 and the output
// stored as bf16 or f32. W, its split and the ring are the f32 mode's; a stage is 40
// KB, so the ring keeps three (four and the staged epilogue pass the 227
// KB).
//
// The SwiGLU epilogue (kBiasSwiGLU, the bf16-A mode only). A SwiGLU-packed
// fc1 (timm's SwiGLUPacked: W [N, K] whose first N / 2 rows are the gate's
// and last N / 2 the value's) gives out[:, j] = silu(g_j + b_j) (v_j +
// b_{N/2 + j}) at half width, with g and v the products of rows j and N /
// 2 + j. For one output tile to hold both, split_w_kernel gathers W's rows
// as it splits them: a 128-column tile t reads gate rows 64 t .. 64 t + 63
// and then value rows N / 2 + 64 t .. N / 2 + 64 t + 63 (swiglu_row), so
// that its staged accumulators hold 64 gates and their 64 values; each
// warp then writes 64 output columns of its rows (two rows at a time, four
// columns a lane), silu and the product in f32 and one rounding at the
// store. The bias is read as given, at both halves. N is a multiple of 128.
//
// Widths the kernel takes: K a multiple of 32, N a multiple of 8,
// contiguous 16-byte-aligned buffers, W [N, K] f32 (torch's Linear
// layout). The Python wrapper (acmil_tpu_torch/ops/vit_layer.py) checks
// them and raises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"        // TMA, mbarriers, wgmma, the tensor-map encoder
#include "tf32x3.cuh"        // the TF32 split
#include "vit_rows.cuh"      // the LayerNorm prologue, gelu, the epilogues

namespace {

constexpr int kBM = 128;          // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;          // columns of a tile
constexpr int kBK = 32;           // depth of a stage: one 128-byte row of f32
constexpr int kStages = 3;
constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBM * kBK * 4;          // one f32 operand tile
// a stage's A tile (f32, or bf16 in the bf16-A mode), then W_hi and W_lo
__host__ __device__ constexpr uint32_t a_tile_bytes(bool bf16_a) {
  return kBM * kBK * (bf16_a ? 2 : 4);
}
__host__ __device__ constexpr uint32_t stage_bytes(bool bf16_a) {
  return a_tile_bytes(bf16_a) + 2 * kTileBytes;
}
// a consumer warpgroup's 64 x 128 accumulators, staged for the epilogue; 8
// words of padding keep the pair writes free of bank conflicts
constexpr int kOutStride = kBN + 8;
constexpr uint32_t kOutBytes = 64 * kOutStride * 4;
__host__ __device__ constexpr int smem_bytes(bool bf16_a) {
  return kStages * stage_bytes(bf16_a) + kConsumers * kOutBytes + 1024 +
         2 * kStages * 8;
}
// registers a thread: the launch gives each 65536 / 384 (168, rounded down
// to 8); setmaxnreg.inc waits until the producer warpgroup's setmaxnreg.dec
// has freed what the consumers ask for, so 128 (168 - producer) must cover
// 256 (consumer - 168)
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  128 * kConsumers * (kConsumerRegs - kLaunchRegs),
              "the consumers' registers come from the producer warpgroup");
// the bf16-A mode's fifth epilogue, after csrc/vit_rows.cuh's four: silu
// of the gate columns times the value columns, at half width (the header)
constexpr int kBiasSwiGLU = 4;
// stages summed on the tensor cores before their sum is added in f32 (0:
// all of K)
constexpr int kFlushStages = 1;
constexpr int kSplitThreads = 256;

static_assert(smem_bytes(false) <= 232448 && smem_bytes(true) <= 232448,
              "shared memory of a block");

// The position, in a 32-wide slice of a row of W_hi and W_lo, of column c
// of that slice: slot s of k8 step j holds column 8 (s % 4) + 2 j + s / 4
// (see the header).
__host__ __device__ constexpr int k_position(int c) {
  return 8 * ((c % 8) / 2) + c / 8 + 4 * (c % 2);
}

// The row of W that row p of W's split holds: p itself, or for the SwiGLU
// epilogue (half = N / 2) gate row 64 t + c of tile t = p / 128 at c = p %
// 128 < 64, value row half + 64 t + c - 64 after it.
__host__ __device__ constexpr long long swiglu_row(long long p, int half) {
  return half == 0 ? p
                   : (p / kBN) * (kBN / 2) + (p % kBN) % (kBN / 2) +
                         (p % kBN >= kBN / 2 ? half : 0);
}

// hi and lo of one element of W: csrc/tf32x3.cuh's split of a finite a;
// an infinity or a NaN passes as hi, with lo = 0.
__device__ __forceinline__ void split_w(float a, uint32_t& hi, uint32_t& lo) {
  if ((__float_as_uint(a) & 0x7f800000u) == 0x7f800000u) {
    hi = __float_as_uint(a);
    lo = 0u;
  } else {
    tf32x3::split<0>(a, hi, lo);
  }
}

// W [N, K] -> W_hi at out, W_lo at out + N K, each row's 32-wide slices in
// the order of k_position, row p from W's row swiglu_row(p, half) (half 0:
// row p): one element a thread.
__global__ void __launch_bounds__(kSplitThreads)
split_w_kernel(const float* __restrict__ w, float* __restrict__ out,
               long long total, int k, int half) {
  const long long i = blockIdx.x * static_cast<long long>(kSplitThreads) +
                      threadIdx.x;
  if (i >= total) return;
  const long long src = half == 0 ? i : swiglu_row(i / k, half) * k + i % k;
  uint32_t hi, lo;
  split_w(w[src], hi, lo);
  const long long at = i - i % 32 + k_position(static_cast<int>(i % 32));
  out[at] = __uint_as_float(hi);
  out[total + at] = __uint_as_float(lo);
}

// d (+)= a b^T for one k8 step of a 64 x 128 tile: A (this warpgroup's 64
// rows) from four registers a thread, TF32 values (the m16n8k8 layout of
// each warp's 16 rows: rows g, g + 8 at slots t, t + 4 as a[0], a[1],
// a[2], a[3]); B (128 rows of W_hi or W_lo, K-major) by descriptor; f32
// sums in 64 registers a thread (the m64n128 accumulator layout).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

struct F32Epilogue {
  const float* bias;   // [N]
  const float* ls;     // [N] or null
  const void* res;     // [M, N] or null: f32, bf16 in the bf16-A mode
  void* out;           // [M, N]: f32 (out_f32), else bf16
  int out_f32;         // 1 in the f32 mode; either in the bf16-A mode
};

// 8 bf16 (a 16-byte word) widened to f32 bit patterns, exact in TF32: w
// holds elements 2i (low half) and 2i + 1 of word i
__device__ __forceinline__ void widen_bf16(uint32_t w, uint32_t& even,
                                           uint32_t& odd) {
  even = w << 16;
  odd = w & 0xffff0000u;
}

// The SwiGLU epilogue of one output element, in f32: silu(g + bg) (v + bv)
// (timm's SwiGLUPacked after fc1's bias; silu(x) = x / (1 + e^-x)).
__device__ __forceinline__ float swiglu_value(float g, float bg, float v,
                                              float bv) {
  const float a = g + bg;
  return a / (1.0f + __expf(-a)) * (v + bv);
}

// Persistent, warp-specialised: see the header. kEpi is the epilogue (a
// template argument, so that the bias and gelu epilogues hold no residual
// registers); kBf16A the bf16-A mode (A bf16, two products a step).
// Shared memory: the stages (each its A, W_hi and W_lo tiles, 1024-byte
// aligned), then each consumer warpgroup's staged accumulators, then the
// full and empty mbarriers.
template <int kEpi, bool kBf16A>
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,    // A [M, K]
                const __grid_constant__ CUtensorMap map_hi,   // W_hi [N, K]
                const __grid_constant__ CUtensorMap map_lo,   // W_lo [N, K]
                F32Epilogue e, int m_rows, int n_cols, int k_depth) {
  constexpr uint32_t kATileBytes = a_tile_bytes(kBf16A);
  constexpr uint32_t kStageBytes = stage_bytes(kBf16A);
  // the f32 mode's residual and output are f32 (folded at compile time)
  constexpr bool res_f32 = !kBf16A;
  constexpr bool has_res = kEpi == kResBias || kEpi == kBiasLsRes;
  const bool out_f32 = !kBf16A || e.out_f32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t staged = base + kStages * kStageBytes;
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
  const int k_steps = k_depth / kBK;

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_hi);
      prefetch_map(&map_lo);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM;
        const int n0 = (t % tiles_n) * kBN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);   // the consumers freed it
          const uint32_t dst = base + stage * kStageBytes;
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load(dst, &map_a, full + 8 * stage, ks * kBK, m0);
          tma_load(dst + kATileBytes, &map_hi, full + 8 * stage, ks * kBK,
                   n0);
          tma_load(dst + kATileBytes + kTileBytes, &map_lo, full + 8 * stage,
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
    const int g = lane / 4, t4 = lane % 4;
    const int wrow = 16 * (warp % 4) + g;          // this lane's first row
    const int wcol = 2 * t4;                       // and first column
    // this lane's A fragment in a stage's A tile, 128-byte swizzled: rows
    // 64 wg + wrow and 8 further (both g mod 8), 16-byte chunks 2 t4 and
    // 2 t4 + 1 (columns 8 t4 .. 8 t4 + 7)
    const uint32_t frag = (64 * wg + wrow) * 128;
    const uint32_t chunk0 = frag + ((2 * t4) ^ g) * 16;
    const uint32_t chunk1 = frag + ((2 * t4 + 1) ^ g) * 16;
    // in the bf16-A mode, unswizzled 64-byte rows: chunk t4 of the same rows
    const uint32_t chunk_b = (64 * wg + wrow) * 64 + t4 * 16;
    // a 16-byte load from the shared address addr
    auto lds = [&](uint32_t addr) {
      return *reinterpret_cast<const float4*>(smem_raw + (addr - raw));
    };
    auto lds_u4 = [&](uint32_t addr) {
      return *reinterpret_cast<const uint4*>(smem_raw + (addr - raw));
    };
    float* out_tile =
        reinterpret_cast<float*>(smem_raw + (staged - raw) + wg * kOutBytes);
    constexpr int kRowsPerWarp = 64 / 4;           // of the epilogue
    int stage = 0;                                 // the stage being read
    uint32_t phase = 0;
    float acc[64], part[64];
    float (&d)[64] = kFlushStages > 0 ? part : acc;   // the products' sums
    uint32_t ah0[16], al0[16], ah1[16], al1[16];   // two stages' A, split
    // A of the stage after `stage` (next = true) or of `stage` itself, once
    // TMA has filled it, split into hi and lo: columns 8 t4 .. 8 t4 + 7 of
    // the stage, rows wrow (x) and wrow + 8 (y); k8 step j takes x[2j],
    // y[2j], x[2j + 1], y[2j + 1], at 4 j .. 4 j + 3 of ah and al. In the
    // bf16-A mode the same columns, widened (hi; al is not used)
    auto load_a = [&](bool next, uint32_t (&ah)[16], uint32_t (&al)[16]) {
      int stg = stage;
      uint32_t phs = phase;
      if (next && ++stg == kStages) {
        stg = 0;
        phs ^= 1;
      }
      mbar_wait(full + 8 * stg, phs);
      const uint32_t sa = base + stg * kStageBytes;
      if constexpr (kBf16A) {
        const uint4 xw = lds_u4(sa + chunk_b), yw = lds_u4(sa + chunk_b + 512);
        const uint32_t x[4] = {xw.x, xw.y, xw.z, xw.w};
        const uint32_t y[4] = {yw.x, yw.y, yw.z, yw.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          widen_bf16(x[j], ah[4 * j], ah[4 * j + 2]);
          widen_bf16(y[j], ah[4 * j + 1], ah[4 * j + 3]);
        }
      } else {
        const float4 x0 = lds(sa + chunk0), x1 = lds(sa + chunk1);
        const float4 y0 = lds(sa + chunk0 + 1024),
                     y1 = lds(sa + chunk1 + 1024);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tf32x3::split<0>(x[2 * j], ah[4 * j], al[4 * j]);
          tf32x3::split<0>(y[2 * j], ah[4 * j + 1], al[4 * j + 1]);
          tf32x3::split<0>(x[2 * j + 1], ah[4 * j + 2], al[4 * j + 2]);
          tf32x3::split<0>(y[2 * j + 1], ah[4 * j + 3], al[4 * j + 3]);
        }
      }
    };
    // the 12 products of `stage` (depth step ks) into d, the small terms
    // first (the bf16-A mode: the 8 of hi lo and hi hi); a fresh group's
    // first product has scale-d 0
    auto issue = [&](int ks, uint32_t (&ah)[16], uint32_t (&al)[16]) {
      const bool fresh = kFlushStages > 0 ? ks % kFlushStages == 0 : ks == 0;
      const uint32_t sa = base + stage * kStageBytes;
      const uint64_t dh = sw128_desc(sa + kATileBytes);
      const uint64_t dl = sw128_desc(sa + kATileBytes + kTileBytes);
      fence_operands(ah);
      if constexpr (!kBf16A) fence_operands(al);
      fence_operands(d);
      wgmma_fence();
      if constexpr (kBf16A) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_tf32(d, ah + 4 * j, dl + 2 * j, !fresh || j > 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)                // +2: a k8 step, 32 bytes
          wgmma_tf32(d, al + 4 * j, dh + 2 * j, !fresh || j > 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_tf32(d, ah + 4 * j, dl + 2 * j, 1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_tf32(d, ah + 4 * j, dh + 2 * j, 1);
      wgmma_commit();
    };
    // waits for the products of `stage` (depth step ks), frees it, adds a
    // finished group to the running sums and moves to the next stage
    auto retire = [&](int ks, uint32_t (&ah)[16], uint32_t (&al)[16]) {
      wgmma_wait<0>();
      fence_operands(d);
      fence_operands(ah);                          // live until the products
      if constexpr (!kBf16A) fence_operands(al);   // have read them
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (kFlushStages > 0 &&
          ((ks + 1) % kFlushStages == 0 || ks + 1 == k_steps)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM;
      const int n0 = (t % tiles_n) * kBN;
      // the epilogue's lane: rows row0 + 4 i of the tile, four columns from
      // col; its residual rows are prefetched to L2 now (each lane two of
      // the warp's 16 rows x 4 lines), read after the products
      const int col = n0 + 4 * lane;
      const int row0 = m0 + 64 * wg + warp % 4;
      if constexpr (has_res) {
        // a row's 128 columns are 4 lines of f32 or 2 of bf16
        constexpr int lines = res_f32 ? 4 : 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 4 * (lane / 4 + 8 * h);
          const int c = n0 + (128 / lines) * (lane % 4);
          if (lane % 4 < lines && r < m_rows && c < n_cols)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                static_cast<const char*>(e.res) +
                (static_cast<size_t>(r) * n_cols + c) * (res_f32 ? 4 : 2)));
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      // two stages in turn, each one's A loaded and split while the
      // other's products run
      load_a(false, ah0, al0);
      for (int ks = 0; ks < k_steps; ks += 2) {
        issue(ks, ah0, al0);
        if (ks + 1 < k_steps) load_a(true, ah1, al1);
        retire(ks, ah0, al0);
        if (ks + 1 == k_steps) break;
        issue(ks + 1, ah1, al1);
        if (ks + 2 < k_steps) load_a(true, ah0, al0);
        retire(ks + 1, ah1, al1);
      }

      // the epilogue: the residuals requested first (from L2), then the
      // accumulators (acc[4j + 2h + c] is row wrow + 8h, column 8j + wcol +
      // c of this warpgroup's 64 x 128 tile) staged in shared memory; each
      // warp then takes whole rows, four columns a lane, so that every
      // store is 16 (f32) or 8 (bf16) contiguous bytes of a row. A
      // residual is held as it lies in memory (f32: all four words; bf16:
      // the first two)
      uint4 res[kRowsPerWarp];
      if constexpr (has_res) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          res[i] = make_uint4(0u, 0u, 0u, 0u);
          const size_t off = static_cast<size_t>(row0 + 4 * i) * n_cols + col;
          if (col < n_cols && row0 + 4 * i < m_rows) {
            if constexpr (res_f32) {
              res[i] = __ldg(reinterpret_cast<const uint4*>(
                  static_cast<const float*>(e.res) + off));
            } else {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                  static_cast<const bf16*>(e.res) + off));
              res[i] = make_uint4(v.x, v.y, 0u, 0u);
            }
          }
        }
      }
      named_barrier(1 + wg, 128);                   // the last tile is read
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out_tile + (wrow + 8 * h) * kOutStride +
                                     8 * j + wcol) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      named_barrier(1 + wg, 128);
      if constexpr (kEpi == kBiasSwiGLU) {
        // 64 gate then 64 value columns staged; output columns o .. o + 3
        // of rows r (two rows a pass: lanes 0-15, 16-31), at half width
        const int half = n_cols / 2;
        const int c = 4 * (lane % 16);
        const int o = n0 / 2 + c;
        const float4 bg = *reinterpret_cast<const float4*>(e.bias + o);
        const float4 bv = *reinterpret_cast<const float4*>(e.bias + half + o);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp / 2; ++i) {
          const int r = warp % 4 + 4 * (2 * i + lane / 16);
          const int row = m0 + 64 * wg + r;
          if (row >= m_rows) continue;
          const float4 g =
              *reinterpret_cast<const float4*>(out_tile + r * kOutStride + c);
          const float4 v = *reinterpret_cast<const float4*>(
              out_tile + r * kOutStride + kBN / 2 + c);
          const float y[4] = {swiglu_value(g.x, bg.x, v.x, bv.x),
                              swiglu_value(g.y, bg.y, v.y, bv.y),
                              swiglu_value(g.z, bg.z, v.z, bv.z),
                              swiglu_value(g.w, bg.w, v.w, bv.w)};
          const size_t off = static_cast<size_t>(row) * half + o;
          if (out_f32)
            store4(static_cast<float*>(e.out) + off, y);
          else
            store4(static_cast<bf16*>(e.out) + off, y);
        }
      } else if (col < n_cols) {                    // N % 8 == 0: all four
        const float4 b = *reinterpret_cast<const float4*>(e.bias + col);
        const float4 gm = kEpi == kBiasLsRes && e.ls != nullptr
                              ? *reinterpret_cast<const float4*>(e.ls + col)
                              : make_float4(1.f, 1.f, 1.f, 1.f);
        float4 a[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              out_tile + (warp % 4 + 4 * i) * kOutStride + 4 * lane);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (row0 + 4 * i >= m_rows) continue;
          float r[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (has_res) {
            if constexpr (res_f32) {
              r[0] = __uint_as_float(res[i].x);
              r[1] = __uint_as_float(res[i].y);
              r[2] = __uint_as_float(res[i].z);
              r[3] = __uint_as_float(res[i].w);
            } else {                                // bf16: exact in f32
              r[0] = __uint_as_float(res[i].x << 16);
              r[1] = __uint_as_float(res[i].x & 0xffff0000u);
              r[2] = __uint_as_float(res[i].y << 16);
              r[3] = __uint_as_float(res[i].y & 0xffff0000u);
            }
          }
          const float y[4] = {epilogue_value<kEpi>(a[i].x, b.x, gm.x, r[0]),
                              epilogue_value<kEpi>(a[i].y, b.y, gm.y, r[1]),
                              epilogue_value<kEpi>(a[i].z, b.z, gm.z, r[2]),
                              epilogue_value<kEpi>(a[i].w, b.w, gm.w, r[3])};
          const size_t off = static_cast<size_t>(row0 + 4 * i) * n_cols + col;
          if (out_f32)
            store4(static_cast<float*>(e.out) + off, y);
          else
            store4(static_cast<bf16*>(e.out) + off, y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The map of a row-major [rows, k] f32 matrix, read in 128-row x 32-column
// boxes (one 128-byte row of depth) with the 128-byte swizzle.
bool make_map(CUtensorMap* map, const float* ptr, int rows, int k) {
  return make_sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows, k,
                        kBK, kBM);
}

// The map of the bf16-A mode's A [rows, k], read in 128-row x 32-column
// boxes (one 64-byte row of depth), unswizzled.
bool make_map_bf16(CUtensorMap* map, const void* ptr, int rows, int k) {
  return make_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows,
                        k, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// W's split, its rows gathered for the SwiGLU epilogue with swiglu
cudaError_t launch_split(const float* w, float* w_split, int n, int k,
                         bool swiglu, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * k;
  split_w_kernel<<<static_cast<unsigned>((total + kSplitThreads - 1) /
                                         kSplitThreads),
                   kSplitThreads, 0, stream>>>(w, w_split, total, k,
                                               swiglu ? n / 2 : 0);
  return cudaGetLastError();
}

template <int kEpi, bool kBf16A>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_hi,
                        const CUtensorMap& map_lo, const F32Epilogue& e, int m,
                        int n, int k, int grid, cudaStream_t stream) {
  static tf32x3::SmemLimit limit;
  constexpr int kSmemBytes = smem_bytes(kBf16A);
  cudaError_t err =
      tf32x3::raise_smem(gemm_f32_kernel<kEpi, kBf16A>, kSmemBytes, limit);
  if (err != cudaSuccess) return err;
  gemm_f32_kernel<kEpi, kBf16A><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_hi, map_lo, e, m, n, k);
  return cudaGetLastError();
}

// What the two entries check: widths, the epilogue and its operands (the
// SwiGLU epilogue in the bf16-A mode alone, at N % 128 == 0, no residual).
bool takes(int m, int n, int k, int epilogue, const void* res, bool ln,
           const void* a_rows, const float* w_split, bool bf16_a) {
  const bool swiglu = epilogue == kBiasSwiGLU;
  return m > 0 && n > 0 && k > 0 && k % 32 == 0 && n % 8 == 0 &&
         epilogue >= kBias &&
         (epilogue <= kBiasLsRes ||
          (swiglu && bf16_a && n % kBN == 0 && res == nullptr)) &&
         (epilogue == kBias || epilogue == kBiasGelu || swiglu ||
          res != nullptr) &&
         (!ln || a_rows != nullptr) && w_split != nullptr &&
         static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN) <=
             0x7fffffffLL;
}

// W's split and the product of A (f32, or bf16 with kBf16A; the prologue
// already applied) through `epilogue`.
template <bool kBf16A>
cudaError_t run(const void* a, const float* w, float* w_split,
                const F32Epilogue& e, int epilogue, int m, int n, int k,
                cudaStream_t st) {
  cudaError_t err = launch_split(w, w_split, n, k, epilogue == kBiasSwiGLU,
                                 st);
  if (err != cudaSuccess) return err;
  const float* w_lo = w_split + static_cast<size_t>(n) * k;
  CUtensorMap map_a, map_hi, map_lo;
  const bool mapped_a =
      kBf16A ? make_map_bf16(&map_a, a, m, k)
             : make_map(&map_a, static_cast<const float*>(a), m, k);
  if (!mapped_a || !make_map(&map_hi, w_split, n, k) ||
      !make_map(&map_lo, w_lo, n, k))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  switch (epilogue) {
    case kBias:
      return launch_gemm<kBias, kBf16A>(map_a, map_hi, map_lo, e, m, n, k,
                                        grid, st);
    case kBiasGelu:
      return launch_gemm<kBiasGelu, kBf16A>(map_a, map_hi, map_lo, e, m, n, k,
                                            grid, st);
    case kResBias:
      return launch_gemm<kResBias, kBf16A>(map_a, map_hi, map_lo, e, m, n, k,
                                           grid, st);
    case kBiasSwiGLU:
      if constexpr (kBf16A)
        return launch_gemm<kBiasSwiGLU, true>(map_a, map_hi, map_lo, e, m, n,
                                              k, grid, st);
      return cudaErrorInvalidValue;
    default:
      return launch_gemm<kBiasLsRes, kBf16A>(map_a, map_hi, map_lo, e, m, n,
                                             k, grid, st);
  }
}

}  // namespace

extern "C" {

// Launches the split of W alone on `stream`: w [n, k] f32 -> w_split [2, n,
// k] (W_hi, then W_lo, each row's 32-wide slices in the kernel's order of
// depth), k a multiple of 32. Returns the cudaError_t of the launch.
int vit_gemm_f32_split_w(const float* w, float* w_split, int n, int k,
                         void* stream) {
  if (n <= 0 || k <= 0 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_split(w, w_split, n, k, false,
                                       static_cast<cudaStream_t>(stream)));
}

// Launches the f32 GEMM on `stream`. A is [m, k] f32; ln_scale/ln_bias [k]
// turn the LayerNorm prologue on (both null: off), which writes f32 rows to
// a_rows [m, k] (else null: the product reads A itself); w [n, k]; w_split
// a [2, n, k] workspace for W's split; bias [n]; ls [n] or null; res [m, n]
// (epilogues 2 and 3); out [m, n]; all f32 device pointers, contiguous and
// 16-byte aligned. Three launches at most: the prologue, the split, the
// product. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for widths it does not take).
int vit_gemm_f32(const float* a, const float* ln_scale, const float* ln_bias,
                 float* a_rows, const float* w, float* w_split,
                 const float* bias, const float* ls, const float* res,
                 float* out, int epilogue, int m, int n, int k, void* stream) {
  const bool ln = ln_scale != nullptr;
  if (!takes(m, n, k, epilogue, res, ln, a_rows, w_split, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) {
    const cudaError_t err = launch_prologue<float, float, true>(
        a, ln_scale, ln_bias, a_rows, m, k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    a = a_rows;
  }
  const F32Epilogue e{bias, ls, res, out, 1};
  return static_cast<int>(run<false>(a, w, w_split, e, epilogue, m, n, k, st));
}

// Launches the bf16-A mode on `stream`: as vit_gemm_f32, with A [m, k]
// bf16, the prologue's rows a_rows [m, k] bf16, res [m, n] bf16 and out
// [m, n] f32 (out_f32 = 1) or bf16; w, w_split and the vectors f32. Two
// TF32 products a product (see the header). Epilogue 4 (SwiGLU): n a
// multiple of 128, no residual, out [m, n / 2].
int vit_gemm_f32_bf16a(const void* a, const float* ln_scale,
                       const float* ln_bias, void* a_rows, const float* w,
                       float* w_split, const float* bias, const float* ls,
                       const void* res, void* out, int out_f32, int epilogue,
                       int m, int n, int k, void* stream) {
  const bool ln = ln_scale != nullptr;
  if (!takes(m, n, k, epilogue, res, ln, a_rows, w_split, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) {
    const cudaError_t err = launch_prologue<bf16, bf16, true>(
        a, ln_scale, ln_bias, static_cast<bf16*>(a_rows), m, k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    a = a_rows;
  }
  const F32Epilogue e{bias, ls, res, out, out_f32 != 0};
  return static_cast<int>(run<true>(a, w, w_split, e, epilogue, m, n, k, st));
}

}  // extern "C"
