// A block-level matrix product on Hopper's tensor cores that keeps f32
// accuracy: split-TF32 ("3xTF32") mma.sync, fed by a cp.async ring.
//
// C[m][n] += sum_k A(m, k) B(k, n) over one BM x BN tile of C. Each f32
// operand is split into hi = tf32(a) and lo = tf32(a - hi) (tf32: rounded
// to nearest, ties away), and the product
// is lo*hi + hi*lo + hi*hi (the small terms first), accumulated in f32 by
// mma.sync.m16n8k8 TF32: about f32's accuracy at the tensor cores' rate. An
// fp16 operand is exact in TF32 (10 mantissa bits, a wider exponent range),
// so its lo is 0 and a product with it takes two MMAs, not three.
//
// Operands are read from global memory as they lie, in one of two layouts
// (see Operand), and staged by cp.async into padded shared memory in a ring
// of kStages BK-deep slices, so that the fragment loads do not conflict on
// the banks. Elements past an operand's extent (rows past M, columns past
// Df, the end of a split range of k) are staged as 0. The kernels of
// attn_pool_bwd.cu build every product from this one block. The header also
// holds raise_smem, which the launchers of B1, B2 and B6 share.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// a rounded to TF32, to nearest with ties away from 0: the bits of
// cvt.rna.tf32.f32 for every finite a, by an integer add and mask, which
// issue at the full ALU rate where the conversion does not
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !pred.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// 8 consecutive elements, 16-byte aligned, as f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One operand of the product as it lies in global memory, for a tile of
// kExtent rows of the operand's own index i (m for A, n for B) and BK of k.
// K-major (kKMajor): element (i, k) at p[i * ld + k], staged [kExtent][BK +
// pad]. Otherwise: element (i, k) at p[k * ld + i], staged [BK][kExtent +
// pad]. i < i_lim and k < k_lim are read; the rest is staged as 0. ld and
// i_lim (for the second layout) are multiples of 16 bytes' elements. An
// operand may have a second segment along its contiguous index j (k when
// K-major, else i): elements with j >= split at p2, with ld2 and j - split,
// split a multiple of 16 bytes' elements (and of BK when j is k).
template <typename T, bool kKMajor, int kExtent, int BK>
struct Operand {
  static constexpr int kVec = 16 / sizeof(T);       // elements a cp.async moves
  static constexpr int kExact = sizeof(T) == 2;     // fp16: lo is 0
  // pads that keep the fragment loads of a warp on distinct banks
  static constexpr int kStride =
      kKMajor ? BK + (sizeof(T) == 4 ? 4 : 8) : kExtent + 8;
  static constexpr int kStageElems = (kKMajor ? kExtent : BK) * kStride;
  static constexpr int kStageBytes = kStageElems * sizeof(T);
  static_assert(kStageBytes % 16 == 0, "stage alignment");
  using Elem = T;

  const T* p;
  long long ld;
  int i_lim, k_lim;
  const T* p2 = nullptr;
  long long ld2 = 0;
  int split = 0x7fffffff;

  template <int kThreads>
  __device__ __forceinline__ void load(T* s, int i0, int k0) const {
    constexpr int kInner = kKMajor ? BK : kExtent;   // contiguous extent
    constexpr int kChunks = kExtent * BK / kVec;
    constexpr int kPerRow = kInner / kVec;
#pragma unroll
    for (int q = 0; q < (kChunks + kThreads - 1) / kThreads; ++q) {
      const int c = threadIdx.x + q * kThreads;
      if (kChunks % kThreads != 0 && c >= kChunks) break;
      const int r = c / kPerRow;
      const int col = (c % kPerRow) * kVec;
      const int i = kKMajor ? i0 + r : i0 + col;
      const int k = kKMajor ? k0 + col : k0 + r;
      const bool ok = i < i_lim && k < k_lim;
      const int outer = kKMajor ? i : k, inner = kKMajor ? k : i;
      const T* src = p;
      if (ok)
        src = inner < split ? p + static_cast<long long>(outer) * ld + inner
                            : p2 + static_cast<long long>(outer) * ld2 + (inner - split);
      cp16(s + r * kStride + col, src, ok);
    }
  }

  // element (i, k) of a staged slice, as f32
  __device__ __forceinline__ static float at(const T* s, int i, int k) {
    return widen(kKMajor ? s[i * kStride + k] : s[k * kStride + i]);
  }
};

// hi and lo of an operand element; lo stays 0 for an exact (fp16) operand
template <int kExact>
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(a);
    lo = 0u;
  } else {
    hi = to_tf32(a);
    lo = to_tf32(a - __uint_as_float(hi));
  }
}

// The product of a BM x BN tile by kThreads = 32 * WM * WN threads, warps
// laid out WM x WN, each owning a (BM / WM) x (BN / WN) sub-tile of
// m16n8 fragments in acc[kMT][kNT][4]: fragment element e of (mt, nt) is
// C[m0 + wm * kWarpM + mt * 16 + g + 8 * (e / 2)]
//  [n0 + wn * kWarpN + nt * 8 + 2 * t + e % 2], g = lane / 4, t = lane % 4.
template <class OpA, class OpB, int BM, int BN, int BK, int WM, int WN,
          int kStages>
struct BlockGemm {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static constexpr int kSmemBytes =
      kStages * (OpA::kStageBytes + OpB::kStageBytes);
  static_assert(kWarpM % 16 == 0 && kWarpN % 8 == 0 && BK % 8 == 0, "tile");

  using TA = typename OpA::Elem;
  using TB = typename OpB::Elem;

  __device__ __forceinline__ static void zero(float (&acc)[kMT][kNT][4]) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // acc += the product over k in [k0, k1); smem holds kSmemBytes. Ends
  // with every thread past its last read of smem. The MMA's f32
  // accumulation loses more than an f32 sum over a long k (its error grows
  // with the number of steps), so with kFlush each BK-deep slice is summed
  // apart and added to acc in f32.
  template <bool kFlush = false>
  __device__ static void run(float (&acc)[kMT][kNT][4], const OpA& a,
                             const OpB& b, int m0, int n0, int k0, int k1,
                             char* smem) {
    TA* sa = reinterpret_cast<TA*>(smem);
    TB* sb = reinterpret_cast<TB*>(smem + kStages * OpA::kStageBytes);
    const int nk = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) {
        a.template load<kThreads>(sa + s * OpA::kStageElems, m0, k0 + s * BK);
        b.template load<kThreads>(sb + s * OpB::kStageElems, n0, k0 + s * BK);
      }
      cp_commit();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WN, wn = warp % WN;
    const int g = lane / 4, t = lane % 4;
    for (int it = 0; it < nk; ++it) {
      cp_wait<kStages - 2>();
      __syncthreads();  // slice `it` is in; slice it - 1 has been read
      const int nxt = it + kStages - 1;
      if (nxt < nk) {
        a.template load<kThreads>(sa + (nxt % kStages) * OpA::kStageElems, m0,
                                  k0 + nxt * BK);
        b.template load<kThreads>(sb + (nxt % kStages) * OpB::kStageElems, n0,
                                  k0 + nxt * BK);
      }
      cp_commit();
      const TA* xa = sa + (it % kStages) * OpA::kStageElems;
      const TB* xb = sb + (it % kStages) * OpB::kStageElems;
      float part[kMT][kNT][4];
      if (kFlush) zero(part);
      float (&d)[kMT][kNT][4] = kFlush ? part : acc;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int r = wm * kWarpM + i * 16 + g;
          split<OpA::kExact>(OpA::at(xa, r, kk + t), ah[i][0], al[i][0]);
          split<OpA::kExact>(OpA::at(xa, r + 8, kk + t), ah[i][1], al[i][1]);
          split<OpA::kExact>(OpA::at(xa, r, kk + t + 4), ah[i][2], al[i][2]);
          split<OpA::kExact>(OpA::at(xa, r + 8, kk + t + 4), ah[i][3],
                             al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = wn * kWarpN + j * 8 + g;
          split<OpB::kExact>(OpB::at(xb, c, kk + t), bh[j][0], bl[j][0]);
          split<OpB::kExact>(OpB::at(xb, c, kk + t + 4), bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (!OpA::kExact) mma(d[i][j], al[i], bh[j]);
            if (!OpB::kExact) mma(d[i][j], ah[i], bl[j]);
            mma(d[i][j], ah[i], bh[j]);
          }
      }
      if (kFlush) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    }
    cp_wait<0>();
    __syncthreads();
  }

  // f(row, col, c[row][col], c[row][col + 1]) for every pair of adjacent
  // columns the thread holds, rows and columns counted from the tile's
  // origin (m0, n0)
  template <class F>
  __device__ __forceinline__ static void for_pairs(
      const float (&acc)[kMT][kNT][4], int m0, int n0, F f) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = m0 + (warp / WN) * kWarpM + lane / 4;
    const int c0 = n0 + (warp % WN) * kWarpN + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        f(r0 + i * 16, c0 + j * 8, acc[i][j][0], acc[i][j][1]);
        f(r0 + i * 16 + 8, c0 + j * 8, acc[i][j][2], acc[i][j][3]);
      }
  }
};

// Internal linkage, as for the kernels of gated_h.cuh: each library keeps
// its own copy.
namespace {

// The device (and the bytes) a kernel's dynamic shared memory limit was
// last raised for: one per kernel instantiation, so that the attribute is
// set once, not at every launch.
struct SmemLimit {
  int device = -1;
  size_t bytes = 0;
};

template <class K>
cudaError_t raise_smem(K kernel, size_t bytes, SmemLimit& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev == done.device && bytes <= done.bytes))
    return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done = {dev, bytes};
  return err;
}

}  // namespace

}  // namespace tf32x3
