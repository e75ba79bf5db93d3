// Shared by the persistent FFMA kernels pairwise.cu and facility.cu: the
// mbarrier and TMA primitives of their load rings, the 128-byte-swizzled
// box layout, the 16 x 8 register micro-tile's FFMA loop over one box, the
// persistent block's walk over work units, and the host-side tensor maps.
//
// Layout: a box is up to 256 rows of 128 bytes (32 f32 or 64 bf16 values of
// d), written by TMA with the 128-byte swizzle (the 16-byte chunk index of
// byte cb in row r is XORed with r mod 8; boxes are 1024-byte aligned).
// The band operand (x: pairwise's row band, facility's candidate band) is
// 256 rows; the tile operand (y: pairwise's column tile, facility's eval
// tile) 128 rows.  Warp w owns band rows 32 w .. 32 w + 31; lane (h, tx) =
// (lane / 16, lane % 16) of it owns 16 of them (row_in_warp) and the tile
// rows tx + 16 j (j < 8): acc[i][j].
//
// Two ring modes, chosen on the host by the width d (kernels/ring.py
// `plan`, the rule both kernels share):
//   * resident (d within MAX_RES_BOXES = 2 boxes): the band's boxes stay in
//     shared memory for a whole work unit and each ring stage carries every
//     box of one tile;
//   * streamed (wider d): each ring stage carries one box of d for both
//     operands, the band's box and the tile's, so shared memory holds a few
//     boxes whatever d is; the accumulators of one output tile carry across
//     its nb boxes and the band is read again (from L2) for every tile.
// Both give each product one fmaf chain over k = 0 .. d-1 from 0.0f: the
// same bits.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace sm90 {
namespace ring {

constexpr int MI = 16;            // band rows a thread
constexpr int MAX_RES_BOXES = 2;  // boxes of d the resident mode takes
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// ---------------------------------------------------------------------------
// barriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for a barrier phase; trap after about 10 s stuck (a lost TMA load
// becomes a launch error instead of a hang).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// the swizzled tile and the FFMA loop
// ---------------------------------------------------------------------------

// Byte offset of byte `cb` (< 128) of row r in a box written by TMA's
// 128-byte swizzle (the 16-byte chunk index XORed with r mod 8; the box is
// 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int cb) {
  return r * 128 + ((((cb >> 4) ^ r) & 7) << 4) + (cb & 15);
}

// Four consecutive k values of a staged row as float32: 16 bytes of f32, or
// 8 bytes of bf16 widened (element 2m is the low half of word m).
__device__ __forceinline__ void load4(const float*, const char* p,
                                      float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16*, const char* p,
                                      float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Byte offset of group g (4 k values of T) in a swizzled row whose index
// is r mod 8 = s: rows 8 apart share the offset, so a thread's rows (16
// apart) differ only by constant multiples of 16 rows.
template <typename T>
__device__ __forceinline__ int group_off(int g, int s) {
  constexpr int GB = 4 * sizeof(T);
  return ((((g * GB) >> 4) ^ s) << 4) + ((g * GB) & 15);
}

// Row i (of 16) of the thread's micro-tile within its warp's 32 rows:
// 8 (i / 4) + 4 h + i % 4, so the two half-warps read rows 4 apart.
__device__ __forceinline__ int row_in_warp(int i, int h) {
  return 8 * (i >> 2) + 4 * h + (i & 3);
}

// acc[i][j] += x[row i, k] * y[tx + 16 j, k] over the first `ng` groups of
// 4 k values of one box (k ascending); xw is the box's row 32 w + 4 h.  With
// NORMS the squared norms of the same staged y values accumulate in y2.
template <typename T, bool NORMS>
__device__ __forceinline__ void box_fma(const char* __restrict__ xw,
                                        const char* __restrict__ ys, int ng,
                                        int h, int tx, float (&acc)[MI][8],
                                        float (&y2)[8]) {
  const T* tag = nullptr;
  const char* yr = ys + tx * 128;  // row tx; row tx + 16 j is 2048 j further
  const int sy = tx & 7;
  // one group an iteration, not unrolled: the body (512 FFMA) stays small
  // enough for the instruction cache
#pragma unroll 1
  for (int g = 0; g < ng; ++g) {
    const char* yg = yr + group_off<T>(g, sy);
    int xo[4];  // the swizzled group offset of rows 4 h + q (mod 8)
#pragma unroll
    for (int q = 0; q < 4; ++q) xo[q] = group_off<T>(g, 4 * h + q);
    float b[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) load4(tag, yg + 2048 * j, b[j]);
    if (NORMS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) y2[j] = fmaf(b[j][e], b[j][e], y2[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      float a[4];
      load4(tag, xw + 1024 * (i >> 2) + 128 * (i & 3) + xo[i & 3], a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[e], b[j][e], acc[i][j]);
      }
    }
  }
}

// Continue the squared-norm chain s of row r over the first `nk` k values
// of one box (k ascending), the rbf epilogue's |x|^2 / |y|^2 from the staged
// values.
template <typename T>
__device__ __forceinline__ float row_norm(const char* __restrict__ box,
                                          int r, int nk, float s) {
  const T* tag = nullptr;
  for (int g = 0; 4 * g < nk; ++g) {
    float v[4];
    load4(tag, box + r * 128 + group_off<T>(g, r & 7), v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * g + e < nk) s = fmaf(v[e], v[e], s);
  }
  return s;
}

// Groups of 4 elements of box kb (of bc) that hold some of d (the rest is
// zero).
__device__ __forceinline__ int groups_of(int64_t d, int kb, int bc) {
  return static_cast<int>(min64(bc / 4, (d - int64_t{kb} * bc + 3) / 4));
}

// The block's walk over streamed tiles: units (a band of one batch entry and
// a range of its streamed tiles) by a stride of gridDim.x.  The launch's
// arguments A carry n_rb (bands a batch entry), n_ct (streamed tiles), cpc
// (tiles a unit), cpb (units a band) and units; unit u is band u / cpb and
// its tiles [(u % cpb) cpc, min(n_ct, (u % cpb + 1) cpc)), so consecutive
// units share a batch entry and its streamed tiles stay in L2.
struct Walk {
  int64_t u;
  int64_t b, rb, ct, ct_end;
  bool valid, fresh;  // fresh: the first tile of a unit (new band)

  template <class A>
  __device__ void start(int64_t unit, const A& a) {
    u = unit;
    valid = unit < a.units;
    fresh = true;
    if (!valid) return;
    const int64_t band = unit / a.cpb, chunk = unit % a.cpb;
    b = band / a.n_rb;
    rb = band % a.n_rb;
    ct = chunk * a.cpc;
    ct_end = min64(a.n_ct, ct + a.cpc);
  }
  template <class A>
  __device__ void next(const A& a) {
    if (++ct < ct_end) {
      fresh = false;
      return;
    }
    start(u + gridDim.x, a);
  }
};

// A position in a ring of `stages` stages: the stage and the parity of the
// phase its barriers are in.
struct Slot {
  int s;
  uint32_t ph;
  __device__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 3-D map (cols, rows, batch) with 128-byte swizzled boxes of
// (box_cols, box_rows, 1); a batch extent of 1 for an operand shared by the
// batch.  Rows are row_stride elements apart (a pitch past cols reads as
// TMA's zero fill past cols).  Returns 0 or an error code (driver errors
// offset by 10000).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int esz,
                    const void* ptr, int64_t cols, int64_t rows,
                    int64_t batch, int64_t row_stride, int64_t batch_stride,
                    int box_cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride * esz),
                                 static_cast<cuuint64_t>(batch_stride * esz)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = enc(map, type, 3, const_cast<void*>(ptr), dims,
                           strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace ring
}  // namespace sm90
