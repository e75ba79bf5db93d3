// Shared FP32 tile product for the similarity kernels (pairwise.cu and
// facility.cu): a 128 x 128 output tile per block of 256 threads, the d axis
// staged through shared memory in chunks of 16, an 8 x 8 register micro-tile
// per thread, FFMA only (no tensor cores, no TF32).
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows
// {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3} and the same pattern of columns in
// tx, so a warp's shared-memory reads of one k-slice are one broadcast
// (rows) and 16 consecutive float4s (columns).  Every address is 64-bit:
// one batch of the fast engine's cached similarity block holds 16 x 16384^2
// floats, past the range of int32 offsets.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace sm90 {

constexpr int BM = 128;          // tile rows (x / eval rows)
constexpr int BN = 128;          // tile columns (y / candidate rows)
constexpr int BK = 16;           // d-chunk staged per step
constexpr int NT = 256;          // threads per block
constexpr int LDS = BM + 4;      // padded pitch of a staged k-slice (floats)
constexpr float NEG = -1e30f;    // masked-gain floor (kernels/ref.py NEG)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tile row / column offset of micro-tile entry i (or j) of this thread.
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (j & 3);
}

// Stage rows [row0, row0 + 128) x columns [k0, k0 + BK) of a row-major
// (n, d) matrix into s[k * LDS + r] as float32, zero outside the matrix (the
// ragged edges need no padding in device memory).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ a, int64_t n,
                                      int64_t d, int64_t row0, int64_t k0,
                                      float* __restrict__ s) {
#pragma unroll
  for (int l = 0; l < (BM * BK) / NT; ++l) {
    const int idx = threadIdx.x + l * NT;
    const int r = idx / BK, k = idx % BK;
    const int64_t gr = row0 + r, gk = k0 + k;
    float v = 0.0f;
    if (gr < n && gk < d) v = to_f32(a[gr * d + gk]);
    s[k * LDS + r] = v;
  }
}

// acc[i][j] = sum_k x[row0 + row_of(i), k] * y[col0 + col_of(j), k] over the
// whole d axis, in increasing k.  With NORMS the squared row norms of the
// same staged values accumulate in x2 / y2 (the rbf epilogue's |x|^2, |y|^2,
// taken from the tiles already in shared memory as pairwise.py does).
// Ends with a __syncthreads(), so the caller may restage shared memory.
template <typename T, bool NORMS>
__device__ __forceinline__ void tile_product(
    const T* __restrict__ x, int64_t nx, const T* __restrict__ y, int64_t ny,
    int64_t d, int64_t row0, int64_t col0, float* __restrict__ xs,
    float* __restrict__ ys, float (&acc)[8][8], float (&x2)[8],
    float (&y2)[8]) {
  const int tx4 = (threadIdx.x % 16) * 4, ty4 = (threadIdx.x / 16) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x2[i] = 0.0f;
    y2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int64_t k0 = 0; k0 < d; k0 += BK) {
    stage(x, nx, d, row0, k0, xs);
    stage(y, ny, d, col0, k0, ys);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k * LDS + ty4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[k * LDS + 64 + ty4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[k * LDS + tx4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[k * LDS + 64 + tx4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (NORMS) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x2[i] = fmaf(a[i], a[i], x2[i]);
          y2[i] = fmaf(b[i], b[i], y2[i]);
        }
      }
    }
    __syncthreads();
  }
}

// The similarity of one tile entry: the dot product (linear), or
// exp(-max(|x|^2 - 2 x.y + |y|^2, 0) / h^2) (rbf), the formula of
// kernels/ref.py _sim.
template <bool RBF>
__device__ __forceinline__ float sim_of(float dot, float x2, float y2,
                                        float hh) {
  if (!RBF) return dot;
  const float d2 = fmaxf(x2 - 2.0f * dot + y2, 0.0f);
  return expf(-d2 / hh);
}

// (value, index) order of every top-1 in this package: the larger value
// wins, equal values go to the lower index.  It is a total order, so any
// reduction tree gives the same answer as a left-to-right fold.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide top-1 over one (v, i) per thread; the result lands in thread 0.
// `sv` / `si` are shared scratch of NT / 32 entries each.
__device__ __forceinline__ void block_top1(float& v, int& i, float* sv,
                                           int* si) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, v2, i2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w)
      take_better(v, i, sv[w], si[w]);
  }
}

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

}  // namespace sm90

// The CUDA runtime's message for an error code an entry point returned.
extern "C" const char* sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
