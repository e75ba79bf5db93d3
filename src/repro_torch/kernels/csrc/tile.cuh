// Shared by the kernels: the block size and masked-gain floor of the
// small helper kernels, float32 widening, the rbf similarity of
// kernels/ref.py (sim_of: the reference value pairwise.cu's and
// info_gain.cu's division-free quotient is held to), the (value, index)
// top-1 order with its block reduction and per-partition fold, and the
// error string every library exports.  Every address is 64-bit.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace sm90 {

constexpr int NT = 256;          // threads per block
constexpr float NEG = -1e30f;    // masked-gain floor (kernels/ref.py NEG)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Stage 2 of every fused select: the top-1 of each partition's per-tile
// (value, index) pairs, one block per partition (blockIdx.y).
__global__ void __launch_bounds__(NT)
    fold_tiles(const float* __restrict__ tile_best,
               const int* __restrict__ tile_idx, float* __restrict__ best,
               int* __restrict__ idx, int64_t n_tiles) {
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];
  const int64_t p = blockIdx.y;
  float v = -CUDART_INF_F;
  int vi = 0x7fffffff;
  for (int64_t t = threadIdx.x; t < n_tiles; t += NT)
    take_better(v, vi, tile_best[p * n_tiles + t], tile_idx[p * n_tiles + t]);
  block_top1(v, vi, wv, wi);
  if (threadIdx.x == 0) {
    best[p] = v;
    idx[p] = vi;
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
