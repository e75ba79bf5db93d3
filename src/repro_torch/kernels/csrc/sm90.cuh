// Shared by the persistent kernels pairwise.cu, facility.cu and
// info_gain.cu: the SM count their grids are sized by, and the rbf
// similarity without the division's slow path.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sm90 {

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// read once a device.
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// exp(-max(|x|^2 - 2 x.y + |y|^2, 0) / hh), the value tile.cuh sim_of gives
// (the formula of kernels/ref.py _sim), with the IEEE quotient -d2 / hh
// formed from rhh = __frcp_rn(hh) by one Markstein correction: q0 = -d2 rhh,
// r = -d2 - hh q0 (exact in an FMA), q = q0 + r rhh rounds to the correctly
// rounded quotient for a normal hh as long as nothing over- or underflows.
// d2 is clamped at 110 hh, past which both quotients give expf = 0 (and
// below 2^-25 relative both give 1), so the result is sim_of's to the bit.
// The wrappers keep hh within [1e-20, 1e20], where r never underflows while
// the quotient matters.
__device__ __forceinline__ float sim_rn(float dot, float x2, float y2,
                                        float hh, float rhh) {
  const float d2 = fminf(fmaxf(x2 - 2.0f * dot + y2, 0.0f), 110.0f * hh);
  const float a = -d2;
  const float q0 = a * rhh;
  const float r = fmaf(-hh, q0, a);
  return expf(fmaf(r, rhh, q0));
}

}  // namespace sm90
