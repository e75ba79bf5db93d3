// Pairwise similarity blocks on Hopper.
//
// Replaces: src/repro/kernels/pairwise.py, pairwise_pallas (TPU).  It builds
// the similarity matrices the GreeDi fast engine caches: every shard's
// round-1 block s11 = sim(local, local) and the merge block
// s2 = sim(local, merged candidates) (src/repro/core/greedi.py:956, 996).
//
// out[b, i, j] = x[b, i] . y[b, j]                          (linear)
//              = exp(-max(|x|^2 - 2 x.y + |y|^2, 0) / h^2)  (rbf)
// f32 or bf16 inputs (loaded and converted to f32, as the Pallas body's
// .astype(jnp.float32)), f32 output.
//
// Bound on this card: at d = 64 each output float costs 2 * 64 FLOP for
// 4 bytes written, 32 FLOP/B against the ~20 FLOP/B ridge of FP32 FFMA on an
// H100 SXM (67 TFLOP/s over 3.35 TB/s), so the kernel is bound by its FFMA
// work.  The design keeps the FFMA units fed from registers: 128 x 128 tiles,
// an 8 x 8 micro-tile per thread (64 FFMA per 16 shared-memory floats read),
// the rbf norms taken from the staged tiles, and float4 stores of finished
// rows.  No tensor cores: the port keeps full FP32 (no TF32) until a later
// change brings a tensor-core variant with its own tolerance.
//
// Grid: (column tiles, row tiles, batch).  blockIdx.z walks the batch (all
// shards' s11 in one launch); a zero batch stride on y shares one candidate
// block across the batch (s2 for every shard in one launch).
#include "tile.cuh"

namespace sm90 {

template <typename T, bool RBF>
__global__ void __launch_bounds__(NT, 2)
    pairwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    float* __restrict__ out, int64_t nx, int64_t ny,
                    int64_t d, int64_t x_bs, int64_t y_bs, float hh) {
  __shared__ __align__(16) float xs[BK * LDS];
  __shared__ __align__(16) float ys[BK * LDS];
  const int64_t b = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  x += b * x_bs;
  y += b * y_bs;
  out += b * nx * ny;

  float acc[8][8], x2[8], y2[8];
  tile_product<T, RBF>(x, nx, y, ny, d, row0, col0, xs, ys, acc, x2, y2);

  const bool vec = (ny % 4) == 0;  // rows start 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + row_of(i);
    if (r >= nx) continue;
    float* orow = out + r * ny;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t c = col0 + col_of(half * 4);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = sim_of<RBF>(acc[i][half * 4 + q], x2[i], y2[half * 4 + q], hh);
      if (vec && c < ny) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2],
                                                           v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < ny) orow[c + q] = v[q];
      }
    }
  }
}

template <typename T, bool RBF>
void launch(const void* x, const void* y, void* out, int64_t batch,
            int64_t nx, int64_t ny, int64_t d, int64_t x_bs, int64_t y_bs,
            float hh, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(cdiv(ny, BN)),
                  static_cast<unsigned>(cdiv(nx, BM)),
                  static_cast<unsigned>(batch));
  pairwise_kernel<T, RBF><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<float*>(out), nx, ny, d, x_bs, y_bs, hh);
}

}  // namespace sm90

// x: (batch, nx, d) with batch stride x_bs elements; y: (batch, ny, d) with
// batch stride y_bs (0 = shared); out: (batch, nx, ny) float32, contiguous.
// bf16 != 0 selects bfloat16 inputs, rbf != 0 the rbf similarity with
// hh = h * h.  Returns the launch's cudaGetLastError().
extern "C" int sm90_pairwise(const void* x, const void* y, void* out,
                             int64_t batch, int64_t nx, int64_t ny, int64_t d,
                             int64_t x_bs, int64_t y_bs, int64_t bf16,
                             int64_t rbf, float hh, void* stream) {
  using namespace sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (rbf) launch<__nv_bfloat16, true>(x, y, out, batch, nx, ny, d, x_bs, y_bs, hh, s);
    else launch<__nv_bfloat16, false>(x, y, out, batch, nx, ny, d, x_bs, y_bs, hh, s);
  } else {
    if (rbf) launch<float, true>(x, y, out, batch, nx, ny, d, x_bs, y_bs, hh, s);
    else launch<float, false>(x, y, out, batch, nx, ny, d, x_bs, y_bs, hh, s);
  }
  return static_cast<int>(cudaGetLastError());
}
