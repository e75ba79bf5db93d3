// Information-gain conditional variances and the fused GP active-set select
// step on Hopper.
//
// Replaces two TPU kernels:
//   src/repro/kernels/info_gain.py,  info_gain_cond_pallas
//   src/repro/kernels/select_top1.py, info_select_pallas
// For every partition p and candidate j,
//
//   cond[p, j] = max(k_vv[j] + ridge - || linv[p] @ k(sel[p], c[p, j]) ||^2,
//                    1e-12)
//
// with k_vv = 1 (rbf) or |c_j|^2 (linear), and the select variant returns
// the top-1 cond of each partition (candidates with ok = 0 score 0.0, which
// every feasible cond >= 1e-12 beats; the larger cond wins, ties go to the
// lowest index; (0.0, 0) when nothing is feasible), as kernels/ref.py does.
// `linv` is inv(chol(K_SS + ridge I)) with the columns past the selection
// count zeroed; it is always float32, sel and c are float32 or bf16
// (widened on staging).  The partition axis is GreeDi's m machines; each
// operand has its own batch stride, 0 when it is shared (round 2 of the
// generic engine shares the candidate block).
//
// Bound on this card: per candidate a (k x d) cross-kernel column and a
// dense (k x k) product with linv -- 2 k^2 of about 2 k^2 + 2 k d FLOP at
// d = 6, k = 128 -- so the kernel is bound by FP32 FFMA work; the features
// are read once.  It computes the same dense product as the TPU kernel,
// whatever the selection count (skipping the zero columns of linv or its
// upper triangle is exact but left to a later change, ROADMAP.md).
//
// Design: one block owns one 128-candidate tile of one partition.
//   * phase 1: the (k x 128) cross-kernel tile X = k(sel, c_tile) comes from
//     the shared FP32 tile product (tile.cuh), with the rbf epilogue and
//     |c|^2 taken from the staged tiles as info_gain.py does, rows past k
//     zeroed.  X lives in dynamic shared memory while k <= 384 (64 KB per
//     128 rows); above that in a per-block scratch in device memory, and
//     the grid is capped so the scratch stays bounded (the block then
//     strides over candidate tiles).
//   * phase 2: linv @ X one 128-row tile at a time, linv staged in chunks
//     of 16 columns and X in chunks of 16 rows, the same 8 x 8 register
//     micro-tile; each thread squares and sums its 8 rows per column, and a
//     fixed-order reduction over the 16 row groups finishes the column.  No
//     atomics: every sum has one order, so results do not depend on
//     scheduling.
//   * select: the tile's top-1 in the block, then fold_tiles (tile.cuh) over
//     the tiles of each partition -- the deterministic second stage in place
//     of the TPU's sequential running best.
#include "tile.cuh"

namespace sm90 {

constexpr int IG_SMEM_ROW_TILES = 3;  // k <= 384 keeps X in shared memory
constexpr int64_t IG_SCRATCH_BLOCKS = 264;  // 2 per SM: the scratch grid

// Whether X leaves shared memory for the device scratch at this k.
__host__ inline bool ig_uses_scratch(int64_t k) {
  return cdiv(k, BM) > IG_SMEM_ROW_TILES;
}

// Blocks along the candidate tiles: one per tile while X stays on chip;
// with the scratch at most IG_SCRATCH_BLOCKS over all partitions, each
// block striding over tiles, so the scratch stays bounded.
__host__ inline int64_t ig_grid_x(int64_t n_part, int64_t k, int64_t nc) {
  const int64_t n_tiles = cdiv(nc, BN);
  if (!ig_uses_scratch(k)) return n_tiles;
  const int64_t cap = IG_SCRATCH_BLOCKS / n_part;
  return n_tiles < cap ? n_tiles : (cap > 1 ? cap : 1);
}

// Floats of device scratch a launch needs: 0 while X fits in shared
// memory, else one (ceil(k / 128) * 128) x 128 tile per block.
__host__ inline int64_t ig_scratch_floats(int64_t n_part, int64_t k,
                                          int64_t nc) {
  if (!ig_uses_scratch(k)) return 0;
  return n_part * ig_grid_x(n_part, k, nc) * cdiv(k, BM) * BM * BN;
}

// acc[i][j] += sum_l as[l * LDS + row_of(i)] * bs[l * LDS + col_of(j)] over
// one staged chunk of BK, in increasing l (the inner loop of tile_product).
__device__ __forceinline__ void chunk_fma(const float* __restrict__ as,
                                          const float* __restrict__ bs,
                                          float (&acc)[8][8]) {
  const int tx4 = (threadIdx.x % 16) * 4, ty4 = (threadIdx.x / 16) * 4;
#pragma unroll
  for (int l = 0; l < BK; ++l) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[l * LDS + ty4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&as[l * LDS + 64 + ty4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[l * LDS + tx4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&bs[l * LDS + 64 + tx4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <typename T, bool RBF, bool TOP1>
__global__ void __launch_bounds__(NT, 2)
    info_gain_kernel(const T* __restrict__ sel,
                     const float* __restrict__ linv, const T* __restrict__ cd,
                     const float* __restrict__ ok, float* __restrict__ scratch,
                     float* __restrict__ cond, float* __restrict__ tile_best,
                     int* __restrict__ tile_idx, int64_t k, int64_t nc,
                     int64_t d, int64_t sel_bs, int64_t linv_bs,
                     int64_t cd_bs, int64_t ok_bs, float hh, float ridge) {
  extern __shared__ __align__(16) float xsm[];  // X when it fits
  __shared__ __align__(16) float as[BK * LDS];
  __shared__ __align__(16) float bs[BK * LDS];
  __shared__ float red[NT / 16][BN];
  __shared__ float kvvs[BN];
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];

  const int64_t p = blockIdx.y;
  sel += p * sel_bs;
  linv += p * linv_bs;
  cd += p * cd_bs;
  const int64_t rows = cdiv(k, BM) * BM;  // rows of X, whole 128-row tiles
  float* X = scratch == nullptr
                 ? xsm
                 : scratch + (p * gridDim.x + blockIdx.x) * rows * BN;
  const int64_t n_tiles = cdiv(nc, BN);

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t col0 = tile * BN;
    // ---- phase 1: X[l, j] = k(sel_l, c_j); rows l >= k are zero --------
    for (int64_t r0 = 0; r0 < rows; r0 += BM) {
      float acc[8][8], x2[8], y2[8];
      tile_product<T, true>(sel, k, cd, nc, d, r0, col0, as, bs, acc, x2,
                            y2);
      if (r0 == 0 && threadIdx.x < 16) {  // ty == 0 holds every column once
#pragma unroll
        for (int j = 0; j < 8; ++j) kvvs[col_of(j)] = RBF ? 1.0f : y2[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = r0 + row_of(i);
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = row < k ? sim_of<RBF>(acc[i][j], x2[i], y2[j], hh) : 0.0f;
        float* dst = X + row * BN;
        *reinterpret_cast<float4*>(&dst[col_of(0)]) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(&dst[col_of(4)]) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();  // X and kvvs complete

    // ---- phase 2: column sums of (linv @ X)^2, one 128-row tile at a time
    float sq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sq[j] = 0.0f;
    for (int64_t r0 = 0; r0 < rows; r0 += BM) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      for (int64_t l0 = 0; l0 < k; l0 += BK) {
        stage(linv, k, k, r0, l0, as);  // as[l * LDS + i] = linv[r0+i, l0+l]
        for (int q = threadIdx.x; q < BK * BN / 4; q += NT) {
          const int l = q / (BN / 4), j4 = (q % (BN / 4)) * 4;
          *reinterpret_cast<float4*>(&bs[l * LDS + j4]) =
              *reinterpret_cast<const float4*>(&X[(l0 + l) * BN + j4]);
        }
        __syncthreads();
        chunk_fma(as, bs, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sq[j] = fmaf(acc[i][j], acc[i][j], sq[j]);
      }
    }

    // ---- epilogue: fixed-order sum of the 16 row groups of each column --
#pragma unroll
    for (int j = 0; j < 8; ++j) red[threadIdx.x / 16][col_of(j)] = sq[j];
    __syncthreads();
    const int64_t c = col0 + threadIdx.x;
    float cv = 0.0f;
    if (threadIdx.x < BN) {
      float s = 0.0f;
      for (int g = 0; g < NT / 16; ++g) s += red[g][threadIdx.x];
      cv = fmaxf(kvvs[threadIdx.x] + ridge - s, 1e-12f);
      if (!TOP1 && c < nc) cond[p * nc + c] = cv;
    }
    if (TOP1) {
      float v = -CUDART_INF_F;
      int vi = 0x7fffffff;
      if (threadIdx.x < BN && c < nc) {
        v = ok[p * ok_bs + c] > 0.0f ? cv : 0.0f;
        vi = static_cast<int>(c);
      }
      block_top1(v, vi, wv, wi);
      if (threadIdx.x == 0) {
        tile_best[p * n_tiles + tile] = v;
        tile_idx[p * n_tiles + tile] = vi;
      }
    }
    __syncthreads();  // red, kvvs and X are rewritten by the next tile
  }
}

struct IGArgs {
  const void* sel;
  const float* linv;
  const void* cd;
  const float* ok;
  float* scratch;
  int64_t n_part, k, nc, d, sel_bs, linv_bs, cd_bs, ok_bs;
  float hh, ridge;
};

template <typename T, bool RBF, bool TOP1>
cudaError_t launch(const IGArgs& a, float* cond, float* tile_best,
                   int* tile_idx, cudaStream_t s) {
  auto kern = info_gain_kernel<T, RBF, TOP1>;
  const size_t smem =
      a.scratch == nullptr ? sizeof(float) * cdiv(a.k, BM) * BM * BN : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ig_grid_x(a.n_part, a.k, a.nc)),
                  static_cast<unsigned>(a.n_part));
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(a.sel), a.linv, static_cast<const T*>(a.cd), a.ok,
      a.scratch, cond, tile_best, tile_idx, a.k, a.nc, a.d, a.sel_bs,
      a.linv_bs, a.cd_bs, a.ok_bs, a.hh, a.ridge);
  return cudaGetLastError();
}

template <bool TOP1>
cudaError_t launch_any(const IGArgs& a, int64_t bf16, int64_t rbf,
                       float* cond, float* tile_best, int* tile_idx,
                       cudaStream_t s) {
  if (a.scratch == nullptr && ig_uses_scratch(a.k))
    return cudaErrorInvalidValue;  // X does not fit: the caller owes scratch
  if (bf16) {
    if (rbf)
      return launch<__nv_bfloat16, true, TOP1>(a, cond, tile_best, tile_idx,
                                               s);
    return launch<__nv_bfloat16, false, TOP1>(a, cond, tile_best, tile_idx,
                                              s);
  }
  if (rbf) return launch<float, true, TOP1>(a, cond, tile_best, tile_idx, s);
  return launch<float, false, TOP1>(a, cond, tile_best, tile_idx, s);
}

}  // namespace sm90

// Shapes, in elements: sel (P, k, d) with batch stride sel_bs (0 = shared),
// linv (P, k, k) f32 / linv_bs, cd (P, nc, d) / cd_bs, ok (P, nc) f32 /
// ok_bs.  Rows are contiguous.  `scratch` holds the floats that
// sm90_info_scratch_floats reports for (P, k, nc), NULL when that is 0.  The
// caller allocates every output and the scratch.

// *floats = the device scratch, in floats, of a launch at (P, k, nc).
extern "C" int sm90_info_scratch_floats(int64_t n_part, int64_t k,
                                        int64_t nc, int64_t* floats) {
  *floats = sm90::ig_scratch_floats(n_part, k, nc);
  return 0;
}

// cond (P, nc) f32.  Returns the first launch error, or 0.
extern "C" int sm90_info_gain_cond(const void* sel, const void* linv,
                                   const void* cd, void* scratch, void* cond,
                                   int64_t n_part, int64_t k, int64_t nc,
                                   int64_t d, int64_t sel_bs, int64_t linv_bs,
                                   int64_t cd_bs, int64_t bf16, int64_t rbf, float hh,
                                   float ridge, void* stream) {
  using namespace sm90;
  const IGArgs a{sel, static_cast<const float*>(linv), cd, nullptr,
                 static_cast<float*>(scratch), n_part, k, nc, d, sel_bs,
                 linv_bs, cd_bs, 0, hh, ridge};
  return static_cast<int>(launch_any<false>(
      a, bf16, rbf, static_cast<float*>(cond), nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// best (P,) f32 and idx (P,) int32, through tile_best / tile_idx, P *
// ceil(nc / 128) entries each.  Returns the first launch error, or 0.
extern "C" int sm90_info_select(const void* sel, const void* linv,
                                const void* cd, const void* ok, void* scratch,
                                void* tile_best, void* tile_idx, void* best,
                                void* idx, int64_t n_part, int64_t k,
                                int64_t nc, int64_t d, int64_t sel_bs,
                                int64_t linv_bs, int64_t cd_bs, int64_t ok_bs,
                                int64_t bf16, int64_t rbf,
                                float hh, float ridge, void* stream) {
  using namespace sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const IGArgs a{sel, static_cast<const float*>(linv), cd,
                 static_cast<const float*>(ok), static_cast<float*>(scratch),
                 n_part, k, nc, d, sel_bs, linv_bs, cd_bs, ok_bs, hh, ridge};
  cudaError_t err = launch_any<true>(a, bf16, rbf, nullptr,
                                     static_cast<float*>(tile_best),
                                     static_cast<int*>(tile_idx), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(1, static_cast<unsigned>(n_part));
  fold_tiles<<<grid2, NT, 0, s>>>(static_cast<const float*>(tile_best),
                                  static_cast<const int*>(tile_idx),
                                  static_cast<float*>(best),
                                  static_cast<int*>(idx), cdiv(nc, BN));
  return static_cast<int>(cudaGetLastError());
}
