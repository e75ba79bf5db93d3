// Facility-location and saturated-coverage marginal gains and their fused
// greedy select steps on Hopper.
//
// Replaces four TPU kernels:
//   src/repro/kernels/facility_gain.py, facility_gain_pallas
//   src/repro/kernels/select_top1.py,   facility_select_pallas
//   src/repro/kernels/coverage_gain.py, coverage_gain_pallas
//   src/repro/kernels/select_top1.py,   coverage_select_pallas
// For every partition p and candidate j, with s = sim(e[p, i], c[p, j]),
//
//   facility:  gain[p, j] = sum_i mask[p, i] * max(s - cov[p, i], 0)
//   coverage:  gain[p, j] = sum_i mask[p, i] * (min(cover[p, i] + max(s, 0),
//                                                   cap[p, i])
//                                               - min(cover[p, i], cap[p, i]))
//
// (Lin & Bilmes' saturated coverage; cap is alpha times each eval row's total
// similarity mass) and the select variants return the masked top-1 of each
// partition's gains (candidates with ok = 0 score NEG; the larger gain wins,
// ties go to the lowest index; (NEG, 0) when nothing is feasible), as
// kernels/ref.py does.  The two objectives share everything but the
// per-pair epilogue (the template parameter COV).  The partition axis is
// the vmap over GreeDi's m machines (src/repro/core/greedi.py:312) written
// out: one launch serves every partition of a greedy step, and each operand
// has its own batch stride, 0 when it is shared (a shared cap, or one
// candidate block under B per-query states).
//
// Bound on this card: 2 * d FLOP per (eval, candidate) pair and only the
// features and the per-row vectors read once, so at d = 64 the kernel is
// bound by its FFMA work, like pairwise.cu; the similarity tile never
// leaves registers.  The coverage epilogue adds two operations per pair
// (3 % at d = 64).
//
// The TPU kernels lean on a sequential grid: `out_ref +=` accumulates over
// eval tiles and the select kernel carries a running best across candidate
// tiles.  Blocks on Hopper run in parallel and in no order, so:
//   * stage 1: a block owns one candidate tile of one partition and loops
//     over its eval tiles in a fixed order, keeping relu(sim - cov) * mask
//     column sums in registers; a fixed-order reduction across the block's
//     threads finishes them.  No atomics, so the sums are deterministic.
//     When candidate tiles x partitions would leave SMs idle (round 2 of
//     GreeDi: 1024 candidates against 262144 eval rows is 8 tiles), the
//     eval axis is split into `chunks` fixed ranges whose partial sums go to
//     a (chunks, P, nc) scratch.
//   * stage 2: sums the chunks in chunk order (gains), or with one chunk the
//     select epilogue writes each tile's own top-1 and a fold takes the
//     top-1 of the tiles of each partition.  The (value, index) order is
//     total, so the fold's tree gives the same answer as a left-to-right one.
#include "tile.cuh"

namespace sm90 {

// `cov` is the facility coverage or the saturated-coverage cover; `cap` is
// read only when COV.
template <typename T, bool RBF, bool TOP1, bool COV>
__global__ void __launch_bounds__(NT, 2)
    facility_stage1(const T* __restrict__ ev, const T* __restrict__ cd,
                    const float* __restrict__ cov,
                    const float* __restrict__ cap,
                    const float* __restrict__ mask,
                    const float* __restrict__ ok, float* __restrict__ part,
                    float* __restrict__ tile_best, int* __restrict__ tile_idx,
                    int64_t n_part, int64_t ne, int64_t nc, int64_t d,
                    int64_t ev_bs, int64_t cd_bs, int64_t cov_bs,
                    int64_t cap_bs, int64_t mask_bs, int64_t ok_bs,
                    int64_t tiles_per_chunk, float hh) {
  __shared__ __align__(16) float xs[BK * LDS];
  __shared__ __align__(16) float ys[BK * LDS];
  __shared__ float covs[BM];
  __shared__ float msks[BM];
  __shared__ float caps[COV ? BM : 1];
  __shared__ float mins[COV ? BM : 1];
  __shared__ float red[NT / 16][BN];
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];

  const int64_t p = blockIdx.y, chunk = blockIdx.z;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  ev += p * ev_bs;
  cd += p * cd_bs;
  cov += p * cov_bs;
  mask += p * mask_bs;
  if (COV) cap += p * cap_bs;
  const int64_t n_tiles = cdiv(ne, BM);
  const int64_t t0 = chunk * tiles_per_chunk;
  const int64_t t1 =
      t0 + tiles_per_chunk < n_tiles ? t0 + tiles_per_chunk : n_tiles;

  float colsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) colsum[j] = 0.0f;

  for (int64_t t = t0; t < t1; ++t) {
    const int64_t row0 = t * BM;
    if (threadIdx.x < BM) {
      const int64_t r = row0 + threadIdx.x;
      const float c = r < ne ? cov[r] : 0.0f;
      covs[threadIdx.x] = c;
      msks[threadIdx.x] = r < ne ? mask[r] : 0.0f;  // ragged rows weigh 0
      if (COV) {
        const float cp = r < ne ? cap[r] : 0.0f;
        caps[threadIdx.x] = cp;
        mins[threadIdx.x] = fminf(c, cp);  // once per row, not per pair
      }
    }
    float acc[8][8], x2[8], y2[8];
    tile_product<T, RBF>(ev, ne, cd, nc, d, row0, col0, xs, ys, acc, x2, y2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float ci = covs[row_of(i)], mi = msks[row_of(i)];
      if (COV) {
        const float capi = caps[row_of(i)], mci = mins[row_of(i)];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float sij = fmaxf(sim_of<RBF>(acc[i][j], x2[i], y2[j], hh),
                                  0.0f);
          colsum[j] += (fminf(ci + sij, capi) - mci) * mi;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          colsum[j] +=
              fmaxf(sim_of<RBF>(acc[i][j], x2[i], y2[j], hh) - ci, 0.0f) * mi;
      }
    }
    __syncthreads();  // the per-row vectors are restaged by the next tile
  }

  // Fixed-order reduction of the 16 row groups of each column.
#pragma unroll
  for (int j = 0; j < 8; ++j) red[threadIdx.x / 16][col_of(j)] = colsum[j];
  __syncthreads();
  float s = 0.0f;
  const int64_t c = col0 + threadIdx.x;
  if (threadIdx.x < BN) {
    for (int g = 0; g < NT / 16; ++g) s += red[g][threadIdx.x];
  }
  if (!TOP1) {
    if (threadIdx.x < BN && c < nc) part[(chunk * n_part + p) * nc + c] = s;
    return;
  }
  // Select epilogue (one chunk): this tile's masked top-1.
  float v = -CUDART_INF_F;
  int vi = 0x7fffffff;
  if (threadIdx.x < BN) {
    v = (c < nc && ok[p * ok_bs + c] > 0.0f) ? s : NEG;
    vi = static_cast<int>(c);
  }
  block_top1(v, vi, wv, wi);
  if (threadIdx.x == 0) {
    tile_best[p * gridDim.x + blockIdx.x] = v;
    tile_idx[p * gridDim.x + blockIdx.x] = vi;
  }
}

// Stage 2 of the gains: gains[p, c] = sum over chunks, in chunk order.
__global__ void __launch_bounds__(NT)
    facility_sum_chunks(const float* __restrict__ part,
                        float* __restrict__ gains, int64_t n_part,
                        int64_t nc, int64_t chunks) {
  const int64_t p = blockIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (c >= nc) return;
  float s = 0.0f;
  for (int64_t k = 0; k < chunks; ++k) s += part[(k * n_part + p) * nc + c];
  gains[p * nc + c] = s;
}

// Stage 2 of the select with several chunks: sum the chunks in chunk order,
// mask with ok, top-1 per partition (one block per partition).
__global__ void __launch_bounds__(NT)
    facility_select_chunks(const float* __restrict__ part,
                           const float* __restrict__ ok,
                           float* __restrict__ best, int* __restrict__ idx,
                           int64_t n_part, int64_t nc, int64_t chunks,
                           int64_t ok_bs) {
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];
  const int64_t p = blockIdx.y;
  float v = -CUDART_INF_F;
  int vi = 0x7fffffff;
  for (int64_t c = threadIdx.x; c < nc; c += NT) {
    float s = 0.0f;
    for (int64_t k = 0; k < chunks; ++k) s += part[(k * n_part + p) * nc + c];
    take_better(v, vi, ok[p * ok_bs + c] > 0.0f ? s : NEG,
                static_cast<int>(c));
  }
  block_top1(v, vi, wv, wi);
  if (threadIdx.x == 0) {
    best[p] = v;
    idx[p] = vi;
  }
}

struct Args {
  const void* ev;
  const void* cd;
  const float* cov;
  const float* cap;  // coverage only
  const float* mask;
  const float* ok;
  int64_t n_part, ne, nc, d, ev_bs, cd_bs, cov_bs, cap_bs, mask_bs, ok_bs,
      chunks;
  float hh;
};

template <typename T, bool RBF, bool TOP1, bool COV>
void stage1(const Args& a, float* part, float* tile_best, int* tile_idx,
            cudaStream_t s) {
  const int64_t tiles_per_chunk = cdiv(cdiv(a.ne, BM), a.chunks);
  const dim3 grid(static_cast<unsigned>(cdiv(a.nc, BN)),
                  static_cast<unsigned>(a.n_part),
                  static_cast<unsigned>(a.chunks));
  facility_stage1<T, RBF, TOP1, COV><<<grid, NT, 0, s>>>(
      static_cast<const T*>(a.ev), static_cast<const T*>(a.cd), a.cov, a.cap,
      a.mask, a.ok, part, tile_best, tile_idx, a.n_part, a.ne, a.nc, a.d,
      a.ev_bs, a.cd_bs, a.cov_bs, a.cap_bs, a.mask_bs, a.ok_bs,
      tiles_per_chunk, a.hh);
}

template <bool TOP1, bool COV>
void stage1_any(const Args& a, int64_t bf16, int64_t rbf, float* part,
                float* tile_best, int* tile_idx, cudaStream_t s) {
  if (bf16) {
    if (rbf)
      stage1<__nv_bfloat16, true, TOP1, COV>(a, part, tile_best, tile_idx, s);
    else
      stage1<__nv_bfloat16, false, TOP1, COV>(a, part, tile_best, tile_idx, s);
  } else {
    if (rbf) stage1<float, true, TOP1, COV>(a, part, tile_best, tile_idx, s);
    else stage1<float, false, TOP1, COV>(a, part, tile_best, tile_idx, s);
  }
}

// Both objectives' gains: stage 1, then the chunk sums in chunk order.
template <bool COV>
int gains_launch(const Args& a, int64_t bf16, int64_t rbf, float* part,
                 float* gains, cudaStream_t s) {
  stage1_any<false, COV>(a, bf16, rbf, part, nullptr, nullptr, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(cdiv(a.nc, NT)),
                  static_cast<unsigned>(a.n_part));
  facility_sum_chunks<<<grid, NT, 0, s>>>(part, gains, a.n_part, a.nc,
                                          a.chunks);
  return static_cast<int>(cudaGetLastError());
}

// Both objectives' select: with one chunk the per-tile top-1 epilogue and
// fold_tiles; with several, the chunk sums and the top-1 in one stage.
template <bool COV>
int select_launch(const Args& a, int64_t bf16, int64_t rbf, float* part,
                  float* tile_best, int* tile_idx, float* best, int* idx,
                  cudaStream_t s) {
  const dim3 grid2(1, static_cast<unsigned>(a.n_part));
  if (a.chunks == 1) {
    stage1_any<true, COV>(a, bf16, rbf, nullptr, tile_best, tile_idx, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fold_tiles<<<grid2, NT, 0, s>>>(tile_best, tile_idx, best, idx,
                                    cdiv(a.nc, BN));
  } else {
    stage1_any<false, COV>(a, bf16, rbf, part, nullptr, nullptr, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    facility_select_chunks<<<grid2, NT, 0, s>>>(part, a.ok, best, idx,
                                                a.n_part, a.nc, a.chunks,
                                                a.ok_bs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// Shapes, in elements: ev (P, ne, d) with batch stride ev_bs (0 = shared),
// cd (P, nc, d) / cd_bs, cov (or cover), cap and mask (P, ne) f32 / cov_bs,
// cap_bs, mask_bs, ok (P, nc) f32 / ok_bs.  Rows are contiguous with row
// stride d.  The caller allocates every output and scratch: `part` holds
// chunks * P * nc floats; with chunks == 1 the select's scratch is
// tile_best / tile_idx, P * ceil(nc / 128) entries each, and `part` is
// unused.  Every entry returns the first launch error, or 0.

// Facility gains (P, nc) f32.
extern "C" int sm90_facility_gain(const void* ev, const void* cd,
                                  const void* cov, const void* mask,
                                  void* part, void* gains, int64_t n_part,
                                  int64_t ne, int64_t nc, int64_t d,
                                  int64_t ev_bs, int64_t cd_bs, int64_t cov_bs,
                                  int64_t mask_bs, int64_t chunks,
                                  int64_t bf16, int64_t rbf, float hh,
                                  void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cov), nullptr,
               static_cast<const float*>(mask), nullptr, n_part, ne, nc, d,
               ev_bs, cd_bs, cov_bs, 0, mask_bs, 0, chunks, hh};
  return gains_launch<false>(a, bf16, rbf, static_cast<float*>(part),
                             static_cast<float*>(gains),
                             static_cast<cudaStream_t>(stream));
}

// Facility select: best (P,) f32 and idx (P,) int32.
extern "C" int sm90_facility_select(
    const void* ev, const void* cd, const void* cov, const void* mask,
    const void* ok, void* part, void* tile_best, void* tile_idx, void* best,
    void* idx, int64_t n_part, int64_t ne, int64_t nc, int64_t d,
    int64_t ev_bs, int64_t cd_bs, int64_t cov_bs, int64_t mask_bs,
    int64_t ok_bs, int64_t chunks, int64_t bf16, int64_t rbf, float hh,
    void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cov), nullptr,
               static_cast<const float*>(mask), static_cast<const float*>(ok),
               n_part, ne, nc, d, ev_bs, cd_bs, cov_bs, 0, mask_bs, ok_bs,
               chunks, hh};
  return select_launch<false>(
      a, bf16, rbf, static_cast<float*>(part), static_cast<float*>(tile_best),
      static_cast<int*>(tile_idx), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}

// Saturated-coverage gains (P, nc) f32.
extern "C" int sm90_coverage_gain(const void* ev, const void* cd,
                                  const void* cover, const void* cap,
                                  const void* mask, void* part, void* gains,
                                  int64_t n_part, int64_t ne, int64_t nc,
                                  int64_t d, int64_t ev_bs, int64_t cd_bs,
                                  int64_t cover_bs, int64_t cap_bs,
                                  int64_t mask_bs, int64_t chunks,
                                  int64_t bf16, int64_t rbf, float hh,
                                  void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cover),
               static_cast<const float*>(cap),
               static_cast<const float*>(mask), nullptr, n_part, ne, nc, d,
               ev_bs, cd_bs, cover_bs, cap_bs, mask_bs, 0, chunks, hh};
  return gains_launch<true>(a, bf16, rbf, static_cast<float*>(part),
                            static_cast<float*>(gains),
                            static_cast<cudaStream_t>(stream));
}

// Saturated-coverage select: best (P,) f32 and idx (P,) int32.
extern "C" int sm90_coverage_select(
    const void* ev, const void* cd, const void* cover, const void* cap,
    const void* mask, const void* ok, void* part, void* tile_best,
    void* tile_idx, void* best, void* idx, int64_t n_part, int64_t ne,
    int64_t nc, int64_t d, int64_t ev_bs, int64_t cd_bs, int64_t cover_bs,
    int64_t cap_bs, int64_t mask_bs, int64_t ok_bs, int64_t chunks,
    int64_t bf16, int64_t rbf, float hh, void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cover),
               static_cast<const float*>(cap),
               static_cast<const float*>(mask), static_cast<const float*>(ok),
               n_part, ne, nc, d, ev_bs, cd_bs, cover_bs, cap_bs, mask_bs,
               ok_bs, chunks, hh};
  return select_launch<true>(
      a, bf16, rbf, static_cast<float*>(part), static_cast<float*>(tile_best),
      static_cast<int*>(tile_idx), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}
