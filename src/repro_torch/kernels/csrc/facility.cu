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
// leaves registers and the output is one float per candidate.  The
// coverage epilogue adds two operations per pair (3 % at d = 64).
//
// The TPU kernels lean on a sequential grid: `out_ref +=` accumulates over
// eval tiles and the select kernel carries a running best across candidate
// tiles.  Blocks on Hopper run in parallel and in no order, so every sum
// runs in a fixed order inside one block and across blocks in a second
// stage: no atomics, and two calls on the same inputs give the same bits.
// When the candidate bands x partitions would leave SMs idle (round 2 of
// GreeDi: 1024 candidates against 262144 eval rows), the eval axis is
// split into `chunks` fixed ranges (the caller's plan, every range
// non-empty) whose partial sums go to a (chunks, P, nc) scratch; stage 2
// sums the chunks in chunk order (gains), or with one chunk the select
// epilogue writes each band's own top-1 and fold_tiles takes the top-1 of
// the bands of each partition (the (value, index) order is total, so the
// fold's tree gives the same answer as a left-to-right one).
//
// Two stage-1 kernels, chosen by an explicit shape rule (persistent(),
// reported by sm90_facility_tma):
//   * facility_kernel (namespace fl), the persistent one: one block of 256
//     threads an SM, up to 255 registers a thread, walking work units of
//     (partition, 256-row candidate band, eval chunk) in pairwise.cu's
//     order (ring.cuh Walk: the bands of one partition run together and
//     share its eval rows in L2).  The band is the resident operand, loaded
//     once a unit by TMA into 128-byte-swizzled boxes; the eval tiles of
//     128 rows stream through a 3-stage TMA ring with a full and an empty
//     mbarrier a stage (each warp arrives on the empty one after its
//     epilogue, thread 0 refills the stage once all have: no block barrier
//     in the loop), and each tile's per-row vectors (cov or cover, mask,
//     cap) travel in the same stage as 2-D TMA loads.  The FFMA loop is
//     ring.cuh box_fma, a 16 x 8 register micro-tile: acc[i][j] is
//     (candidate row i, eval row tx + 16 j).  The epilogue stays in
//     registers: colsum[i] += mask_j * max(s_ij - cov_j, 0) (or the
//     coverage form, min(cover, cap) formed once a row) over the thread's 8
//     eval rows in order, the rbf similarity by sm90.cuh sim_rn from the
//     staged norms (|e|^2 from box_fma, the band's |c|^2 once a unit).  At
//     the end of a unit the 16 lanes that share a candidate row sum it by a
//     fixed __shfl_xor tree; then the band's masked top-1 (one chunk and
//     TOP1) or the partial sums to the chunk scratch.  Rows past ne and nc
//     arrive as TMA's zero fill (mask 0, so they add nothing).
//   * facility_stage1 (below), the first port's: one 128-candidate tile a
//     block, two blocks an SM, tile.cuh's tile_product staging both
//     operands for every 128 x 128 tile, a fixed-order reduction across the
//     block's threads.  It takes the shapes TMA does not: d * itemsize not
//     a multiple of 16, d past the 2 boxes of 128 bytes that fit resident
//     beside the ring, bases (features or vectors) not 16-byte aligned,
//     batched vectors whose rows are not a multiple of 16 bytes apart.
// A launch or build error on either path is returned, never replaced by
// the other path.  Each similarity is one fmaf chain over k ascending from
// 0.0f on both; the gain sums differ in order (the persistent kernel: a
// thread's eval rows in tile order, then the lane tree, then chunk order).
#include "ring.cuh"
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {

// ---------------------------------------------------------------------------
// the first port's stage 1 (the shapes TMA does not take) and the stage-2
// kernels both paths share
// ---------------------------------------------------------------------------

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

namespace fl {

using namespace ring;  // barriers, TMA, the swizzled box, box_fma, Walk

constexpr int NTH = 256;          // threads a block
constexpr int TM = 128;           // eval rows a tile (the streamed operand)
constexpr int TR = 16 * MI;       // candidate rows a band (resident)
constexpr int BOX = TM * 128;     // bytes of an eval box, 128 bytes of d
constexpr int XBOX = TR * 128;    // bytes of a candidate-band box
constexpr int STAGES = 3;         // eval tiles in flight
constexpr int VEC = TM * 4;       // bytes of one per-row vector of a tile
constexpr int MAX_RES_BOXES = 2;  // boxes of d: the band and 3 stages fit

struct Args {
  const float* ok;  // select only
  float* part;      // (chunks, P, nc) partial sums (gains, or chunks > 1)
  float* tile_best;  // (P, n_rb) band top-1s (select with one chunk)
  int* tile_idx;
  int64_t n_part, ne, nc, d, ok_bs;
  int64_t n_rb, n_ct, cpc, cpb, units;  // Walk: bands a partition, eval
                                        // tiles, tiles a chunk, chunks,
                                        // units
  int nb;  // 128-byte boxes of d
  // 1 where the operand's map has a partition axis (else coordinate 0)
  int ev_b, cd_b, cov_b, mask_b, cap_b;
  float hh;
};

// Dynamic shared memory: the band, the ring's feature boxes and vectors,
// the band's norms, the top-1 scratch and the barriers, after 1024 bytes of
// alignment slack.
__host__ __device__ constexpr int smem_bytes(int nb, int nv) {
  return 1024 + nb * (XBOX + STAGES * BOX) + STAGES * nv * VEC + TR * 4 +
         16 * 8 + 8 * (2 + 2 * STAGES);
}

template <typename T, bool RBF, bool TOP1, bool COV>
__global__ void __launch_bounds__(NTH, 1)
    facility_kernel(const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap emap,
                    const __grid_constant__ CUtensorMap covmap,
                    const __grid_constant__ CUtensorMap maskmap,
                    const __grid_constant__ CUtensorMap capmap,
                    const Args a) {
  constexpr int NV = COV ? 3 : 2;  // per-row vectors: cov, mask (, cap)
  constexpr int BC = 128 / sizeof(T);
  extern __shared__ __align__(16) char smem_raw[];
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  char* xs = sm;                // the candidate band: nb boxes of TR rows
  char* ys = xs + a.nb * XBOX;  // eval tiles: STAGES x nb boxes
  float* vs = reinterpret_cast<float*>(ys + STAGES * a.nb * BOX);
  float* bn = vs + STAGES * NV * TM;  // the band's |c|^2 (rbf)
  float* tv = bn + TR;                // top-1 scratch: 2 x 8 (value, index)
  int* ti = reinterpret_cast<int*>(tv + 16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ti + 16);
  const uint32_t xfull = smem_u32(bars), xempty = smem_u32(bars + 1);
  auto efull = [&](int s) { return smem_u32(bars + 2 + s); };
  auto eempty = [&](int s) { return smem_u32(bars + 2 + STAGES + s); };

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, h = lane >> 4;
  const uint32_t xbytes = static_cast<uint32_t>(a.nb) * XBOX;
  const uint32_t ebytes = static_cast<uint32_t>(a.nb) * BOX + NV * VEC;
  const float rhh = RBF ? __frcp_rn(a.hh) : 0.0f;

  auto load_band = [&](const Walk& t) {
    mbar_expect_tx(xfull, xbytes);
    for (int kb = 0; kb < a.nb; ++kb)
      tma_load3(smem_u32(xs + kb * XBOX), &cmap, kb * BC,
                static_cast<int>(t.rb * TR), a.cd_b ? static_cast<int>(t.b) : 0,
                xfull);
  };
  auto load_tile = [&](const Walk& t, int s) {
    const uint32_t bar = efull(s);
    const int row0 = static_cast<int>(t.ct * TM);
    const int p = static_cast<int>(t.b);
    mbar_expect_tx(bar, ebytes);
    for (int kb = 0; kb < a.nb; ++kb)
      tma_load3(smem_u32(ys + (s * a.nb + kb) * BOX), &emap, kb * BC, row0,
                a.ev_b ? p : 0, bar);
    float* v = vs + s * NV * TM;
    tma_load2(smem_u32(v), &covmap, row0, a.cov_b ? p : 0, bar);
    tma_load2(smem_u32(v + TM), &maskmap, row0, a.mask_b ? p : 0, bar);
    if (COV) tma_load2(smem_u32(v + 2 * TM), &capmap, row0, a.cap_b ? p : 0,
                       bar);
  };

  Walk cur;
  cur.start(blockIdx.x, a);
  Walk fill = cur;  // thread 0: the next tile to load into the ring
  if (tid == 0) {
    mbar_init(xfull, 1);
    mbar_init(xempty, NTH / 32);  // one arrival a warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(efull(s), 1);
      mbar_init(eempty(s), NTH / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (cur.valid) {
      load_band(cur);
      for (int s = 0; s < STAGES && fill.valid; ++s) {
        load_tile(fill, s);
        fill.next(a);
      }
    }
  }
  __syncthreads();

  float colsum[MI];  // candidate row i's sum over this thread's eval rows
  int64_t n = 0;     // tiles done by this block
  uint32_t xi = 0;   // bands loaded before this tile's
  uint32_t nu = 0;   // units finished (the top-1 scratch alternates)
  for (; cur.valid; ++n) {
    const int s = static_cast<int>(n % STAGES);
    const uint32_t ph = static_cast<uint32_t>((n / STAGES) & 1);
    if (cur.fresh) {
      if (n > 0) ++xi;
#pragma unroll
      for (int i = 0; i < MI; ++i) colsum[i] = 0.0f;
      mbar_wait(xfull, xi & 1);
      if (RBF) {  // |c|^2 of the warp's 32 band rows (lane l: row 32 w + l)
        float c2 = 0.0f;
        for (int kb = 0; kb < a.nb; ++kb)
          c2 = row_norm<T>(xs + kb * XBOX, 32 * w + lane,
                           static_cast<int>(min64(BC, a.d - int64_t{kb} * BC)),
                           c2);
        bn[32 * w + lane] = c2;
        __syncwarp();
      }
    }
    mbar_wait(efull(s), ph);
    float acc[MI][8], y2[8];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) y2[j] = 0.0f;
    for (int kb = 0; kb < a.nb; ++kb)
      box_fma<T, RBF>(xs + kb * XBOX + (32 * w + 4 * h) * 128,
                      ys + (s * a.nb + kb) * BOX, groups_of(a.d, kb, BC), h,
                      tx, acc, y2);

    // epilogue in registers: the thread's 8 eval rows in order, each row's
    // vectors read once from the stage
    const float* vc = vs + s * NV * TM;
    float xn[MI];
    if (RBF) {
#pragma unroll
      for (int i = 0; i < MI; ++i) xn[i] = bn[32 * w + row_in_warp(i, h)];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tx + 16 * j;
      const float cj = vc[r], mj = vc[TM + r];
      const float capj = COV ? vc[2 * TM + r] : 0.0f;
      const float mcj = COV ? fminf(cj, capj) : 0.0f;  // once a row
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        // sim_rn(dot, |e|^2, |c|^2): the operand order of tile.cuh sim_of
        const float sij =
            RBF ? sim_rn(acc[i][j], y2[j], xn[i], a.hh, rhh) : acc[i][j];
        if (COV)
          colsum[i] = fmaf(fminf(cj + fmaxf(sij, 0.0f), capj) - mcj, mj,
                           colsum[i]);
        else
          colsum[i] = fmaf(fmaxf(sij - cj, 0.0f), mj, colsum[i]);
      }
    }

    const Walk done = cur;
    cur.next(a);  // the next tile: a fresh one needs a new band
    // this warp is done with the stage (and, before a new unit, the band);
    // thread 0 refills them once every warp is
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(eempty(s));
      if (cur.valid && cur.fresh) mbar_arrive(xempty);
    }
    if (tid == 0) {
      mbar_wait(eempty(s), ph);
      if (fill.valid) {
        load_tile(fill, s);
        fill.next(a);
      }
      if (cur.valid && cur.fresh) {
        mbar_wait(xempty, xi & 1);
        load_band(cur);
      }
    }
    if (cur.valid && !cur.fresh) continue;

    // the unit is done: the 16 lanes (tx) that share candidate row i sum
    // colsum[i] by a fixed butterfly (every lane gets the same bits), and
    // lane tx keeps row i = tx
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], off);
    }
    float v = colsum[0];
#pragma unroll
    for (int i = 1; i < MI; ++i)
      if (tx == i) v = colsum[i];
    const int64_t c = done.rb * TR + 32 * w + row_in_warp(tx, h);
    if (TOP1) {
      float bv = (c < a.nc && a.ok[done.b * a.ok_bs + c] > 0.0f) ? v : NEG;
      int bi = static_cast<int>(c);
      block_top1(bv, bi, tv + 8 * (nu & 1), ti + 8 * (nu & 1));
      if (tid == 0) {
        a.tile_best[done.b * a.n_rb + done.rb] = bv;
        a.tile_idx[done.b * a.n_rb + done.rb] = bi;
      }
    } else if (c < a.nc) {
      a.part[((done.u % a.cpb) * a.n_part + done.b) * a.nc + c] = v;
    }
    ++nu;
  }
}

// ---------------------------------------------------------------------------
// host side: the shape rule, the maps and the launch
// ---------------------------------------------------------------------------

// Whether a per-row vector loads by TMA: absent, or a 16-byte aligned base
// and, when it has a partition axis that the launch walks, rows a multiple
// of 16 bytes apart.
inline bool vec_ok(const void* p, int64_t bs, int64_t n_part) {
  return p == nullptr ||
         (aligned16(p) && (bs == 0 || n_part == 1 || (bs * 4) % 16 == 0));
}

// The shape rule: the persistent kernel takes the call when its features
// load by TMA (rows of a multiple of 16 bytes, 16-byte aligned bases, at
// most MAX_RES_BOXES boxes of d so the band and the ring fit) and so do its
// vectors; rows and partitions fit TMA's int32 coordinates.
inline bool persistent(const void* ev, const void* cd, const void* cov,
                       const void* cap, const void* mask, int64_t n_part,
                       int64_t ne, int64_t nc, int64_t d, int64_t cov_bs,
                       int64_t cap_bs, int64_t mask_bs, int esz) {
  return (d * esz) % 16 == 0 && cdiv(d, 128 / esz) <= MAX_RES_BOXES &&
         aligned16(ev) && aligned16(cd) && vec_ok(cov, cov_bs, n_part) &&
         vec_ok(cap, cap_bs, n_part) && vec_ok(mask, mask_bs, n_part) &&
         ne < (int64_t{1} << 30) && nc < (int64_t{1} << 30) &&
         n_part < (int64_t{1} << 30);
}

// A 2-D map (n, partitions) of float32 with boxes of TM x 1, unswizzled;
// a partition extent of 1 for a vector the partitions share.  Sets *batched
// to whether the map has the partition axis.
inline int make_vec_map(CUtensorMap* map, const float* ptr, int64_t n,
                        int64_t n_part, int64_t bs, int* batched) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  *batched = bs != 0 && n_part > 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(*batched ? n_part : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(
      *batched ? bs * 4 : cdiv(n * 4, 16) * 16)};
  const cuuint32_t box[2] = {TM, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                           const_cast<float*>(ptr), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

struct Maps {
  CUtensorMap c, e, cov, mask, cap;
};

template <typename T, bool RBF, bool TOP1, bool COV>
int launch(const Maps& m, const Args& a, int grid, cudaStream_t stream) {
  const int smem = smem_bytes(a.nb, COV ? 3 : 2);
  auto kern = facility_kernel<T, RBF, TOP1, COV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NTH, smem, stream>>>(m.c, m.e, m.cov, m.mask, m.cap, a);
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 on the persistent kernel: units of (partition, band, chunk),
// one block an SM (fewer when there are fewer units).
template <bool TOP1, bool COV>
int run(const sm90::Args& c, int64_t bf16, int64_t rbf, float* part,
        float* tile_best, int* tile_idx, cudaStream_t stream) {
  const int esz = bf16 ? 2 : 4;
  const int bc = 128 / esz;  // elements of d a 128-byte box
  Args a{};
  a.ok = c.ok;
  a.part = part;
  a.tile_best = tile_best;
  a.tile_idx = tile_idx;
  a.n_part = c.n_part;
  a.ne = c.ne;
  a.nc = c.nc;
  a.d = c.d;
  a.ok_bs = c.ok_bs;
  a.n_rb = cdiv(c.nc, TR);
  a.n_ct = cdiv(c.ne, TM);
  a.cpc = cdiv(a.n_ct, c.chunks);
  a.cpb = c.chunks;
  a.units = c.n_part * a.n_rb * a.cpb;
  a.nb = static_cast<int>(cdiv(c.d, bc));
  a.ev_b = c.ev_bs != 0 && c.n_part > 1;
  a.cd_b = c.cd_bs != 0 && c.n_part > 1;
  a.hh = c.hh;
  const int grid = static_cast<int>(min64(a.units, sm_count()));

  Maps m{};
  const CUtensorMapDataType type = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = make_map(&m.c, type, esz, c.cd, c.d, c.nc, a.cd_b ? c.n_part : 1,
                     c.d, a.cd_b ? c.cd_bs : c.nc * c.d, bc, TR);
  if (err == 0)
    err = make_map(&m.e, type, esz, c.ev, c.d, c.ne, a.ev_b ? c.n_part : 1,
                   c.d, a.ev_b ? c.ev_bs : c.ne * c.d, bc, TM);
  if (err == 0)
    err = make_vec_map(&m.cov, c.cov, c.ne, c.n_part, c.cov_bs, &a.cov_b);
  if (err == 0)
    err = make_vec_map(&m.mask, c.mask, c.ne, c.n_part, c.mask_bs, &a.mask_b);
  if (err == 0 && COV)
    err = make_vec_map(&m.cap, c.cap, c.ne, c.n_part, c.cap_bs, &a.cap_b);
  if (err != 0) return err;
  if (!COV) m.cap = m.mask;  // unused
  if (bf16)
    return rbf ? launch<__nv_bfloat16, true, TOP1, COV>(m, a, grid, stream)
               : launch<__nv_bfloat16, false, TOP1, COV>(m, a, grid, stream);
  return rbf ? launch<float, true, TOP1, COV>(m, a, grid, stream)
             : launch<float, false, TOP1, COV>(m, a, grid, stream);
}

}  // namespace fl

bool takes_persistent(const Args& a, int64_t bf16) {
  return fl::persistent(a.ev, a.cd, a.cov, a.cap, a.mask, a.n_part, a.ne,
                        a.nc, a.d, a.cov_bs, a.cap_bs, a.mask_bs,
                        bf16 ? 2 : 4);
}

// Candidate rows of a stage-1 block's band (tile path) or unit's band
// (persistent path): the select's per-band scratch holds P * ceil(nc / band)
// entries.
int band_of(bool persistent) { return persistent ? fl::TR : BN; }

// A plan the kernels take: at least one chunk, every chunk non-empty (the
// stage-2 sums read every chunk's partials), the grid within CUDA's limits.
bool plan_ok(const Args& a) {
  const int64_t tiles = cdiv(a.ne, BM);
  return a.n_part >= 1 && a.ne >= 1 && a.nc >= 1 && a.d >= 1 &&
         a.n_part <= 65535 && a.chunks >= 1 && a.chunks <= 65535 &&
         (a.chunks - 1) * cdiv(tiles, a.chunks) < tiles;
}

// Stage 1 on the path the shape rule picks.
template <bool TOP1, bool COV>
int stage1_run(const Args& a, int64_t bf16, int64_t rbf, float* part,
               float* tile_best, int* tile_idx, cudaStream_t s) {
  if (takes_persistent(a, bf16))
    return fl::run<TOP1, COV>(a, bf16, rbf, part, tile_best, tile_idx, s);
  stage1_any<TOP1, COV>(a, bf16, rbf, part, tile_best, tile_idx, s);
  return static_cast<int>(cudaGetLastError());
}

// Both objectives' gains: stage 1, then the chunk sums in chunk order.
template <bool COV>
int gains_launch(const Args& a, int64_t bf16, int64_t rbf, float* part,
                 float* gains, cudaStream_t s) {
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = stage1_run<false, COV>(a, bf16, rbf, part, nullptr,
                                         nullptr, s);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(cdiv(a.nc, NT)),
                  static_cast<unsigned>(a.n_part));
  facility_sum_chunks<<<grid, NT, 0, s>>>(part, gains, a.n_part, a.nc,
                                          a.chunks);
  return static_cast<int>(cudaGetLastError());
}

// Both objectives' select: with one chunk the per-band top-1 epilogue and
// fold_tiles; with several, the chunk sums and the top-1 in one stage.
template <bool COV>
int select_launch(const Args& a, int64_t bf16, int64_t rbf, float* part,
                  float* tile_best, int* tile_idx, float* best, int* idx,
                  cudaStream_t s) {
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid2(1, static_cast<unsigned>(a.n_part));
  if (a.chunks == 1) {
    const int err = stage1_run<true, COV>(a, bf16, rbf, nullptr, tile_best,
                                          tile_idx, s);
    if (err != 0) return err;
    fold_tiles<<<grid2, NT, 0, s>>>(
        tile_best, tile_idx, best, idx,
        cdiv(a.nc, band_of(takes_persistent(a, bf16))));
  } else {
    const int err = stage1_run<false, COV>(a, bf16, rbf, part, nullptr,
                                           nullptr, s);
    if (err != 0) return err;
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
// stride d.  The caller allocates every output and scratch from the plan
// (sm90_facility_tma picks the path, sm90_facility_band gives its band):
// `part` holds chunks * P * nc floats, every chunk covering at least one
// of the ceil(ne / 128) eval tiles (chunk c: tiles [c t, (c + 1) t) with
// t = ceil(tiles / chunks)); with chunks == 1 the select's scratch is
// tile_best / tile_idx, P * ceil(nc / band) entries each, and `part` is
// unused.  Every entry returns the first launch error, a tensor-map error
// (driver errors offset by 10000), or 0; a plan it does not take is
// cudaErrorInvalidValue.

// 1 when a call with these operands takes the persistent TMA kernel, 0
// when the first port's tile kernel (the tests and the smoke check that
// the main shapes take the first).  cap is NULL for facility location.
extern "C" int sm90_facility_tma(const void* ev, const void* cd,
                                 const void* cov, const void* cap,
                                 const void* mask, int64_t n_part, int64_t ne,
                                 int64_t nc, int64_t d, int64_t cov_bs,
                                 int64_t cap_bs, int64_t mask_bs,
                                 int64_t bf16) {
  return sm90::fl::persistent(ev, cd, cov, cap, mask, n_part, ne, nc, d,
                              cov_bs, cap_bs, mask_bs, bf16 ? 2 : 4);
}

// Candidate rows of a band on each path (tma != 0: the persistent kernel).
extern "C" int sm90_facility_band(int64_t tma) {
  return sm90::band_of(tma != 0);
}

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
