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
// Stage 1 is one persistent kernel, facility_kernel (namespace fl), for
// every width and alignment: one block of 256 threads an SM, up to 255
// registers a thread, walking work units of (partition, 256-row candidate
// band, eval chunk) in pairwise.cu's order (ring.cuh Walk: the bands of one
// partition run together and share its eval rows in L2).  The eval tiles
// of 128 rows stream through a TMA ring (cp.async.bulk.tensor, 128-byte
// swizzle) with a full and an empty mbarrier a stage (each warp arrives on
// the empty one after its products, thread 0 refills the stage once all
// have: no block barrier in the loop), and each tile's per-row vectors
// (cov or cover, mask, cap) travel with it as 2-D TMA loads.  Two ring
// modes (ring.cuh), picked on the host by d (kernels/ring.py `plan`):
//   * resident (d within 2 boxes of 128 bytes): the band is loaded once a
//     unit into 128-byte-swizzled boxes and stays; a 3-stage ring carries
//     each eval tile's boxes and vectors;
//   * streamed (wider d): each stage of a 4-stage ring carries one box of d
//     of the band and of the eval tile, the vectors with the tile's last
//     box; the accumulators carry across the tile's boxes and the epilogue
//     runs after its last (the band is read again from L2 for every tile).
// The FFMA loop is ring.cuh box_fma, a 16 x 8 register micro-tile:
// acc[i][j] is (candidate row i, eval row tx + 16 j).  The epilogue stays
// in registers: colsum[i] += mask_j * max(s_ij - cov_j, 0) (or the coverage
// form, min(cover, cap) formed once a row) over the thread's 8 eval rows in
// order, the rbf similarity by sm90.cuh sim_rn from the staged norms (|e|^2
// from box_fma, the band's |c|^2 once a unit, box by box).  At the end of a
// unit the 16 lanes that share a candidate row sum it by a fixed
// __shfl_xor tree; then the band's masked top-1 (one chunk and TOP1) or the
// partial sums to the chunk scratch.  Rows past ne and nc arrive as TMA's
// zero fill (mask 0, so they add nothing).  TMA needs 16-byte row pitches,
// bases and batch strides: the wrappers (kernels/facility_gain.py) hand
// other operands over as a padded copy (features: d rounded up to 16
// bytes; batched vectors: rows rounded up to 4 floats).
// A launch or build error is returned, never replaced by another path.
// Each similarity is one fmaf chain over k ascending from 0.0f (the first
// port's 128 x 128 tile kernel's too); the gain sums run in a fixed order
// (a thread's eval rows in tile order, then the lane tree, then chunk
// order), so two calls give the same bits.
#include "ring.cuh"
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {

// ---------------------------------------------------------------------------
// stage 2: the chunk sums and the select over them
// ---------------------------------------------------------------------------

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
  int64_t n_part, ne, nc, d, ev_ld, cd_ld, ev_bs, cd_bs, cov_bs, cap_bs,
      mask_bs, ok_bs, chunks;
  float hh;
  int64_t streamed;  // the ring mode (kernels/ring.py plan)
};

namespace fl {

using namespace ring;  // barriers, TMA, the swizzled box, box_fma, Walk

constexpr int NTH = 256;          // threads a block
constexpr int TM = 128;           // eval rows a tile (the streamed operand)
constexpr int TR = 16 * MI;       // candidate rows a band
constexpr int BOX = TM * 128;     // bytes of an eval box, 128 bytes of d
constexpr int XBOX = TR * 128;    // bytes of a candidate-band box
constexpr int VEC = TM * 4;       // bytes of one per-row vector of a tile
constexpr int RES_STAGES = 3;     // eval tiles in flight, resident mode
constexpr int STR_STAGES = 4;     // (band box, eval box) stages, streamed

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

// Dynamic shared memory with nv per-row vectors: 1024 bytes of alignment
// slack, the ring (resident: the band's nb boxes and RES_STAGES stages of
// the eval tile's nb boxes; streamed: STR_STAGES stages of one band box and
// one eval box), the stages' vectors, the band's norms, the top-1 scratch
// and the barriers (full and empty a stage, and the band's pair).
// kernels/ring.py facility_smem is the same formula.
__host__ __device__ constexpr int smem_bytes(int nb, int nv, bool streamed) {
  return 1024 +
         (streamed ? STR_STAGES * (XBOX + BOX)
                   : nb * (XBOX + RES_STAGES * BOX)) +
         (streamed ? STR_STAGES : RES_STAGES) * nv * VEC + TR * 4 + 16 * 8 +
         8 * (2 + 2 * (streamed ? STR_STAGES : RES_STAGES));
}
static_assert(smem_bytes(MAX_RES_BOXES, 3, false) <= SMEM_MAX,
              "the resident mode's widest band does not fit");
static_assert(smem_bytes(1, 3, true) <= SMEM_MAX,
              "the streamed ring does not fit");

template <typename T, bool RBF, bool TOP1, bool COV, bool STREAM>
__global__ void __launch_bounds__(NTH, 1)
    facility_kernel(const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap emap,
                    const __grid_constant__ CUtensorMap covmap,
                    const __grid_constant__ CUtensorMap maskmap,
                    const __grid_constant__ CUtensorMap capmap,
                    const Args a) {
  constexpr int NV = COV ? 3 : 2;  // per-row vectors: cov, mask (, cap)
  constexpr int BC = 128 / sizeof(T);
  constexpr int ST = STREAM ? STR_STAGES : RES_STAGES;
  extern __shared__ __align__(16) char smem_raw[];
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  char* xs = sm;                // resident: the candidate band (nb boxes);
                                // streamed: ST stages of (band, eval) box
  char* ys = xs + a.nb * XBOX;  // resident: eval tiles, ST x nb boxes
  float* vs = reinterpret_cast<float*>(STREAM ? xs + ST * (XBOX + BOX)
                                              : ys + ST * a.nb * BOX);
  float* bn = vs + ST * NV * TM;  // the band's |c|^2 (rbf)
  float* tv = bn + TR;            // top-1 scratch: 2 x 8 (value, index)
  int* ti = reinterpret_cast<int*>(tv + 16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ti + 16);
  const uint32_t xfull = smem_u32(bars), xempty = smem_u32(bars + 1);
  auto efull = [&](int s) { return smem_u32(bars + 2 + s); };
  auto eempty = [&](int s) { return smem_u32(bars + 2 + ST + s); };

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
  auto load_vecs = [&](const Walk& t, int s, uint32_t bar) {
    const int row0 = static_cast<int>(t.ct * TM);
    const int p = static_cast<int>(t.b);
    float* v = vs + s * NV * TM;
    tma_load2(smem_u32(v), &covmap, row0, a.cov_b ? p : 0, bar);
    tma_load2(smem_u32(v + TM), &maskmap, row0, a.mask_b ? p : 0, bar);
    if (COV) tma_load2(smem_u32(v + 2 * TM), &capmap, row0, a.cap_b ? p : 0,
                       bar);
  };
  auto load_tile = [&](const Walk& t, int s) {
    const uint32_t bar = efull(s);
    mbar_expect_tx(bar, ebytes);
    for (int kb = 0; kb < a.nb; ++kb)
      tma_load3(smem_u32(ys + (s * a.nb + kb) * BOX), &emap, kb * BC,
                static_cast<int>(t.ct * TM), a.ev_b ? static_cast<int>(t.b) : 0,
                bar);
    load_vecs(t, s, bar);
  };
  // streamed: box kb of tile t's band and eval tile into stage s, the
  // tile's vectors with its last box
  auto load_box = [&](const Walk& t, int kb, int s) {
    const uint32_t bar = efull(s);
    const bool last = kb == a.nb - 1;
    char* st = xs + s * (XBOX + BOX);
    mbar_expect_tx(bar, XBOX + BOX + (last ? NV * VEC : 0));
    tma_load3(smem_u32(st), &cmap, kb * BC, static_cast<int>(t.rb * TR),
              a.cd_b ? static_cast<int>(t.b) : 0, bar);
    tma_load3(smem_u32(st + XBOX), &emap, kb * BC, static_cast<int>(t.ct * TM),
              a.ev_b ? static_cast<int>(t.b) : 0, bar);
    if (last) load_vecs(t, s, bar);
  };

  Walk cur;
  cur.start(blockIdx.x, a);
  Walk fill = cur;  // thread 0: the next tile (streamed: and box fkb of it)
  int fkb = 0;      // to load into the ring
  // streamed: the stage's refill, once every warp has arrived on its empty
  // barrier
  auto refill = [&](const Slot& q) {
    mbar_wait(eempty(q.s), q.ph);
    if (fill.valid) {
      load_box(fill, fkb, q.s);
      if (++fkb == a.nb) {
        fkb = 0;
        fill.next(a);
      }
    }
  };
  if (tid == 0) {
    mbar_init(xfull, 1);
    mbar_init(xempty, NTH / 32);  // one arrival a warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(efull(s), 1);
      mbar_init(eempty(s), NTH / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (STREAM) {
      for (int s = 0; s < ST && fill.valid; ++s) {
        load_box(fill, fkb, s);
        if (++fkb == a.nb) {
          fkb = 0;
          fill.next(a);
        }
      }
    } else if (cur.valid) {
      load_band(cur);
      for (int s = 0; s < ST && fill.valid; ++s) {
        load_tile(fill, s);
        fill.next(a);
      }
    }
  }
  __syncthreads();

  float colsum[MI];  // candidate row i's sum over this thread's eval rows
  int64_t n = 0;     // tiles done by this block
  uint32_t xi = 0;   // bands loaded before this tile's (resident)
  uint32_t nu = 0;   // units finished (the top-1 scratch alternates)
  Slot q{0, 0};      // the ring position (streamed)
  for (; cur.valid; ++n) {
    const int s = STREAM ? q.s : static_cast<int>(n % ST);
    const uint32_t ph = static_cast<uint32_t>((n / ST) & 1);
    if (cur.fresh) {
#pragma unroll
      for (int i = 0; i < MI; ++i) colsum[i] = 0.0f;
      if (!STREAM) {
        if (n > 0) ++xi;
        mbar_wait(xfull, xi & 1);
        if (RBF) {  // |c|^2 of the warp's 32 band rows (lane l: 32 w + l)
          float c2 = 0.0f;
          for (int kb = 0; kb < a.nb; ++kb) {
            const int nk = static_cast<int>(min64(BC, a.d - int64_t{kb} * BC));
            c2 = row_norm<T>(xs + kb * XBOX, 32 * w + lane, nk, c2);
          }
          bn[32 * w + lane] = c2;
          __syncwarp();
        }
      }
    }
    float acc[MI][8], y2[8];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) y2[j] = 0.0f;
    const float* vc;  // this tile's vectors, in its (last) stage
    if constexpr (STREAM) {
      float c2 = 0.0f;  // rbf, a unit's first tile: |c|^2 of band row
                        // 32 w + lane, box by box
      for (int kb = 0; kb < a.nb; ++kb) {
        mbar_wait(efull(q.s), q.ph);
        const char* xb = xs + q.s * (XBOX + BOX);
        if (RBF && cur.fresh)
          c2 = row_norm<T>(xb, 32 * w + lane,
                           static_cast<int>(min64(BC, a.d - int64_t{kb} * BC)),
                           c2);
        box_fma<T, RBF>(xb + (32 * w + 4 * h) * 128, xb + XBOX,
                        groups_of(a.d, kb, BC), h, tx, acc, y2);
        if (kb + 1 == a.nb) break;  // the last stage stays for the epilogue
        __syncwarp();
        if (lane == 0) mbar_arrive(eempty(q.s));
        if (tid == 0) refill(q);
        q.next(ST);
      }
      if (RBF && cur.fresh) {
        bn[32 * w + lane] = c2;
        __syncwarp();
      }
      vc = vs + q.s * NV * TM;
    } else {
      mbar_wait(efull(s), ph);
      for (int kb = 0; kb < a.nb; ++kb)
        box_fma<T, RBF>(xs + kb * XBOX + (32 * w + 4 * h) * 128,
                        ys + (s * a.nb + kb) * BOX, groups_of(a.d, kb, BC), h,
                        tx, acc, y2);
      vc = vs + s * NV * TM;
    }

    // epilogue in registers: the thread's 8 eval rows in order, each row's
    // vectors read once from the stage
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
    if constexpr (STREAM) {
      if (lane == 0) mbar_arrive(eempty(q.s));
      if (tid == 0) refill(q);
      q.next(ST);
    } else {
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
// host side: the maps and the launch
// ---------------------------------------------------------------------------

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

template <typename T, bool RBF, bool TOP1, bool COV, bool STREAM>
int launch(const Maps& m, const Args& a, int grid, cudaStream_t stream) {
  const int smem = smem_bytes(a.nb, COV ? 3 : 2, STREAM);
  auto kern = facility_kernel<T, RBF, TOP1, COV, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NTH, smem, stream>>>(m.c, m.e, m.cov, m.mask, m.cap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RBF, bool TOP1, bool COV>
int launch_mode(const Maps& m, const Args& a, int grid, bool streamed,
                cudaStream_t stream) {
  return streamed ? launch<T, RBF, TOP1, COV, true>(m, a, grid, stream)
                  : launch<T, RBF, TOP1, COV, false>(m, a, grid, stream);
}

// Stage 1: units of (partition, band, chunk), one block an SM (fewer when
// there are fewer units).
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
  if (!c.streamed && a.nb > MAX_RES_BOXES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(min64(a.units, sm_count()));

  Maps m{};
  const CUtensorMapDataType type = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = make_map(&m.c, type, esz, c.cd, c.d, c.nc, a.cd_b ? c.n_part : 1,
                     c.cd_ld, a.cd_b ? c.cd_bs : c.nc * c.cd_ld, bc, TR);
  if (err == 0)
    err = make_map(&m.e, type, esz, c.ev, c.d, c.ne, a.ev_b ? c.n_part : 1,
                   c.ev_ld, a.ev_b ? c.ev_bs : c.ne * c.ev_ld, bc, TM);
  if (err == 0)
    err = make_vec_map(&m.cov, c.cov, c.ne, c.n_part, c.cov_bs, &a.cov_b);
  if (err == 0)
    err = make_vec_map(&m.mask, c.mask, c.ne, c.n_part, c.mask_bs, &a.mask_b);
  if (err == 0 && COV)
    err = make_vec_map(&m.cap, c.cap, c.ne, c.n_part, c.cap_bs, &a.cap_b);
  if (err != 0) return err;
  if (!COV) m.cap = m.mask;  // unused
  const bool st = c.streamed != 0;
  if (bf16)
    return rbf ? launch_mode<__nv_bfloat16, true, TOP1, COV>(m, a, grid, st,
                                                             stream)
               : launch_mode<__nv_bfloat16, false, TOP1, COV>(m, a, grid, st,
                                                              stream);
  return rbf ? launch_mode<float, true, TOP1, COV>(m, a, grid, st, stream)
             : launch_mode<float, false, TOP1, COV>(m, a, grid, st, stream);
}

}  // namespace fl

// A plan the kernels take: at least one chunk, every chunk non-empty (the
// stage-2 sums read every chunk's partials), the grid and TMA's int32
// coordinates within their limits, row pitches covering d.
bool plan_ok(const Args& a) {
  const int64_t tiles = cdiv(a.ne, fl::TM);
  return a.n_part >= 1 && a.ne >= 1 && a.nc >= 1 && a.d >= 1 &&
         a.n_part <= 65535 && a.chunks >= 1 && a.chunks <= 65535 &&
         (a.chunks - 1) * cdiv(tiles, a.chunks) < tiles &&
         a.ne < (int64_t{1} << 30) && a.nc < (int64_t{1} << 30) &&
         a.ev_ld >= a.d && a.cd_ld >= a.d;
}

// Both objectives' gains: stage 1, then the chunk sums in chunk order.
template <bool COV>
int gains_launch(const Args& a, int64_t bf16, int64_t rbf, float* part,
                 float* gains, cudaStream_t s) {
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = fl::run<false, COV>(a, bf16, rbf, part, nullptr, nullptr,
                                      s);
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
    const int err = fl::run<true, COV>(a, bf16, rbf, nullptr, tile_best,
                                       tile_idx, s);
    if (err != 0) return err;
    fold_tiles<<<grid2, NT, 0, s>>>(tile_best, tile_idx, best, idx,
                                    cdiv(a.nc, fl::TR));
  } else {
    const int err = fl::run<false, COV>(a, bf16, rbf, part, nullptr, nullptr,
                                        s);
    if (err != 0) return err;
    facility_select_chunks<<<grid2, NT, 0, s>>>(part, a.ok, best, idx,
                                                a.n_part, a.nc, a.chunks,
                                                a.ok_bs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// Shapes, in elements: ev (P, ne, d) with rows ev_ld apart and batch stride
// ev_bs (0 = shared), cd (P, nc, d) / cd_ld / cd_bs, cov (or cover), cap and
// mask (P, ne) f32 / cov_bs, cap_bs, mask_bs, ok (P, nc) f32 / ok_bs.  The
// features' bases, pitches and batch strides in bytes, and the vectors'
// bases and (batched) strides in bytes, are multiples of 16 (TMA's rule;
// the wrappers copy other operands).  streamed != 0 selects the streamed
// ring (resident takes d within 2 boxes of 128 bytes; kernels/ring.py
// plan).  The caller allocates every output and scratch from the plan
// (kernels/facility_gain.py plan): `part` holds chunks * P * nc floats,
// every chunk covering at least one of the ceil(ne / 128) eval tiles
// (chunk c: tiles [c t, (c + 1) t) with t = ceil(tiles / chunks)); with
// chunks == 1 the select's scratch is tile_best / tile_idx, P * ceil(nc /
// 256) entries each, and `part` is unused.  Every entry returns the first
// launch error, a tensor-map error (driver errors offset by 10000), or 0;
// a plan it does not take is cudaErrorInvalidValue.

// The dynamic shared memory a launch with nb boxes of d and nv per-row
// vectors (2: facility, 3: coverage) takes in either mode (host only; the
// tests hold kernels/ring.py's formula to it).
extern "C" int sm90_facility_smem(int64_t nb, int64_t nv, int64_t streamed) {
  return sm90::fl::smem_bytes(static_cast<int>(nb), static_cast<int>(nv),
                              streamed != 0);
}

// Facility gains (P, nc) f32.
extern "C" int sm90_facility_gain(const void* ev, const void* cd,
                                  const void* cov, const void* mask,
                                  void* part, void* gains, int64_t n_part,
                                  int64_t ne, int64_t nc, int64_t d,
                                  int64_t ev_ld, int64_t cd_ld, int64_t ev_bs,
                                  int64_t cd_bs, int64_t cov_bs,
                                  int64_t mask_bs, int64_t chunks,
                                  int64_t bf16, int64_t rbf, float hh,
                                  int64_t streamed, void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cov), nullptr,
               static_cast<const float*>(mask), nullptr, n_part, ne, nc, d,
               ev_ld, cd_ld, ev_bs, cd_bs, cov_bs, 0, mask_bs, 0, chunks, hh,
               streamed};
  return gains_launch<false>(a, bf16, rbf, static_cast<float*>(part),
                             static_cast<float*>(gains),
                             static_cast<cudaStream_t>(stream));
}

// Facility select: best (P,) f32 and idx (P,) int32.
extern "C" int sm90_facility_select(
    const void* ev, const void* cd, const void* cov, const void* mask,
    const void* ok, void* part, void* tile_best, void* tile_idx, void* best,
    void* idx, int64_t n_part, int64_t ne, int64_t nc, int64_t d,
    int64_t ev_ld, int64_t cd_ld, int64_t ev_bs, int64_t cd_bs,
    int64_t cov_bs, int64_t mask_bs, int64_t ok_bs, int64_t chunks,
    int64_t bf16, int64_t rbf, float hh, int64_t streamed, void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cov), nullptr,
               static_cast<const float*>(mask), static_cast<const float*>(ok),
               n_part, ne, nc, d, ev_ld, cd_ld, ev_bs, cd_bs, cov_bs, 0,
               mask_bs, ok_bs, chunks, hh, streamed};
  return select_launch<false>(
      a, bf16, rbf, static_cast<float*>(part), static_cast<float*>(tile_best),
      static_cast<int*>(tile_idx), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}

// Saturated-coverage gains (P, nc) f32.
extern "C" int sm90_coverage_gain(
    const void* ev, const void* cd, const void* cover, const void* cap,
    const void* mask, void* part, void* gains, int64_t n_part, int64_t ne,
    int64_t nc, int64_t d, int64_t ev_ld, int64_t cd_ld, int64_t ev_bs,
    int64_t cd_bs, int64_t cover_bs, int64_t cap_bs, int64_t mask_bs,
    int64_t chunks, int64_t bf16, int64_t rbf, float hh, int64_t streamed,
    void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cover),
               static_cast<const float*>(cap),
               static_cast<const float*>(mask), nullptr, n_part, ne, nc, d,
               ev_ld, cd_ld, ev_bs, cd_bs, cover_bs, cap_bs, mask_bs, 0,
               chunks, hh, streamed};
  return gains_launch<true>(a, bf16, rbf, static_cast<float*>(part),
                            static_cast<float*>(gains),
                            static_cast<cudaStream_t>(stream));
}

// Saturated-coverage select: best (P,) f32 and idx (P,) int32.
extern "C" int sm90_coverage_select(
    const void* ev, const void* cd, const void* cover, const void* cap,
    const void* mask, const void* ok, void* part, void* tile_best,
    void* tile_idx, void* best, void* idx, int64_t n_part, int64_t ne,
    int64_t nc, int64_t d, int64_t ev_ld, int64_t cd_ld, int64_t ev_bs,
    int64_t cd_bs, int64_t cover_bs, int64_t cap_bs, int64_t mask_bs,
    int64_t ok_bs, int64_t chunks, int64_t bf16, int64_t rbf, float hh,
    int64_t streamed, void* stream) {
  using namespace sm90;
  const Args a{ev, cd, static_cast<const float*>(cover),
               static_cast<const float*>(cap),
               static_cast<const float*>(mask), static_cast<const float*>(ok),
               n_part, ne, nc, d, ev_ld, cd_ld, ev_bs, cd_bs, cover_bs, cap_bs,
               mask_bs, ok_bs, chunks, hh, streamed};
  return select_launch<true>(
      a, bf16, rbf, static_cast<float*>(part), static_cast<float*>(tile_best),
      static_cast<int*>(tile_idx), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}
