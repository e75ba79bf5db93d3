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
// `linv` is float32, sel and c are float32 or bf16 (widened on staging).  The
// partition axis is GreeDi's m machines; each operand has its own batch
// stride, 0 when it is shared (round 2 of the generic engine shares the
// candidate block).
//
// Two contracts.  With `live` (the objectives' selection counts, read on
// the card) linv is inv(chol(K_SS + ridge I)) with the columns past the count
// zeroed: lower-triangular, only its live x live corner non-zero.  The kernel
// applies exactly that mask (tril, rows and columns >= live[p] zeroed), so
// with c = min(live[p], k) it needs c cross-kernel rows and, per row i < c,
// the terms l <= i: c (c + 1) / 2 FFMA a candidate instead of the dense
// k^2.  Without `live` it takes linv as it is (dense, c = k).
//
// Bound on this card: per candidate 2 c d + c (c + 1) FLOP at d = 6 against
// 24 bytes read, so the kernel is bound by FP32 FFMA work; at the GP round-1
// shape (32 x 1,431,622 candidates, k = 128, count 64) the count-aware bound
// is 3.73 ms against the dense 24.17 ms.  Registers: up to 255 a thread at
// one block of 256 an SM (no instance spills; PERF.md has the ptxas lines).
//
// Design: a persistent grid of (blocks a partition, partitions); one block
// of 256 threads walks its partition's candidate tiles by a stride.
//   * The tile shape follows c: T slots share a group of 8 candidates and
//     split its live row blocks, slot s taking blocks s and nrb - 1 - s
//     (cost nrb + 1 each, the triangle folded), T = ceil(nrb / 2) (dense:
//     nrb), within [2, 256]; floor(256 / T) groups make a tile of up to
//     1024 candidates.  So every thread has work at every count.  Past 256
//     slots (k > 2048 dense, 4096 live) the fold repeats over rounds of
//     2 T row blocks.
//   * Three modes, chosen on the host by what fits in shared memory:
//     PANELS and L2 (d <= 8, the GP path): the live sel rows and their
//     norms are staged once a block; PANELS also stages linv's live rows as
//     8-row panels (panel rb holds rows 8 rb .. 8 rb + 7 over the columns
//     l < 8 (rb + 1), transposed so a row block's 8 values of one l are 32
//     contiguous bytes), L2 reads linv through the same mask from L2.
//     Candidate tiles stream through a 2-stage ring of cp.async copies
//     (16-byte where the tile's range is aligned, else 4-byte; bf16 loads
//     and widens), the next tile's copy overlapping this tile's products,
//     and each thread holds its 8 candidates' features in registers.
//     GENERIC (wider d, or k past the staged sel rows): sel, the candidates
//     and linv are read from L2; phase 1 runs over d in chunks of 8 with X
//     as the accumulator, and X lives in shared memory while it fits, else
//     in a per-block device scratch.  Any k and d.
//   * phase 1: each slot computes the cross-kernel rows l = s, s + T, ... < c
//     of its 8 candidates (sm90.cuh: sim_of's rbf value with expf, without
//     the division's slow path; the norms from the same values as
//     info_gain.py does, one fmaf chain over d); rows past c are neither
//     computed nor read.
//   * phase 2: per row block, an 8 x 8 register tile of linv @ X over
//     l < min(8 (rb + 1), c) (dense: l < k), 16 bytes of linv and of X a
//     shared load each, then the squares of the 8 rows summed per candidate.
//   * epilogue: the T slots' sums in a fixed order (no atomics: every sum has
//     one order, results are bit-reproducible), cond, and for the select the
//     tile's top-1, folded per partition by ig_fold in the lowest-index
//     order (the deterministic second stage in place of the TPU's
//     sequential running best).
// Skipping terms whose linv factor is exactly 0 leaves every other term of a
// projection in its order; the squares' sum is grouped per slot instead of
// per 16-row group.
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {
namespace ig {

constexpr int NTH = 256;
constexpr int BN_MAX = 1024;           // candidates a tile, at most
constexpr int CAND_BYTES = 48 * 1024;  // both candidate stages, at most
constexpr int64_t SMEM_LIMIT = 232448 - 2048;  // dynamic + alignment + static

// Where the operands live (see the header).
enum Mode { PANELS = 0, L2 = 1, GENERIC = 2 };

__host__ __device__ inline int64_t round16(int64_t b) {
  return (b + 15) & ~int64_t{15};
}

// The tile geometry at nrb live row blocks: T slots a group of 8
// candidates, G groups, BN = 8 G candidates a tile.
struct Plan {
  int T, G, BN;
};

__host__ __device__ inline Plan plan_of(int64_t nrb, bool dense, int bn_cap) {
  int64_t t = dense ? nrb : (nrb + 1) / 2;
  if (t < 2) t = 2;
  if (t > NTH) t = NTH;
  int g = NTH / static_cast<int>(t);
  if (8 * g > bn_cap) g = bn_cap / 8;
  return {static_cast<int>(t), g, 8 * g};
}

// Candidates a staged tile may hold: both f32 stages within CAND_BYTES.
__host__ __device__ inline int bn_cap_of(int64_t d) {
  int64_t cap = CAND_BYTES / (2 * 4 * d);
  if (cap > BN_MAX) cap = BN_MAX;
  cap = cap / 8 * 8;
  return static_cast<int>(cap < 8 ? 8 : cap);
}

// Bytes of the candidate stages (staged modes) and the cross tile (rows
// padded by 4 floats; the slot sums reuse it) at nrb live row blocks.
__host__ __device__ inline int64_t tile_bytes(int64_t nrb, int64_t d,
                                              bool dense, int bn_cap,
                                              bool staged) {
  const Plan pl = plan_of(nrb, dense, bn_cap);
  const int64_t x = 8 * nrb * (pl.BN + 4) * 4,
                red = int64_t{pl.T} * pl.BN * 4;
  return (staged ? 2 * round16(int64_t{pl.BN} * d * 4) : 0) +
         round16(x > red ? x : red);
}

// Byte offsets of the shared-memory regions, the same on host and device.
struct Layout {
  int64_t kvv, seln2, sel, panels, tile, total;
};

// Float offset of linv's panel rb (of nrb): 8 rows by 8 (rb + 1) columns
// (dense: 8 nrb), then 36 floats of skew, so the panels the slots of a warp
// read at one l start in distinct 16-byte bank groups.
__host__ __device__ inline int64_t panel_base(int64_t rb, int64_t nrb,
                                              bool dense) {
  return (dense ? 64 * nrb * rb : 32 * rb * (rb + 1)) + 36 * rb;
}

__host__ __device__ inline int64_t panel_floats(int64_t nrbk, bool dense) {
  return panel_base(nrbk, nrbk, dense);
}

// The sel rows take 8 floats each in the staged modes (d <= 8), none in
// GENERIC; tile_max is the tile region (0 when X is in device scratch).
__host__ __device__ inline Layout layout_of(int64_t k, bool dense, int mode,
                                            int bn_cap, int64_t tile_max) {
  Layout s;
  s.kvv = 0;
  s.seln2 = round16(int64_t{bn_cap} * 4);
  s.sel = s.seln2 + round16(k * 4);
  s.panels = s.sel + (mode == GENERIC ? 0 : k * 8 * 4);
  s.tile = s.panels + (mode == PANELS ? panel_floats(cdiv(k, 8), dense) * 4
                                      : 0);
  s.total = s.tile + tile_max;
  return s;
}

// The largest tile_bytes over the counts a launch may see.
__host__ inline int64_t tile_max_of(int64_t k, int64_t d, bool dense,
                                    int bn_cap, bool staged) {
  const int64_t nrbk = cdiv(k, 8);
  int64_t m = 0;
  for (int64_t nrb = dense ? nrbk : 0; nrb <= nrbk; ++nrb) {
    const int64_t b = tile_bytes(nrb, d, dense, bn_cap, staged);
    if (b > m) m = b;
  }
  return m;
}

// The most tiles a partition may have (the smallest tile over the counts).
__host__ inline int64_t tiles_max_of(int64_t k, int64_t nc, bool dense,
                                     int bn_cap) {
  const int64_t nrbk = cdiv(k, 8);
  int bn = BN_MAX;
  for (int64_t nrb = dense ? nrbk : 0; nrb <= nrbk; ++nrb) {
    const int b = plan_of(nrb, dense, bn_cap).BN;
    if (b < bn) bn = b;
  }
  return cdiv(nc, bn);
}

// How a launch at (k, d) runs: its mode, tile cap, shared memory, and the
// per-block device scratch for X (floats; 0 when X is in shared memory).
struct Fit {
  int mode, bn_cap;
  int64_t tile_max, smem, x_floats;
};

__host__ inline bool fit_of(int64_t k, int64_t d, bool dense, Fit* f) {
  f->x_floats = 0;
  if (d <= 8) {
    f->bn_cap = bn_cap_of(d);
    f->tile_max = tile_max_of(k, d, dense, f->bn_cap, true);
    for (int mode = PANELS; mode <= L2; ++mode) {
      f->mode = mode;
      f->smem = layout_of(k, dense, mode, f->bn_cap, f->tile_max).total;
      if (f->smem <= SMEM_LIMIT) return true;
    }
  }
  f->mode = GENERIC;
  f->bn_cap = BN_MAX;
  f->tile_max = tile_max_of(k, d, dense, BN_MAX, false);
  f->smem = layout_of(k, dense, GENERIC, BN_MAX, f->tile_max).total;
  if (f->smem <= SMEM_LIMIT) return true;
  f->x_floats = f->tile_max / 4;
  f->tile_max = 0;
  f->smem = layout_of(k, dense, GENERIC, BN_MAX, 0).total;
  return f->smem <= SMEM_LIMIT;
}

// Blocks a partition: the SMs shared by the partitions, at most its tiles.
__host__ inline int64_t grid_x(int64_t n_part, int64_t tiles_max) {
  int64_t gx = sm_count() / n_part;
  if (gx > tiles_max) gx = tiles_max;
  return gx < 1 ? 1 : gx;
}

// The live extent of partition p: min(live[p], k), or k without live.
__device__ __forceinline__ int64_t live_of(const int64_t* live,
                                           int64_t live_bs, int64_t p,
                                           int64_t k) {
  if (live == nullptr) return k;
  int64_t c = live[p * live_bs];
  return c < 0 ? 0 : (c > k ? k : c);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage candidates [col0, col0 + cols) of one partition as float32 rows of
// d: float32 by cp.async (asynchronous; the caller commits), bf16 widened by
// plain loads.
template <typename T>
__device__ __forceinline__ void stage_cands(const T* __restrict__ cd,
                                            int64_t col0, int64_t cols,
                                            int64_t d, float* __restrict__ st) {
  const T* src = cd + col0 * d;
  const int64_t n = cols * d;
  if constexpr (sizeof(T) == 4) {
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     (n & 3) == 0;
    if (vec) {
      for (int64_t q = threadIdx.x; q < n / 4; q += NTH)
        cp_async16(st + 4 * q, src + 4 * q);
    } else {
      for (int64_t q = threadIdx.x; q < n; q += NTH) cp_async4(st + q, src + q);
    }
  } else {
    for (int64_t q = threadIdx.x; q < n; q += NTH) st[q] = to_f32(src[q]);
  }
}

// Local column of entry jj (0..7) of group cg: two quads, cg * 4 and
// BN / 2 + cg * 4, so a warp's 16-byte reads of one X row are contiguous.
__device__ __forceinline__ int col_of(int cg, int jj, int bn) {
  return (jj < 4 ? 0 : bn / 2) + cg * 4 + (jj & 3);
}

__device__ __forceinline__ void store8(float* xr, int cg, int bn,
                                       const float (&v)[8]) {
  *reinterpret_cast<float4*>(xr + col_of(cg, 0, bn)) =
      make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(xr + col_of(cg, 4, bn)) =
      make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, bool RBF, bool TOP1, int MODE>
__global__ void __launch_bounds__(NTH, 1)
    info_gain_kernel(const T* __restrict__ sel,
                     const float* __restrict__ linv, const T* __restrict__ cd,
                     const float* __restrict__ ok,
                     const int64_t* __restrict__ live,
                     float* __restrict__ scratch,
                     float* __restrict__ cond, float* __restrict__ tile_best,
                     int* __restrict__ tile_idx, int64_t k, int64_t nc,
                     int64_t d, int64_t sel_bs, int64_t linv_bs,
                     int64_t cd_bs, int64_t ok_bs, int64_t live_bs,
                     int64_t tiles_max, int bn_cap, int64_t tile_max,
                     int64_t x_floats, float hh, float ridge) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float wv[NTH / 32];
  __shared__ int wi[NTH / 32];
  constexpr bool STAGED = MODE != GENERIC;

  const bool dense = live == nullptr;
  const float rhh = __frcp_rn(hh);
  const Layout ly = layout_of(k, dense, MODE, bn_cap, tile_max);
  float* kvvs = reinterpret_cast<float*>(smem + ly.kvv);
  float* seln2 = reinterpret_cast<float*>(smem + ly.seln2);
  float* sels = reinterpret_cast<float*>(smem + ly.sel);
  float* panels = reinterpret_cast<float*>(smem + ly.panels);

  const int64_t p = blockIdx.y;
  sel += p * sel_bs;
  linv += p * linv_bs;
  cd += p * cd_bs;
  const int64_t c = live_of(live, live_bs, p, k);  // live rows
  const int64_t nrb = dense ? cdiv(k, 8) : cdiv(c, 8);
  const Plan pl = plan_of(nrb, dense, bn_cap);
  const int64_t n_tiles = cdiv(nc, pl.BN);
  if (static_cast<int64_t>(blockIdx.x) >= n_tiles) return;  // whole block

  const int64_t stage_b = STAGED ? round16(int64_t{pl.BN} * d * 4) : 0;
  float* stage0 = reinterpret_cast<float*>(smem + ly.tile);
  // X in shared memory, or GENERIC's device scratch; the staged modes keep
  // it known to be shared, so their loads of it stay shared-memory loads
  float* X = reinterpret_cast<float*>(smem + ly.tile + 2 * stage_b);
  if (!STAGED && x_floats > 0)
    X = scratch + (p * gridDim.x + blockIdx.x) * x_floats;
  const int xp = pl.BN + 4;  // X's row pitch: the slots' rows in distinct
                             // bank groups when phase 1 writes them
  float* red = X;  // the slot sums reuse the cross tile

  // ---- once a block: the live sel rows, their norms, linv's panels -------
  if (STAGED) {
    for (int64_t q = threadIdx.x; q < c * 8; q += NTH) {
      const int64_t l = q / 8, kk = q % 8;
      sels[q] = kk < d ? to_f32(sel[l * d + kk]) : 0.0f;
    }
  }
  if (MODE == PANELS) {
    for (int64_t rb = 0; rb < nrb; ++rb) {
      const int64_t len = dense ? 8 * nrb : 8 * (rb + 1);
      float* pan = panels + panel_base(rb, nrb, dense);
      for (int64_t q = threadIdx.x; q < 8 * len; q += NTH) {
        const int64_t r = q / len, l = q % len, i = 8 * rb + r;
        float v = 0.0f;
        if (i < c && l < c && (dense || l <= i)) v = linv[i * k + l];
        pan[l * 8 + r] = v;
      }
    }
  }
  __syncthreads();
  for (int64_t l = threadIdx.x; l < c; l += NTH) {
    float s = 0.0f;
    for (int64_t kk = 0; kk < d; ++kk) {
      const float v = STAGED ? sels[l * 8 + kk] : to_f32(sel[l * d + kk]);
      s = fmaf(v, v, s);
    }
    seln2[l] = s;
  }

  const int tid = threadIdx.x;
  const int cg = tid / pl.T, slot = tid % pl.T;
  const bool active = cg < pl.G;

  if (STAGED && sizeof(T) == 4) {
    stage_cands(cd, int64_t{blockIdx.x} * pl.BN,
                min64(pl.BN, nc - int64_t{blockIdx.x} * pl.BN), d, stage0);
    cp_async_commit();
  }

  int64_t n = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++n) {
    const int64_t col0 = tile * pl.BN;
    float* st = stage0 + (n & 1) * (stage_b / 4);
    if (STAGED && sizeof(T) == 4) {
      const int64_t nxt = tile + gridDim.x;  // its copy overlaps this tile
      if (nxt < n_tiles)
        stage_cands(cd, nxt * pl.BN, min64(pl.BN, nc - nxt * pl.BN), d,
                    stage0 + ((n + 1) & 1) * (stage_b / 4));
      cp_async_commit();
      cp_async_wait1();
    } else if (STAGED) {
      stage_cands(cd, col0, min64(pl.BN, nc - col0), d, st);
    }
    __syncthreads();  // this tile's candidates (and, first, seln2) visible

    // ---- phase 1: X[l, j] = k(sel_l, c_j) for the live rows l < c --------
    if (active) {
      float y2[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) y2[jj] = 0.0f;
      if (STAGED) {  // d <= 8: the 8 candidates' features in registers
        float cv[8][8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* row = st + col_of(cg, jj, pl.BN) * d;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            cv[jj][kk] = kk < d ? row[kk] : 0.0f;
            if (kk < d) y2[jj] = fmaf(cv[jj][kk], cv[jj][kk], y2[jj]);
          }
        }
        for (int64_t l = slot; l < c; l += pl.T) {
          float v[8];
          const float4 s0 = *reinterpret_cast<const float4*>(sels + l * 8);
          const float4 s1 = *reinterpret_cast<const float4*>(sels + l * 8 + 4);
          const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float x2 = seln2[l];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            float acc = 0.0f;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              if (kk < d) acc = fmaf(s[kk], cv[jj][kk], acc);
            v[jj] = RBF ? sim_rn(acc, x2, y2[jj], hh, rhh) : acc;
          }
          store8(X + l * xp, cg, pl.BN, v);
        }
      } else {  // GENERIC: d in chunks of 8, X holding the partial sums
        const T* crow[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int64_t gc = col0 + col_of(cg, jj, pl.BN);
          crow[jj] = gc < nc ? cd + gc * d : nullptr;
        }
        for (int64_t k0 = 0; k0 < d; k0 += 8) {
          const bool last = k0 + 8 >= d;
          float cv[8][8];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              cv[jj][kk] = crow[jj] != nullptr && k0 + kk < d
                               ? to_f32(crow[jj][k0 + kk])
                               : 0.0f;
              if (k0 + kk < d) y2[jj] = fmaf(cv[jj][kk], cv[jj][kk], y2[jj]);
            }
          }
          for (int64_t l = slot; l < c; l += pl.T) {
            float s[8];
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              s[kk] = k0 + kk < d ? to_f32(sel[l * d + k0 + kk]) : 0.0f;
            float* xr = X + l * xp;
            float v[8];
            if (k0 == 0) {
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) v[jj] = 0.0f;
            } else {
              const float4 a0 =
                  *reinterpret_cast<const float4*>(xr + col_of(cg, 0, pl.BN));
              const float4 a1 =
                  *reinterpret_cast<const float4*>(xr + col_of(cg, 4, pl.BN));
              v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
              v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int kk = 0; kk < 8; ++kk)
                if (k0 + kk < d) v[jj] = fmaf(s[kk], cv[jj][kk], v[jj]);
            }
            if (RBF && last) {
              const float x2 = seln2[l];
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
                v[jj] = sim_rn(v[jj], x2, y2[jj], hh, rhh);
            }
            store8(xr, cg, pl.BN, v);
          }
        }
      }
      if (slot == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          kvvs[col_of(cg, jj, pl.BN)] = RBF ? 1.0f : y2[jj];
      }
    }
    __syncthreads();  // X and kvvs complete

    // ---- phase 2: column sums of (linv @ X)^2 over this slot's blocks ----
    // Rounds of 2 T row blocks; in each the slot takes blocks s and
    // m - 1 - s of the round's m (the second only past the first T).
    float sq[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) sq[jj] = 0.0f;
    if (active) {
      for (int64_t base = 0; base < nrb; base += 2 * pl.T) {
        const int64_t m = min64(2 * pl.T, nrb - base);
        for (int h = 0; h < 2; ++h) {
          const int64_t r = h == 0 ? slot : m - 1 - slot;
          if (h == 0 ? r >= m : r < pl.T) continue;
          const int64_t rb = base + r;
          const int64_t lmax = dense ? k : min64(8 * (rb + 1), c);
          float acc[8][8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;
          }
          const float* pan = panels + panel_base(rb, nrb, dense);
          const float* xq0 = X + col_of(cg, 0, pl.BN);
          const float* xq1 = X + col_of(cg, 4, pl.BN);
#pragma unroll 4
          for (int64_t l = 0; l < lmax; ++l) {
            float a[8];
            if (MODE == PANELS) {
              const float4 a0 = *reinterpret_cast<const float4*>(pan + l * 8);
              const float4 a1 =
                  *reinterpret_cast<const float4*>(pan + l * 8 + 4);
              a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
              a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
            } else {
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const int64_t i = 8 * rb + q;
                a[q] = (i < c && l < c && (dense || l <= i))
                           ? __ldg(linv + i * k + l)
                           : 0.0f;
              }
            }
            const float4 b0 = *reinterpret_cast<const float4*>(xq0 + l * xp);
            const float4 b1 = *reinterpret_cast<const float4*>(xq1 + l * xp);
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
                acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              sq[jj] = fmaf(acc[i][jj], acc[i][jj], sq[jj]);
          }
        }
      }
    }
    __syncthreads();  // every read of X is done: the slot sums reuse it
    if (active) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        red[slot * pl.BN + col_of(cg, jj, pl.BN)] = sq[jj];
    }
    __syncthreads();

    // ---- epilogue: the slots' sums in a fixed order, cond, the top-1 -----
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int j = tid; j < pl.BN; j += NTH) {
      const int64_t gc = col0 + j;
      if (gc >= nc) break;
      float s = 0.0f;
      for (int q = 0; q < pl.T; ++q) s += red[q * pl.BN + j];
      const float cvv = fmaxf(kvvs[j] + ridge - s, 1e-12f);
      if (TOP1) {
        take_better(bv, bi, ok[p * ok_bs + gc] > 0.0f ? cvv : 0.0f,
                    static_cast<int>(gc));
      } else {
        cond[p * nc + gc] = cvv;
      }
    }
    if (TOP1) {
      block_top1(bv, bi, wv, wi);
      if (tid == 0) {
        tile_best[p * tiles_max + tile] = bv;
        tile_idx[p * tiles_max + tile] = bi;
      }
    }
  }
}

// Stage 2 of the select: the top-1 of each partition's per-tile pairs, in
// the lowest-index order, one block a partition (its tile count follows its
// live count as the kernel's does).
__global__ void __launch_bounds__(NTH)
    ig_fold(const float* __restrict__ tile_best,
            const int* __restrict__ tile_idx, float* __restrict__ best,
            int* __restrict__ idx, const int64_t* __restrict__ live,
            int64_t live_bs, int64_t k, int64_t nc, int bn_cap,
            int64_t tiles_max) {
  __shared__ float wv[NTH / 32];
  __shared__ int wi[NTH / 32];
  const int64_t p = blockIdx.y;
  const bool dense = live == nullptr;
  const int64_t c = live_of(live, live_bs, p, k);
  const Plan pl = plan_of(dense ? cdiv(k, 8) : cdiv(c, 8), dense, bn_cap);
  const int64_t n_tiles = cdiv(nc, pl.BN);
  float v = -CUDART_INF_F;
  int vi = 0x7fffffff;
  for (int64_t t = threadIdx.x; t < n_tiles; t += NTH)
    take_better(v, vi, tile_best[p * tiles_max + t],
                tile_idx[p * tiles_max + t]);
  block_top1(v, vi, wv, wi);
  if (threadIdx.x == 0) {
    best[p] = v;
    idx[p] = vi;
  }
}

struct IGArgs {
  const void* sel;
  const float* linv;
  const void* cd;
  const float* ok;
  const int64_t* live;
  float* scratch;
  int64_t n_part, k, nc, d, sel_bs, linv_bs, cd_bs, ok_bs, live_bs;
  float hh, ridge;
};

template <typename T, bool RBF, bool TOP1, int MODE>
cudaError_t launch(const IGArgs& a, const Fit& f, int64_t tiles_max,
                   float* cond, float* tile_best, int* tile_idx,
                   cudaStream_t s) {
  auto kern = info_gain_kernel<T, RBF, TOP1, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(f.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(grid_x(a.n_part, tiles_max)),
                  static_cast<unsigned>(a.n_part));
  kern<<<grid, NTH, f.smem, s>>>(
      static_cast<const T*>(a.sel), a.linv, static_cast<const T*>(a.cd), a.ok,
      a.live, a.scratch, cond, tile_best, tile_idx, a.k, a.nc, a.d, a.sel_bs,
      a.linv_bs, a.cd_bs, a.ok_bs, a.live_bs, tiles_max, f.bn_cap,
      f.tile_max, f.x_floats, a.hh, a.ridge);
  return cudaGetLastError();
}

template <typename T, bool RBF, bool TOP1>
cudaError_t launch_mode(const IGArgs& a, const Fit& f, int64_t tiles,
                        float* cond, float* tile_best, int* tile_idx,
                        cudaStream_t s) {
  if (f.mode == PANELS)
    return launch<T, RBF, TOP1, PANELS>(a, f, tiles, cond, tile_best,
                                        tile_idx, s);
  if (f.mode == L2)
    return launch<T, RBF, TOP1, L2>(a, f, tiles, cond, tile_best, tile_idx,
                                    s);
  return launch<T, RBF, TOP1, GENERIC>(a, f, tiles, cond, tile_best, tile_idx,
                                       s);
}

template <bool TOP1>
cudaError_t launch_any(const IGArgs& a, int64_t bf16, int64_t rbf,
                       float* cond, float* tile_best, int* tile_idx,
                       cudaStream_t s) {
  Fit f;
  if (a.k < 1 || a.d < 1 || a.n_part < 1 ||
      !fit_of(a.k, a.d, a.live == nullptr, &f) ||
      (f.x_floats > 0 && a.scratch == nullptr))
    return cudaErrorInvalidValue;
  const int64_t tiles = tiles_max_of(a.k, a.nc, a.live == nullptr, f.bn_cap);
  if (bf16) {
    return rbf ? launch_mode<__nv_bfloat16, true, TOP1>(a, f, tiles, cond,
                                                        tile_best, tile_idx, s)
               : launch_mode<__nv_bfloat16, false, TOP1>(
                     a, f, tiles, cond, tile_best, tile_idx, s);
  }
  return rbf ? launch_mode<float, true, TOP1>(a, f, tiles, cond, tile_best,
                                              tile_idx, s)
             : launch_mode<float, false, TOP1>(a, f, tiles, cond, tile_best,
                                               tile_idx, s);
}

}  // namespace ig
}  // namespace sm90

// Shapes, in elements: sel (P, k, d) with batch stride sel_bs (0 = shared),
// linv (P, k, k) f32 / linv_bs, cd (P, nc, d) / cd_bs, ok (P, nc) f32 /
// ok_bs, live (P,) int64 / live_bs (NULL: the dense contract).  Rows are
// contiguous.  The caller allocates every output and the scratch.

// *tiles = the per-partition stride of a select's tile_best / tile_idx;
// *smem = the dynamic shared memory of a launch; *scratch = the floats of
// device scratch it needs (0: pass NULL).  Returns 0, or
// cudaErrorInvalidValue for an empty shape or when even the GENERIC mode's
// k + 1024 floats do not fit in shared memory (k past about 56,000).
extern "C" int sm90_info_plan(int64_t n_part, int64_t k, int64_t d,
                              int64_t nc, int64_t dense, int64_t* tiles,
                              int64_t* smem, int64_t* scratch) {
  using namespace sm90::ig;
  *tiles = 0;
  *smem = 0;
  *scratch = 0;
  Fit f;
  if (n_part < 1 || k < 1 || d < 1 || nc < 1 || !fit_of(k, d, dense != 0, &f))
    return static_cast<int>(cudaErrorInvalidValue);
  *tiles = tiles_max_of(k, nc, dense != 0, f.bn_cap);
  *smem = f.smem;
  *scratch = n_part * grid_x(n_part, *tiles) * f.x_floats;
  return 0;
}

// cond (P, nc) f32.  Returns the first launch error, or 0.
extern "C" int sm90_info_gain_cond(const void* sel, const void* linv,
                                   const void* cd, const void* live,
                                   void* scratch, void* cond, int64_t n_part,
                                   int64_t k, int64_t nc, int64_t d,
                                   int64_t sel_bs, int64_t linv_bs,
                                   int64_t cd_bs, int64_t live_bs,
                                   int64_t bf16, int64_t rbf, float hh,
                                   float ridge, void* stream) {
  using namespace sm90::ig;
  const IGArgs a{sel, static_cast<const float*>(linv), cd, nullptr,
                 static_cast<const int64_t*>(live),
                 static_cast<float*>(scratch), n_part, k, nc, d, sel_bs,
                 linv_bs, cd_bs, 0, live_bs, hh, ridge};
  return static_cast<int>(launch_any<false>(
      a, bf16, rbf, static_cast<float*>(cond), nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// best (P,) f32 and idx (P,) int32, through tile_best / tile_idx of P *
// tiles entries each (sm90_info_plan).  Returns the first launch error, or
// 0.
extern "C" int sm90_info_select(const void* sel, const void* linv,
                                const void* cd, const void* ok,
                                const void* live, void* scratch,
                                void* tile_best, void* tile_idx, void* best,
                                void* idx, int64_t n_part, int64_t k,
                                int64_t nc, int64_t d, int64_t sel_bs,
                                int64_t linv_bs, int64_t cd_bs, int64_t ok_bs,
                                int64_t live_bs, int64_t bf16, int64_t rbf,
                                float hh, float ridge, void* stream) {
  using namespace sm90::ig;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const IGArgs a{sel, static_cast<const float*>(linv), cd,
                 static_cast<const float*>(ok),
                 static_cast<const int64_t*>(live),
                 static_cast<float*>(scratch), n_part, k, nc, d, sel_bs,
                 linv_bs, cd_bs, ok_bs, live_bs, hh, ridge};
  cudaError_t err = launch_any<true>(a, bf16, rbf, nullptr,
                                     static_cast<float*>(tile_best),
                                     static_cast<int*>(tile_idx), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fit f;
  fit_of(k, d, live == nullptr, &f);
  const dim3 grid2(1, static_cast<unsigned>(n_part));
  ig_fold<<<grid2, NTH, 0, s>>>(
      static_cast<const float*>(tile_best), static_cast<const int*>(tile_idx),
      static_cast<float*>(best), static_cast<int*>(idx),
      static_cast<const int64_t*>(live), live_bs, k, nc, f.bn_cap,
      tiles_max_of(k, nc, live == nullptr, f.bn_cap));
  return static_cast<int>(cudaGetLastError());
}
