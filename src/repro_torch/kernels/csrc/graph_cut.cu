// Graph-cut node gains and the fused node-space select step on Hopper.
//
// Replaces two TPU kernels:
//   src/repro/kernels/graph_cut_gain.py, graph_cut_gain_pallas
//   src/repro/kernels/select_top1.py,    graph_cut_select_pallas
// For the cut f(S) = sum_{i in S, j not in S} w_ij the marginal gain of node
// v is deg_v - 2 (W x)_v = (W (1 - 2x))_v.  For every selection vector p
// (a GreeDi partition, or a query of the batched select)
//
//   gains[p, v] = sum_u W[v, u] * c[p, u],   c = ind * (1 - 2x)
//
// where ind is the node indicator of a partition's induced subgraph under
// local evaluation (absent: the whole graph), so one shared W serves every
// partition and no masked copy of W exists.  The kernel forms c itself from
// x and ind as they lie in device memory (float32, or bool / uint8), each
// with its own stride between vectors (0: one vector shared by all P), so a
// call is exactly one launch: nothing is converted, padded or staged by the
// host.  c is 1 - 2x times ind in float32, as kernels/ref.py computes it.
// The select entry returns the masked top-1 of each p's gains instead
// (nodes with ok = 0 score NEG; the larger gain wins, ties go to the lowest
// node; (NEG, 0) when nothing is feasible), as kernels/ref.py does.  The
// kernel reads W row by row, so it computes W c for any W and relies on no
// symmetry (GraphCut.init_w makes W symmetric, so rows are columns anyway).
//
// Bound on this card: a GEMV.  W is n^2 elements read once for 2 n^2 P
// operations; at P <= 16 that is at most 8 FLOP per f32 byte, far below the
// card's FP32 ridge of 20, so the kernel is bound by the bytes of W
// (5.39 GB, 1.61 ms at n = 36692 in f32).  The design reads W once for all
// P vectors of a launch:
//   * a stripe of W's rows (RW rows per warp, 8 warps) is read by one block;
//     a warp reads each of its rows along the columns with VEC-element loads
//     (16 bytes where n and the base address allow, narrower otherwise, so
//     every load stays aligned), neighbouring lanes on neighbouring
//     addresses; bf16 W is converted to f32 on load;
//   * one vector (P = 1, graph_cut_direct): a block a stripe, and each lane
//     forms the c of its own columns from x and ind (L1 / L2 hits: 147 KB
//     at n = 36692) right beside its W loads, so warps never wait for each
//     other: no shared memory and no barrier;
//   * several (graph_cut_staged, a cooperative launch of as many blocks as
//     the card holds at once): the grid first forms every c once into a
//     float32 scratch (zero past n and past n_part) and waits for itself;
//     then each block walks (stripe, group of up to PB = 16 vectors) items,
//     staging c in chunks of 512 columns through shared memory, and each
//     lane keeps RW x PB register accumulators, so a W element loaded once
//     feeds every p.  Forming c in every block instead read x and ind from
//     L2 at 8 bytes an element per stripe, twice the bytes of W at P = 16,
//     and took twice the time;
//   * each lane sums its columns in column order and a fixed butterfly of
//     shuffles finishes each row: no atomics in any sum, so gains are
//     bit-reproducible and the same as when the wrapper formed c;
//   * 64-bit offsets (n^2 passes 2^31 at n = 46341).
// The TPU select kernel carries a running best across its sequential grid.
// Here every stripe applies the NEG floor to its own rows and writes one
// (best, index) pair per p; the last block to finish (an atomic ticket)
// folds the pairs in the lowest-index top-1 order of tile.cuh, a total
// order, so the answer does not depend on which block folds.  The tickets
// live in a buffer the wrapper zeroes once; the folding block sets its
// ticket back to 0.
#include <cstring>

#include <cooperative_groups.h>

#include "tile.cuh"

namespace sm90 {

constexpr int GC_CK = 512;  // columns of c staged per chunk

// VEC consecutive elements of a row as float32, in one aligned load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
  T tmp[VEC];
  if constexpr (BYTES == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(tmp, &u, BYTES);
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(tmp, &u, BYTES);
  } else if constexpr (BYTES == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(tmp, &u, BYTES);
  } else {
    static_assert(BYTES == 2, "load_vec: 2, 4, 8 or 16 bytes");
    const unsigned short u =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(tmp, &u, BYTES);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f32(tmp[e]);
}

// A ((P,) n) operand read where it lies: float32, or bool / uint8.
struct GcVec {
  const void* p;  // nullptr: absent (all ones)
  int64_t ps;     // elements between the vectors of p (0: shared)
  int u8;         // 1: one byte an element (bool / uint8), 0: float32
  int wide;       // 1: 4-element loads are aligned (address, ps and n)
};

__device__ __forceinline__ float gc_at(const GcVec& v, int64_t p,
                                       int64_t col) {
  const int64_t i = p * v.ps + col;
  return v.u8 ? static_cast<float>(__ldg(static_cast<const uint8_t*>(v.p) + i))
              : __ldg(static_cast<const float*>(v.p) + i);
}

// Columns col .. col + 3 of vector p as float32, zero past column n.
__device__ __forceinline__ float4 gc_at4(const GcVec& v, int64_t p,
                                         int64_t col, int64_t n) {
  const int64_t i = p * v.ps + col;
  if (v.wide && col + 3 < n) {
    if (v.u8) {
      const uchar4 u =
          __ldg(reinterpret_cast<const uchar4*>(static_cast<const uint8_t*>(
                                                    v.p) + i));
      return make_float4(u.x, u.y, u.z, u.w);
    }
    return __ldg(
        reinterpret_cast<const float4*>(static_cast<const float*>(v.p) + i));
  }
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    e[k] = col + k < n ? gc_at(v, p, col + k) : 0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// c = ind * (1 - 2x) for columns col .. col + 3 of vector p (0 past n).
__device__ __forceinline__ float4 gc_cols4(const GcVec& x, const GcVec& ind,
                                           int64_t p, int64_t col,
                                           int64_t n) {
  const float4 xv = gc_at4(x, p, col, n);
  float4 c = make_float4(col < n ? 1.0f - 2.0f * xv.x : 0.0f,
                         col + 1 < n ? 1.0f - 2.0f * xv.y : 0.0f,
                         col + 2 < n ? 1.0f - 2.0f * xv.z : 0.0f,
                         col + 3 < n ? 1.0f - 2.0f * xv.w : 0.0f);
  if (ind.p != nullptr) {
    const float4 iv = gc_at4(ind, p, col, n);
    c.x *= iv.x;
    c.y *= iv.y;
    c.z *= iv.z;
    c.w *= iv.w;
  }
  return c;
}

__device__ __forceinline__ float gc_col(const GcVec& x, const GcVec& ind,
                                        int64_t p, int64_t col) {
  const float c = 1.0f - 2.0f * gc_at(x, p, col);
  return ind.p != nullptr ? c * gc_at(ind, p, col) : c;
}

struct GCArgs {
  const void* w;
  GcVec x, ind, ok;
  float* cbuf;         // staged path: (groups * PB, ldc) column vectors
  int64_t ldc;         // a multiple of GC_CK
  float* out;          // gains (n_part, n), or nullptr for the select
  float* tile_best;    // select: (n_part, tiles) per-stripe pairs
  int* tile_idx;
  unsigned* tickets;   // select: one zeroed counter per blockIdx.y
  float* best;         // select: (n_part,)
  int64_t* idx;
  int64_t n, n_part, tiles;
};

// Shared memory of one block.
template <int PB, int ROWS, bool STAGED>
struct GcSmem {
  float cs[STAGED ? PB : 1][STAGED ? GC_CK : 4];  // a chunk of c
  float sv[PB][ROWS];                              // select: row gains
  bool last;                                       // select: this folds
};

// Rows [stripe * ROWS, + ROWS) of W against the PB vectors p0 .. p0 + PB:
// gains into a.out, or the stripe's masked top-1 of each p into the pairs.
// STAGED: c comes from a.cbuf through shared memory (every thread of the
// block takes part: it has barriers); else each lane forms its own c.
template <typename T, int VEC, int PB, int RW, int NW, bool STAGED>
__device__ __forceinline__ void gc_stripe(const GCArgs& a, int64_t stripe,
                                          int64_t p0,
                                          GcSmem<PB, NW * RW, STAGED>& sm) {
  constexpr int NT_ = NW * 32;
  constexpr int ROWS = NW * RW;
  constexpr int STEPS = GC_CK / (32 * VEC);
  static_assert(GC_CK % (32 * VEC) == 0, "chunk of whole warp loads");
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int64_t n = a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t block_row0 = stripe * ROWS;
  const int64_t row0 = block_row0 + warp * RW;

  float acc[RW][PB];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int p = 0; p < PB; ++p) acc[r][p] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < n; k0 += GC_CK) {
    if constexpr (STAGED) {
      const float* cg = a.cbuf + p0 * a.ldc + k0;
      for (int i = threadIdx.x; i < PB * (GC_CK / 4); i += NT_) {
        const int p = i / (GC_CK / 4), q = i % (GC_CK / 4);
        reinterpret_cast<float4*>(sm.cs[p])[q] =
            __ldcg(reinterpret_cast<const float4*>(cg + p * a.ldc) + q);
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int col = (s * 32 + lane) * VEC;  // within the chunk
      const int64_t gcol = k0 + col;
      // n % VEC == 0 (the wrapper's choice of VEC): a vector that starts
      // inside the row ends inside it
      if (gcol < n) {
        float wv[RW][VEC];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          if (row0 + r < n) {
            load_vec<T, VEC>(w + (row0 + r) * n + gcol, wv[r]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) wv[r][e] = 0.0f;
          }
        }
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          float cv[VEC];
          if constexpr (STAGED) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) cv[e] = sm.cs[p][col + e];
          } else if constexpr (VEC % 4 == 0) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 c = gc_cols4(a.x, a.ind, p0 + p, gcol + e, n);
              cv[e] = c.x;
              cv[e + 1] = c.y;
              cv[e + 2] = c.z;
              cv[e + 3] = c.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              cv[e] = gc_col(a.x, a.ind, p0 + p, gcol + e);
          }
#pragma unroll
          for (int r = 0; r < RW; ++r) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][p] = fmaf(wv[r][e], cv[e], acc[r][p]);
          }
        }
      }
    }
    if constexpr (STAGED) __syncthreads();  // cs is restaged next chunk
  }

  // Fixed butterfly over the 32 lanes: every lane ends with the row sums.
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      float v = acc[r][p];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][p] = v;
    }
  }

  if (a.out != nullptr) {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          if (row0 + r < n && p0 + p < a.n_part)
            a.out[(p0 + p) * n + row0 + r] = acc[r][p];
        }
      }
    }
    return;
  }

  // Select: the NEG floor on this stripe's rows, then its top-1 per p.
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int64_t row = row0 + r;
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        float v = -CUDART_INF_F;  // rows past n never win
        if (row < n && p0 + p < a.n_part)
          v = gc_at(a.ok, p0 + p, row) > 0.0f ? acc[r][p] : NEG;
        sm.sv[p][warp * RW + r] = v;
      }
    }
  }
  __syncthreads();
  for (int p = warp; p < PB; p += NW) {
    if (p0 + p >= a.n_part) continue;  // warp-uniform
    float v = -CUDART_INF_F;
    int vi = 0x7fffffff;
    for (int j = lane; j < ROWS; j += 32) {
      const float vj = sm.sv[p][j];
      if (vj != -CUDART_INF_F)
        take_better(v, vi, vj, static_cast<int>(block_row0 + j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, vi, off);
      take_better(v, vi, v2, i2);
    }
    if (lane == 0) {
      a.tile_best[(p0 + p) * a.tiles + stripe] = v;
      a.tile_idx[(p0 + p) * a.tiles + stripe] = vi;
    }
  }
  __syncthreads();  // sv is rewritten by the block's next stripe
}

// Select: once this block's pairs are written, the last block of its
// blockIdx.y to finish folds the pairs of vectors [p_lo, p_hi) and sets
// the counter back to 0.
template <int PB, int ROWS, bool STAGED>
__device__ __forceinline__ void gc_fold(const GCArgs& a, int64_t p_lo,
                                        int64_t p_hi,
                                        GcSmem<PB, ROWS, STAGED>& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm.last = atomicAdd(&a.tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  for (int64_t p = p_lo + warp; p < p_hi; p += nw) {
    float v = -CUDART_INF_F;
    int vi = 0x7fffffff;
    for (int64_t t = lane; t < a.tiles; t += 32)
      take_better(v, vi, __ldcg(&a.tile_best[p * a.tiles + t]),
                  __ldcg(&a.tile_idx[p * a.tiles + t]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, vi, off);
      take_better(v, vi, v2, i2);
    }
    if (lane == 0) {
      a.best[p] = v;
      a.idx[p] = vi;
    }
  }
  if (threadIdx.x == 0) a.tickets[blockIdx.y] = 0u;
}

// One vector a block row (blockIdx.y = p): one stripe per block.
template <typename T, int VEC, int RW, int NW>
__global__ void __launch_bounds__(NW * 32) graph_cut_direct(const GCArgs a) {
  __shared__ GcSmem<1, NW * RW, false> sm;
  gc_stripe<T, VEC, 1, RW, NW, false>(a, blockIdx.x, blockIdx.y, sm);
  if (a.out == nullptr) gc_fold(a, blockIdx.y, blockIdx.y + 1, sm);
}

// Groups of PB vectors, one cooperative launch: the grid forms every c once
// into a.cbuf (zero past n and past n_part), waits for the whole grid, then
// each block walks (stripe, group) items, so a block stages c from L2 at
// 4 bytes an element, and x and ind are read once.
template <typename T, int VEC, int PB, int RW, int NW>
__global__ void __launch_bounds__(NW * 32) graph_cut_staged(const GCArgs a) {
  __shared__ __align__(16) GcSmem<PB, NW * RW, true> sm;
  const int64_t groups = cdiv(a.n_part, PB);
  const int64_t q4 = a.ldc / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups * PB * q4; i += stride) {
    const int64_t p = i / q4, col = (i % q4) * 4;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < a.n_part) c = gc_cols4(a.x, a.ind, p, col, a.n);
    reinterpret_cast<float4*>(a.cbuf)[i] = c;
  }
  cooperative_groups::this_grid().sync();
  for (int64_t it = blockIdx.x; it < a.tiles * groups; it += gridDim.x)
    gc_stripe<T, VEC, PB, RW, NW, true>(a, it % a.tiles, (it / a.tiles) * PB,
                                         sm);
  if (a.out == nullptr) gc_fold(a, 0, a.n_part, sm);
}

constexpr int GC_NW = 8;  // warps a block

// Rows of W a stripe for a pass of `pb` vectors: RW = 8 rows a warp, and 4
// at pb = 16 (the 64 accumulators of a lane stay in registers).
template <int PB>
constexpr int gc_rw() {
  return PB == 16 ? 4 : 8;
}

int64_t rows_per_stripe(int64_t pb) {
  return GC_NW * (pb == 16 ? gc_rw<16>() : gc_rw<1>());
}

template <typename T, int VEC, int PB>
int pass(const GCArgs& a, cudaStream_t s) {
  constexpr int RW = gc_rw<PB>();
  if constexpr (PB == 1) {
    const dim3 grid(static_cast<unsigned>(a.tiles),
                    static_cast<unsigned>(a.n_part));
    graph_cut_direct<T, VEC, RW, GC_NW><<<grid, GC_NW * 32, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  } else {
    // as many blocks as are resident at once: the grid waits for itself
    auto kernel = graph_cut_staged<T, VEC, PB, RW, GC_NW>;
    static int resident[64] = {};  // blocks the card holds at once, by device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            GC_NW * 32, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident[dev] = sms * per_sm;
    }
    const int64_t items = a.tiles * cdiv(a.n_part, PB);
    const int64_t most = resident[dev];
    const dim3 grid(static_cast<unsigned>(items < most ? items : most));
    GCArgs args = a;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                      dim3(GC_NW * 32), params, 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int VEC>
int pass_pb(const GCArgs& a, int64_t pb, cudaStream_t s) {
  switch (pb) {
    case 1: return pass<T, VEC, 1>(a, s);
    case 4: return pass<T, VEC, 4>(a, s);
    case 16: return pass<T, VEC, 16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int pass_any(GCArgs a, int64_t bf16, int64_t vec, int64_t pb,
             cudaStream_t s) {
  a.tiles = cdiv(a.n, rows_per_stripe(pb));
  a.ldc = cdiv(a.n, GC_CK) * GC_CK;
  if (bf16) {
    switch (vec) {
      case 1: return pass_pb<__nv_bfloat16, 1>(a, pb, s);
      case 4: return pass_pb<__nv_bfloat16, 4>(a, pb, s);
      case 8: return pass_pb<__nv_bfloat16, 8>(a, pb, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (vec) {
    case 1: return pass_pb<float, 1>(a, pb, s);
    case 4: return pass_pb<float, 4>(a, pb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

GcVec gc_vec(const void* p, int64_t ps, int64_t u8, int64_t wide) {
  return GcVec{p, ps, static_cast<int>(u8), static_cast<int>(wide)};
}

}  // namespace sm90

// Shapes, in elements: w (n, n) row-major, float32 (bf16 = 0) or bfloat16
// (bf16 = 1), its address a multiple of vec * element size and n % vec == 0
// (vec: 1 or 4 for float32, 1, 4 or 8 for bfloat16); pb 1, 4 or 16.  Each
// vector operand (x, ind, ok) is a base address, the element stride between
// its n_part vectors (0: one vector shared by all), a type flag (u8 = 1:
// bool / uint8, 0: float32) and `wide` = 1 where its address, stride and n
// are multiples of 4 elements; ind may be NULL (the whole graph).  At
// pb > 1, cbuf is float32 scratch of ceil(n_part / pb) * pb rows of
// ceil(n / 512) * 512 elements.  The caller allocates every output and
// scratch.  Every entry is one launch and returns its launch error, or 0.

// Node gains (n_part, n) float32.
extern "C" int sm90_graph_cut_gain(
    const void* w, const void* x, int64_t x_ps, int64_t x_u8, int64_t x_wide,
    const void* ind, int64_t ind_ps, int64_t ind_u8, int64_t ind_wide,
    void* cbuf, void* gains, int64_t n, int64_t n_part, int64_t bf16,
    int64_t vec, int64_t pb, void* stream) {
  using namespace sm90;
  GCArgs a{};
  a.w = w;
  a.x = gc_vec(x, x_ps, x_u8, x_wide);
  a.ind = gc_vec(ind, ind_ps, ind_u8, ind_wide);
  a.cbuf = static_cast<float*>(cbuf);
  a.out = static_cast<float*>(gains);
  a.n = n;
  a.n_part = n_part;
  return pass_any(a, bf16, vec, pb, static_cast<cudaStream_t>(stream));
}

// The number of per-stripe (best, index) pairs per vector the select
// writes at this n and pb: tile_best / tile_idx hold n_part times as many.
extern "C" int sm90_graph_cut_tiles(int64_t n, int64_t pb) {
  return static_cast<int>(sm90::cdiv(n, sm90::rows_per_stripe(pb)));
}

// Fused select in one launch: best (n_part,) float32 and idx (n_part,)
// int64; tickets holds n_part zeroed counters at pb = 1, one at pb > 1
// (the kernel leaves them zeroed).
extern "C" int sm90_graph_cut_select(
    const void* w, const void* x, int64_t x_ps, int64_t x_u8, int64_t x_wide,
    const void* ind, int64_t ind_ps, int64_t ind_u8, int64_t ind_wide,
    const void* ok, int64_t ok_ps, int64_t ok_u8, void* cbuf,
    void* tile_best, void* tile_idx, void* tickets, void* best, void* idx,
    int64_t n, int64_t n_part, int64_t bf16, int64_t vec, int64_t pb,
    void* stream) {
  using namespace sm90;
  GCArgs a{};
  a.w = w;
  a.x = gc_vec(x, x_ps, x_u8, x_wide);
  a.ind = gc_vec(ind, ind_ps, ind_u8, ind_wide);
  a.ok = gc_vec(ok, ok_ps, ok_u8, 0);
  a.cbuf = static_cast<float*>(cbuf);
  a.tile_best = static_cast<float*>(tile_best);
  a.tile_idx = static_cast<int*>(tile_idx);
  a.tickets = static_cast<unsigned*>(tickets);
  a.best = static_cast<float*>(best);
  a.idx = static_cast<int64_t*>(idx);
  a.n = n;
  a.n_part = n_part;
  return pass_any(a, bf16, vec, pb, static_cast<cudaStream_t>(stream));
}
