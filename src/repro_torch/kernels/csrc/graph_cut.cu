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
// where the wrapper builds c: ind is the node indicator of a partition's
// induced subgraph under local evaluation (all ones otherwise), so one
// shared W serves every partition and no masked copy of W exists.  The
// select entry returns the masked top-1 of each p's gains instead (nodes
// with ok = 0 score NEG; the larger gain wins, ties go to the lowest node;
// (NEG, 0) when nothing is feasible), as kernels/ref.py does.  The kernel
// reads W row by row, so it computes W c for any W and relies on no
// symmetry (GraphCut.init_w makes W symmetric, so rows are columns anyway).
//
// Bound on this card: a GEMV.  W is n^2 elements read once for 2 n^2 P
// operations; at P <= 16 that is at most 8 FLOP per f32 byte, far below the
// card's FP32 ridge of 20, so the kernel is bound by the bytes of W
// (5.39 GB, 1.61 ms at n = 36692 in f32).  The design reads W once for all
// P vectors of a launch:
//   * a block owns a stripe of rows (RW rows per warp, 8 warps); a warp
//     reads each of its rows along the columns with VEC-element loads
//     (16 bytes where n and the base address allow, narrower otherwise, so
//     every load stays aligned), neighbouring lanes on neighbouring
//     addresses; bf16 W is converted to f32 on load;
//   * the P column vectors go through shared memory in chunks of 512
//     columns (the wrapper pads them with zeros to a multiple of 512), and
//     each lane keeps RW x P register accumulators, so a W element loaded
//     once feeds every p.  Up to PB = 16 vectors share a pass; more take
//     one pass per group of 16 (blockIdx.y);
//   * each lane sums its columns in column order and a fixed butterfly of
//     shuffles finishes each row: no atomics, so sums are bit-reproducible;
//   * 64-bit offsets (n^2 passes 2^31 at n = 46341).
// The TPU select kernel carries a running best across its sequential grid.
// Here every block applies the NEG floor to its own rows and writes one
// (best, index) pair per p; fold_tiles (tile.cuh) takes the lowest-index
// top-1 of those pairs, as facility.cu does.
#include <cstring>

#include "tile.cuh"

namespace sm90 {

constexpr int GC_NT = 256;  // threads per block: 8 warps
constexpr int GC_CK = 512;  // columns of the vectors staged per chunk

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

// One pass over W for the PB vectors c[p0 .. p0 + PB) (p0 = blockIdx.y * PB).
// `c` is (groups * PB, ldc) float32, zero past column n and past row n_part.
// With `out` set, writes gains (n_part, n); with `tile_best` set, writes this
// block's masked top-1 per p to tile_best / tile_idx[p * gridDim.x + block].
template <typename T, int VEC, int PB, int RW>
__global__ void __launch_bounds__(GC_NT)
    graph_cut_pass(const T* __restrict__ w, const float* __restrict__ c,
                   const float* __restrict__ ok, float* __restrict__ out,
                   float* __restrict__ tile_best, int* __restrict__ tile_idx,
                   int64_t n, int64_t n_part, int64_t ldc, int64_t ok_bs) {
  constexpr int ROWS = (GC_NT / 32) * RW;  // rows of this block
  constexpr int STEPS = GC_CK / (32 * VEC);
  static_assert(GC_CK % (32 * VEC) == 0, "chunk of whole warp loads");
  __shared__ __align__(16) float cs[PB][GC_CK];
  __shared__ float sv[PB][ROWS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t block_row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int64_t row0 = block_row0 + warp * RW;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * PB;
  const float* __restrict__ cg = c + p0 * ldc;

  float acc[RW][PB];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int p = 0; p < PB; ++p) acc[r][p] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < n; k0 += GC_CK) {
    for (int i = threadIdx.x; i < PB * (GC_CK / 4); i += GC_NT) {
      const int p = i / (GC_CK / 4), q = i % (GC_CK / 4);
      reinterpret_cast<float4*>(cs[p])[q] =
          __ldg(reinterpret_cast<const float4*>(cg + p * ldc + k0) + q);
    }
    __syncthreads();
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
#pragma unroll
          for (int e = 0; e < VEC; ++e) cv[e] = cs[p][col + e];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][p] = fmaf(wv[r][e], cv[e], acc[r][p]);
          }
        }
      }
    }
    __syncthreads();  // cs is restaged by the next chunk
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

  if (tile_best == nullptr) {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          if (row0 + r < n && p0 + p < n_part)
            out[(p0 + p) * n + row0 + r] = acc[r][p];
        }
      }
    }
    return;
  }

  // Select epilogue: the NEG floor on this block's rows, then its top-1.
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int64_t row = row0 + r;
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        float v = -CUDART_INF_F;  // rows past n never win
        if (row < n && p0 + p < n_part)
          v = ok[(p0 + p) * ok_bs + row] > 0.0f ? acc[r][p] : NEG;
        sv[p][warp * RW + r] = v;
      }
    }
  }
  __syncthreads();
  for (int p = warp; p < PB; p += GC_NT / 32) {
    if (p0 + p >= n_part) continue;  // warp-uniform
    float v = -CUDART_INF_F;
    int vi = 0x7fffffff;
    for (int j = lane; j < ROWS; j += 32) {
      const float vj = sv[p][j];
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
      tile_best[(p0 + p) * gridDim.x + blockIdx.x] = v;
      tile_idx[(p0 + p) * gridDim.x + blockIdx.x] = vi;
    }
  }
}

struct GCArgs {
  const void* w;
  const float* c;
  const float* ok;
  float* out;
  float* tile_best;
  int* tile_idx;
  int64_t n, n_part, ldc, ok_bs;
};

template <typename T, int VEC, int PB, int RW>
int pass(const GCArgs& a, cudaStream_t s) {
  constexpr int ROWS = (GC_NT / 32) * RW;
  const dim3 grid(static_cast<unsigned>(cdiv(a.n, ROWS)),
                  static_cast<unsigned>(cdiv(a.n_part, PB)));
  graph_cut_pass<T, VEC, PB, RW><<<grid, GC_NT, 0, s>>>(
      static_cast<const T*>(a.w), a.c, a.ok, a.out, a.tile_best, a.tile_idx,
      a.n, a.n_part, a.ldc, a.ok_bs);
  return static_cast<int>(cudaGetLastError());
}

// PB vectors per pass: 1 (RW = 8), 4 (RW = 8) or 16 (RW = 4 keeps the
// 64 accumulators of a lane in registers).
template <typename T, int VEC>
int pass_pb(const GCArgs& a, int64_t pb, cudaStream_t s) {
  switch (pb) {
    case 1: return pass<T, VEC, 1, 8>(a, s);
    case 4: return pass<T, VEC, 4, 8>(a, s);
    case 16: return pass<T, VEC, 16, 4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int pass_any(const GCArgs& a, int64_t bf16, int64_t vec, int64_t pb,
             cudaStream_t s) {
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

// Rows of W per block for a pass of `pb` vectors (the grid's x extent is
// ceil(n / rows)).
int64_t rows_per_block(int64_t pb) {
  return (GC_NT / 32) * (pb == 16 ? 4 : 8);
}

}  // namespace sm90

// Shapes, in elements: w (n, n) row-major, float32 (bf16 = 0) or bfloat16
// (bf16 = 1), its address a multiple of vec * element size and n % vec == 0
// (vec: 1 or 4 for float32, 1, 4 or 8 for bfloat16); c (ceil(n_part / pb) *
// pb, ldc) float32 with ldc a multiple of 512, zero past column n and row
// n_part; pb 1, 4 or 16.  The caller allocates every output and scratch.
// Every entry returns the first launch error, or 0.

// Node gains (n_part, n) float32.
extern "C" int sm90_graph_cut_gain(const void* w, const void* c, void* gains,
                                   int64_t n, int64_t n_part, int64_t ldc,
                                   int64_t bf16, int64_t vec, int64_t pb,
                                   void* stream) {
  using namespace sm90;
  const GCArgs a{w, static_cast<const float*>(c), nullptr,
                 static_cast<float*>(gains), nullptr, nullptr, n, n_part,
                 ldc, 0};
  return pass_any(a, bf16, vec, pb, static_cast<cudaStream_t>(stream));
}

// The number of per-block (best, index) pairs per vector the select writes
// at this n and pb: tile_best / tile_idx hold n_part times as many.
extern "C" int sm90_graph_cut_tiles(int64_t n, int64_t pb) {
  return static_cast<int>(sm90::cdiv(n, sm90::rows_per_block(pb)));
}

// Fused select: best (n_part,) float32 and idx (n_part,) int32; ok is
// (n_part, n) float32 with batch stride ok_bs (0: one ok shared by all).
extern "C" int sm90_graph_cut_select(const void* w, const void* c,
                                     const void* ok, void* tile_best,
                                     void* tile_idx, void* best, void* idx,
                                     int64_t n, int64_t n_part, int64_t ldc,
                                     int64_t ok_bs, int64_t bf16, int64_t vec,
                                     int64_t pb, void* stream) {
  using namespace sm90;
  const GCArgs a{w, static_cast<const float*>(c),
                 static_cast<const float*>(ok), nullptr,
                 static_cast<float*>(tile_best), static_cast<int*>(tile_idx),
                 n, n_part, ldc, ok_bs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = pass_any(a, bf16, vec, pb, s);
  if (err != 0) return err;
  const dim3 grid2(1, static_cast<unsigned>(n_part));
  fold_tiles<<<grid2, NT, 0, s>>>(static_cast<const float*>(tile_best),
                                  static_cast<const int*>(tile_idx),
                                  static_cast<float*>(best),
                                  static_cast<int*>(idx),
                                  sm90_graph_cut_tiles(n, pb));
  return static_cast<int>(cudaGetLastError());
}
