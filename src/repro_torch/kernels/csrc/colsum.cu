// Masked relu column sums of a cached similarity block on Hopper.
//
// No TPU kernel has this job: the reference computes it inline,
// jnp.sum(jnp.maximum(s - cov[:, None], 0), axis=0), in every greedy step
// of its cached-similarity engine (src/repro/core/greedi.py:610, :636,
// :964, :1015, :1057).  For every shard b and every column c it takes,
//
//   out[b, c] = sum_i relu(s[b, i, col(b, c)] - cov[b, i]),
//
// where col(b, c) = c (a full pass over the nc columns) or cols[b, c] (a
// gathered pass over the t columns a lazy rescan asks for).  Hole rows are
// zero rows of s with cov 0, so they add +0 and need no mask.
//
// Fixed order.  The lazy round 1 selects what the standard round 1 selects
// only if a column's sum has the same bits in a full pass and in any
// gathered tile.  So the rows are split into chunks of `ch` rows, a number
// the wrapper derives from nl alone (kernels/colsum.py chunk_rows); each
// chunk is summed in ascending row order by one thread, starting from +0;
// stage 2 adds the chunks' partial sums in ascending chunk order, starting
// from +0 (one chunk: stage 1 writes the sum itself, the same bits).  No
// atomics, no tree across threads: the order of every addition is a
// function of nl only, never of nc, t or the column ids, and it is the
// order kernels/ref.py relu_colsum_ref follows, so the kernel and its
// plain version agree in every bit.
//
// Bound: a pass reads each value of s it sums once (m nl t floats) for 3 m
// nl t operations, 0.75 FLOP a byte: far below the FP32 ridge, so it is
// bound by the bytes of s (a full pass over the 16 GiB round-1 block at m
// = 16, nl = 16384: 5.13 ms at 3.35 TB/s).  Design:
//   * stage 1, a block of 256 threads per (256 columns, row chunk, shard):
//     thread x owns one column; a warp reads 32 consecutive columns of a
//     row (one 128-byte line in a full pass, 32 sectors in a gathered one);
//     loads run 8 rows ahead of the dependent adds; the chunk's cov values
//     are staged once in shared memory;
//   * partial sums of (shard, chunk, column) go to a scratch the wrapper
//     allocates (m x chunks x t floats, 64 MB beside the 16 GiB block);
//   * stage 2, one thread per (shard, column), adds them up;
//   * s is read with its own row pitch and shard stride (64-bit offsets);
//     a column id outside [0, nc) gives NaN in its sum instead of a read
//     out of bounds, visible without a host check.
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {

constexpr int64_t MAX_GRID_YZ = 65535;  // CUDA's limit on gridDim.y / .z
constexpr int CS_NT = 256;   // threads (columns) per block
constexpr int CS_AHEAD = 8;  // rows loaded ahead of the adds

struct CSArgs {
  const float* s;
  const float* cov;
  const int64_t* cols;  // nullptr: a full pass
  float* part;          // (m, chunks, t); nullptr when chunks == 1
  float* out;           // (m, t)
  int64_t nl, nc, t, ld, bs, cols_bs, ch, chunks;
};

__global__ void __launch_bounds__(CS_NT)
    colsum_chunks(const CSArgs a) {
  __shared__ float scov[CS_NT];
  const int64_t b = blockIdx.z;
  const int64_t k = blockIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * CS_NT + threadIdx.x;
  const int64_t r0 = k * a.ch;
  const int64_t r1 = min64(r0 + a.ch, a.nl);
  const float* cov = a.cov + b * a.nl;
  bool bad = false;
  int64_t col = c;
  if (c < a.t && a.cols != nullptr) {
    col = a.cols[b * a.cols_bs + c];
    bad = col < 0 || col >= a.nc;
    if (bad) col = 0;
  }
  const float* p = a.s + b * a.bs + col;
  float acc = 0.0f;
  for (int64_t base = r0; base < r1; base += CS_NT) {
    const int64_t rows = min64(CS_NT, r1 - base);
    __syncthreads();
    if (threadIdx.x < rows) scov[threadIdx.x] = cov[base + threadIdx.x];
    __syncthreads();
    if (c >= a.t) continue;
    int64_t i = 0;
    for (; i + CS_AHEAD <= rows; i += CS_AHEAD) {
      float v[CS_AHEAD];
#pragma unroll
      for (int u = 0; u < CS_AHEAD; ++u)
        v[u] = __ldg(p + (base + i + u) * a.ld);
#pragma unroll
      for (int u = 0; u < CS_AHEAD; ++u)
        acc = __fadd_rn(acc, fmaxf(__fsub_rn(v[u], scov[i + u]), 0.0f));
    }
    for (; i < rows; ++i)
      acc = __fadd_rn(acc, fmaxf(__fsub_rn(__ldg(p + (base + i) * a.ld),
                                           scov[i]), 0.0f));
  }
  if (c >= a.t) return;
  if (bad) acc = CUDART_NAN_F;
  if (a.chunks == 1)
    a.out[b * a.t + c] = acc;
  else
    a.part[(b * a.chunks + k) * a.t + c] = acc;
}

__global__ void __launch_bounds__(CS_NT)
    colsum_fold(const CSArgs a) {
  const int64_t b = blockIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * CS_NT + threadIdx.x;
  if (c >= a.t) return;
  const float* part = a.part + b * a.chunks * a.t + c;
  float acc = 0.0f;
  for (int64_t k = 0; k < a.chunks; ++k)
    acc = __fadd_rn(acc, part[k * a.t]);
  a.out[b * a.t + c] = acc;
}

}  // namespace sm90

// out (m, t) float32; part (m, chunks, t) float32 scratch, unused (may be
// NULL) at chunks == 1.  s (m, nl, nc) float32 with row pitch ld and shard
// stride bs (elements); cov (m, nl) float32, contiguous; cols NULL or (m,
// t) int64 with shard stride cols_bs.  ch rows a chunk; chunks = ceil(nl / ch).
extern "C" int sm90_relu_colsum(const void* s, const void* cov,
                                const void* cols, void* part, void* out,
                                int64_t m, int64_t nl, int64_t nc, int64_t t,
                                int64_t ld, int64_t bs, int64_t cols_bs,
                                int64_t ch, void* stream) {
  using namespace sm90;
  if (m < 1 || t < 1 || nl < 1 || ch < 1) return 0;
  CSArgs a{};
  a.s = static_cast<const float*>(s);
  a.cov = static_cast<const float*>(cov);
  a.cols = static_cast<const int64_t*>(cols);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  a.nl = nl;
  a.nc = nc;
  a.t = t;
  a.ld = ld;
  a.bs = bs;
  a.cols_bs = cols_bs;
  a.ch = ch;
  a.chunks = cdiv(nl, ch);
  if (a.chunks > 1 && part == nullptr) return cudaErrorInvalidValue;
  if (m > MAX_GRID_YZ || a.chunks > MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(cdiv(t, CS_NT)),
                   static_cast<unsigned>(a.chunks),
                   static_cast<unsigned>(m));
  colsum_chunks<<<grid1, CS_NT, 0, st>>>(a);
  if (a.chunks > 1) {
    const dim3 grid2(static_cast<unsigned>(cdiv(t, CS_NT)),
                     static_cast<unsigned>(m));
    colsum_fold<<<grid2, CS_NT, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
