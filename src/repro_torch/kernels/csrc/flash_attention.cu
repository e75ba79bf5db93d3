// Causal / non-causal GQA flash attention (prefill) on Hopper.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py, flash_attention_pallas
// and computes what its _flash_kernel computes, for q (B, H, L, dh) and
// k, v (B, Hkv, L, dh) (Lq == Lk, self-attention), query head h reading KV
// head h / (H / Hkv):
//
//   s    = (q * scale) . k^T              float32, q scaled before the product
//   s    = -1e30 where key >= L, or key > query when causal
//   m, l = running row max and normaliser (online softmax, float32)
//   acc  = acc * exp(m_old - m) + exp(s - m) . v
//   out  = acc / max(l, 1e-30)            cast to q's dtype
//
// This kernel takes float32 operands; all arithmetic is float32 FFMA, as
// the TPU kernel's is.  The (L, L) logits never reach device memory.
//
// Bound on this card.  4 B H dh live_pairs operations (live_pairs = L(L+1)/2
// causal, L^2 otherwise) against q, k, v and o read or written once: at the
// serving shape (B 8, H 32, Hkv 8, L 2048, dh 128) 275 GFLOP for 336 MB, so
// the kernel is bound by operations.  The least time is 0.278 ms at the
// bf16 tensor-core peak (989 TFLOP/s); with the FP32 FFMA this kernel uses
// (67 TFLOP/s) it is 4.10 ms.
//
// Design.  The TPU kernel carries acc / m / l across its sequential key-tile
// grid axis in VMEM scratch.  Here one block of 256 threads owns one 64-row
// query tile of one (b, h): the query tile is blockIdx.x (the last tiles,
// which see the most keys under the causal mask, are scheduled first) and
// b * H + h is blockIdx.y (split into launches of 65535 when B H is larger).
// The block loops over 64-key tiles in a fixed order, from 0 up to the
// diagonal: the causal skip is the loop bound, not a predicate.
//   * Q (scaled) and each K / V tile are staged as float32 in dynamic shared
//     memory; P reuses the K tile's space once S is computed.  100 KB at
//     dh = 128, so two blocks share an SM.
//   * Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i
//     (i < 4), key columns tx + 16 j of S (j < 4) and dh / 16 columns of the
//     output; S, acc, m and l stay in registers.  Row max and row sum are
//     16-lane shuffle butterflies; the sum is then taken from the row's first
//     lane, so every lane of a row divides by the same l.
//   * No split-K and no atomics: every sum runs in a fixed order, so results
//     are bit-reproducible run to run.
//   * Strides for the B, H and L axes (dh contiguous), so the projections'
//     transposed views need no copy; 64-bit offsets.
// The wrapper sends only float32 operands here, the exact parity path;
// bfloat16 operands go to the tensor-core kernel (flash_attention_tc.cu:
// wgmma, a TMA ring of K / V stages, warp specialisation).
#include "tile.cuh"

namespace sm90 {

constexpr int FA_BQ = 64;   // query rows per block
constexpr int FA_BK = 64;   // keys per tile
constexpr int FA_NT = 256;  // threads per block

template <int DH>
struct FaSmem {
  static constexpr int QP = DH + 4;     // pitch of staged Q and K rows
  static constexpr int PP = FA_BK + 4;  // pitch of P rows
  static constexpr int KPF =            // K tile, then P, in one space
      FA_BK * QP > FA_BQ * PP ? FA_BK * QP : FA_BQ * PP;
  static constexpr int FLOATS = FA_BQ * QP + KPF + FA_BK * DH;
};

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t h, group, len;           // query heads, H / Hkv, L
  int64_t sqb, sqh, sql;           // element strides of q over B, H, L
  int64_t skb, skh, skl;
  int64_t svb, svh, svl;
  int64_t bh0;                     // first b * H + h of this launch
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows [row0, row0 + 64) of one head's (L, DH) matrix (row stride sl) into
// s[r * PITCH + c] as float32 times mul, zero past row L.
template <int DH, int PITCH>
__device__ __forceinline__ void fa_stage(const float* __restrict__ base,
                                         int64_t sl, int64_t row0,
                                         int64_t len, float mul,
                                         float* __restrict__ s) {
  constexpr int C4 = DH / 4;
#pragma unroll
  for (int it = 0; it < (FA_BQ * C4) / FA_NT; ++it) {
    const int idx = threadIdx.x + it * FA_NT;
    const int r = idx / C4, c4 = idx % C4;
    const int64_t gr = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < len) x = load4(base + gr * sl + c4 * 4);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(&s[r * PITCH + c4 * 4]) = x;
  }
}

// Output column of this thread's c-th accumulator: two groups of 4 at
// dh = 128 (tx * 4 and 64 + tx * 4), one group of 4 at 64, a pair at 32.
template <int DH>
__device__ __forceinline__ int out_col(int c, int tx) {
  constexpr int W = DH / 16 < 4 ? DH / 16 : 4;
  return (c / 4) * 64 + tx * W + (c % 4);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(FA_NT, 2) flash_fwd(const FaArgs a) {
  using S = FaSmem<DH>;
  constexpr int OC = DH / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + FA_BQ * S::QP;  // K tile; P once S is computed
  float* vs = ks + S::KPF;

  const int64_t bh = a.bh0 + blockIdx.y;
  const int64_t b = bh / a.h, h = bh % a.h, hk = h / a.group;
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) *
                     FA_BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* kb = static_cast<const float*>(a.k) + b * a.skb + hk * a.skh;
  const float* vb = static_cast<const float*>(a.v) + b * a.svb + hk * a.svh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row_lane = threadIdx.x & 16;  // first lane of this row's 16

  float acc[4][OC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  fa_stage<DH, S::QP>(qb, a.sql, q0, a.len, a.scale, qs);
  int64_t n_tiles = cdiv(a.len, FA_BK);
  if (CAUSAL) {
    const int64_t diag = (q0 + FA_BQ - 1) / FA_BK + 1;
    n_tiles = diag < n_tiles ? diag : n_tiles;
  }
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t k0 = t * FA_BK;
    fa_stage<DH, S::QP>(kb, a.skl, k0, a.len, 1.0f, ks);
    fa_stage<DH, DH>(vb, a.svl, k0, a.len, 1.0f, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * S::QP +
                                                     d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * S::QP +
                                                     d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // mask, then the online-softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qrow = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + tx + 16 * j;
        const bool live = key < a.len && (!CAUSAL || key <= qrow);
        if (!live) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      rs = __shfl_sync(0xffffffffu, rs, row_lane);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every warp is done reading K: P takes its place
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * S::PP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * S::PP +
                                                     kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = &vs[(kk + e) * DH];
        float vv[OC];
        if constexpr (OC >= 4) {
#pragma unroll
          for (int g = 0; g < OC / 4; ++g) {
            const float4 x =
                *reinterpret_cast<const float4*>(&vrow[g * 64 + tx * 4]);
            vv[g * 4 + 0] = x.x;
            vv[g * 4 + 1] = x.y;
            vv[g * 4 + 2] = x.z;
            vv[g * 4 + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(&vrow[tx * 2]);
          vv[0] = x.x;
          vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y
                        : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites P and V
  }

  float* ob = static_cast<float*>(a.o) + bh * a.len * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= a.len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + row * DH;
    if constexpr (OC >= 4) {
#pragma unroll
      for (int g = 0; g < OC / 4; ++g)
        store4(orow + out_col<DH>(g * 4, tx),
               make_float4(acc[i][g * 4] / den, acc[i][g * 4 + 1] / den,
                           acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den));
    } else {
      store2(orow + out_col<DH>(0, tx), acc[i][0] / den, acc[i][1] / den);
    }
  }
}

template <int DH, bool CAUSAL>
int fa_launch(FaArgs a, int64_t bh_total, cudaStream_t stream) {
  const int smem = FaSmem<DH>::FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DH, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned gx = static_cast<unsigned>(cdiv(a.len, FA_BQ));
  constexpr int64_t MAX_Y = 65535;  // CUDA's limit on gridDim.y
  for (int64_t bh0 = 0; bh0 < bh_total; bh0 += MAX_Y) {
    a.bh0 = bh0;
    const int64_t ny = bh_total - bh0 < MAX_Y ? bh_total - bh0 : MAX_Y;
    const dim3 grid(gx, static_cast<unsigned>(ny));
    flash_fwd<DH, CAUSAL><<<grid, FA_NT, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int DH>
int fa_causal(const FaArgs& a, int64_t bh_total, bool causal,
              cudaStream_t s) {
  return causal ? fa_launch<DH, true>(a, bh_total, s)
                : fa_launch<DH, false>(a, bh_total, s);
}

int fa_dh(const FaArgs& a, int64_t bh_total, int64_t dh, bool causal,
          cudaStream_t s) {
  switch (dh) {
    case 32: return fa_causal<32>(a, bh_total, causal, s);
    case 64: return fa_causal<64>(a, bh_total, causal, s);
    case 128: return fa_causal<128>(a, bh_total, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90

// o (B, H, L, dh) contiguous float32; q, k, v float32 with element strides
// over their B, H and L axes and dh contiguous (the wrapper checks
// alignment).  bfloat16 operands take csrc/flash_attention_tc.cu.
extern "C" int sm90_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t heads, int64_t kv_heads, int64_t len, int64_t dh, int64_t sqb,
    int64_t sqh, int64_t sql, int64_t skb, int64_t skh, int64_t skl,
    int64_t svb, int64_t svh, int64_t svl, int64_t causal, float scale,
    void* stream) {
  using namespace sm90;
  const FaArgs a{q,   k,   v,   o,   heads, heads / kv_heads, len, sqb,
                 sqh, sql, skb, skh, skl,   svb,  svh,  svl,  0,   scale};
  return fa_dh(a, batch * heads, dh, causal != 0,
               static_cast<cudaStream_t>(stream));
}
