// Causal / non-causal GQA flash attention (prefill) on Hopper's bf16 tensor
// cores: the bf16 path of the port of the TPU kernel
//   src/repro/kernels/flash_attention.py, flash_attention_pallas
// computing what its _flash_kernel computes, for q (B, H, L, dh) and k, v
// (B, Hkv, L, dh) in bfloat16 (Lq == Lk), query head h reading KV head
// h / (H / Hkv):
//
//   s    = q . k^T                        float32 (tensor cores)
//   s    = s * scale, -1e30 where key >= L, or key > query when causal
//   m, l = running row max and normaliser (online softmax, float32)
//   acc  = acc * exp(m_old - m) + bf16(exp(s - m)) . v     float32
//   out  = acc / max(l, 1e-30)            bfloat16
//
// The TPU kernel scales q before the product; here the scale multiplies s in
// float32 (scaling a bf16 q would round it a second time), with log2(e)
// folded in so the exponentials are exp2.  The one rounding the FFMA kernel
// (flash_attention.cu, which keeps the float32 inputs) does not make is P
// to bf16 before P . V; l sums the float32 P.
//
// Bound on this card.  4 B H dh live_pairs operations against q, k, v and o
// read or written once: at the serving shape (B 8, H 32, Hkv 8, L 2048,
// dh 128, causal) 275 GFLOP for 336 MB, bound by operations: 0.278 ms at
// the bf16 tensor-core peak (989 TFLOP/s).
//
// Design (one block of 384 threads, one per SM: 227 KB of shared memory at
// most, 160 KB at dh 128):
//   * A block owns a 128-row query tile of one (b, h).  blockIdx.x is
//     b * H + h (no 65535 limit on x, so any B H takes one launch) and
//     blockIdx.y the query tile, the last tiles (the longest under the
//     causal mask) first; neighbouring blocks are heads sharing a KV head.
//   * Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24)
//     and one thread issues TMA loads: Q once, then K and V tiles of 128
//     keys through a ring of 2 stages, each stage with a full barrier for K,
//     one for V and an empty barrier, so the next tile's loads overlap this
//     tile's products.  The tensor maps are 4-D (dh, L, heads, B) over the
//     operands' own strides (the model's transposed v and any (B L, heads
//     dh) view need no copy); keys and queries past L arrive as TMA's
//     out-of-bounds zeros and are masked in s.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg 240; ptxas still
//     compiles every instance within the launch bound's 168 registers, so
//     a consumer waits for its S before the softmax and for P V before the
//     next S: issuing the next tile's S early keeps two S fragments live
//     and spilled), 64 query rows each (one wgmma M).  S = Q K^T is wgmma
//     m64n128k16 with both operands in 128-byte swizzled shared memory
//     (64-byte at dh 32, whose rows are 64 bytes); the row-major K tile is
//     the K-major B operand as it lies.
//     The online softmax runs on the accumulator fragments: a thread holds
//     2 rows, the 4 threads of a quad share them, and row max and row sum
//     are 2-step xor butterflies, whose sums are bitwise equal in the 4
//     lanes (float addition commutes), so every thread of a row divides by
//     the same l.  P is packed to bf16 in registers, where the m64nNk16
//     accumulator layout is the A-fragment layout of the next wgmma, and
//     O += P V is wgmma with A from registers and V's row-major tile as the
//     MN-major B operand (the transpose bit), so V is never transposed.
//   * Epilogue: O / max(l, 1e-30) to bf16, rows past L masked, straight from
//     the registers.
//   * No split-K and no atomics: every sum runs in a fixed order, so results
//     are bit-reproducible run to run.
//   * A barrier wait that has not completed after about 10 s of clock traps
//     (a launch error), so a lost TMA load fails instead of hanging.
// The tensor-map encoder is a driver-API call; it is taken through the
// runtime's cudaGetDriverEntryPoint[ByVersion], so the build links no
// libcuda.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "tile.cuh"

namespace sm90 {
namespace fatc {

constexpr int BQ = 128;     // query rows a block (two consumer warpgroups)
constexpr int BK = 128;     // keys a tile
constexpr int STAGES = 2;   // K / V ring
constexpr int NT = 384;     // producer warpgroup + two consumer warpgroups

template <int DH>
struct Cfg {
  static constexpr int BOXC = DH < 64 ? DH : 64;  // columns a TMA box
  static constexpr int ROWB = BOXC * 2;           // bytes of a box row
  static constexpr int NBOX = DH / BOXC;          // boxes a tile
  static constexpr int SWZ = ROWB == 128 ? 1 : 2;  // wgmma: 128B / 64B
  static constexpr int ATOM = 8 * ROWB;           // 8-row swizzle atom
  static constexpr int Q_BOX = BQ * ROWB;
  static constexpr int KV_BOX = BK * ROWB;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int N_BAR = 1 + 3 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;  // + alignment
};

struct Args {
  void* o;       // (B, H, L, dh) contiguous bfloat16
  int h;         // query heads
  int group;     // H / Hkv
  int len;       // L
  float scale2;  // scale * log2(e)
};

// ---------------------------------------------------------------------------
// PTX wrappers: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1: 128B, 2: 64B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swz) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it does not see the tensor cores write them).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_R16                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R32                                                            \
  FA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"
#define FA_R64                                                            \
  FA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
         "%56, %57, %58, %59, %60, %61, %62, %63"
#define FA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// wgmma m64nNk16, float32 += bf16 x bf16.  ss (S = Q K^T, N = 128): A and
// B in shared memory, both K-major; rs_t (O += P V, N = dh): A in
// registers (4 x bf16x2 a thread), B MN-major.
template <int N>
struct Wg;

template <>
struct Wg<32> {
  static __device__ __forceinline__ void rs_t(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" FA_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FA_D8(0), FA_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wg<64> {
  static __device__ __forceinline__ void rs_t(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" FA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wg<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" FA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
          FA_D8(48), FA_D8(56)
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs_t(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" FA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
          FA_D8(48), FA_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one tile on the S fragments of a thread:
// sc[j * 4 + i * 2 + c] is row r0 + 8 i, key k0 + 8 j + c0 + c.  Updates the
// running max m (log2 domain), returns alpha = exp2(m_old - m_new) and the
// float32 row sums of P, and packs P to bf16 A fragments (registers
// 4 kk .. 4 kk + 3 are keys 16 kk .. 16 kk + 15 of the tile).
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint32_t (&p16)[BK / 4],
                                             float (&m)[2], float (&alpha)[2],
                                             float (&rs)[2], int k0,
                                             int row_lo, int r0, int c0,
                                             const Args& a) {
  // Tiles with a masked key, and any scale <= 0, scale and mask each
  // logit; the others take the row max of the raw logits (scale > 0 keeps
  // the order) and fold the scale into the exponent's FFMA.
  const bool full = k0 + BK > a.len || (CAUSAL && k0 + BK - 1 > row_lo) ||
                    !(a.scale2 > 0.0f);
  float mx[2] = {NEG, NEG}, mul = a.scale2;
  if (full) {
    mul = 1.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[j * 4 + i * 2 + c] * a.scale2;
          const int key = k0 + 8 * j + c0 + c;
          if (key >= a.len || (CAUSAL && key > r0 + 8 * i)) x = NEG;
          sc[j * 4 + i * 2 + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(sc[j * 4 + i * 2], sc[j * 4 + i * 2 + 1]));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if (!full) mx[i] *= a.scale2;
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    rs[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = ex2(fmaf(sc[j * 4 + i * 2], mul, -m[i]));
      const float p1 = ex2(fmaf(sc[j * 4 + i * 2 + 1], mul, -m[i]));
      rs[i] += p0;
      rs[i] += p1;
      sc[j * 4 + i * 2] = p0;
      sc[j * 4 + i * 2 + 1] = p1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
  }
#pragma unroll
  for (int q = 0; q < BK / 4; ++q)
    p16[q] = pack_bf16(sc[2 * q], sc[2 * q + 1]);
}

template <int DH>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t sq,
                                        uint32_t kt, int cw) {
  using C = Cfg<DH>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = (kk * 16) / C::BOXC, off = ((kk * 16) % C::BOXC) * 2;
    const uint32_t qa = sq + box * C::Q_BOX + cw * 64 * C::ROWB + off;
    const uint32_t kb = kt + box * C::KV_BOX + off;
    Wg<BK>::ss(sc, desc(qa, 16, C::ATOM, C::SWZ),
               desc(kb, 16, C::ATOM, C::SWZ), kk > 0);
  }
  wg_commit();
}

template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&p16)[BK / 4],
                                         uint32_t vt) {
  using C = Cfg<DH>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t frag[4] = {p16[4 * kk], p16[4 * kk + 1], p16[4 * kk + 2],
                              p16[4 * kk + 3]};
    Wg<DH>::rs_t(o, frag,
                 desc(vt + kk * 16 * C::ROWB, C::KV_BOX, C::ATOM, C::SWZ));
  }
  wg_commit();
}

template <int DH>
__device__ __forceinline__ void rescale(float (&o)[DH / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[j * 4 + i * 2] *= alpha[i];
      o[j * 4 + i * 2 + 1] *= alpha[i];
    }
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + C::OFF_K, sv = base + C::OFF_V;
  const uint32_t bar = base + C::OFF_BAR;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / a.h, h = bh % a.h, hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int n_tiles = (a.len + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NBOX; ++c)
        tma_load4(sq + c * C::Q_BOX, &tq, c * C::BOXC, q0, h, b, q_full);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NBOX; ++c)
          tma_load4(sk + s * C::KV_BYTES + c * C::KV_BOX, &tk, c * C::BOXC,
                    t * BK, hk, b, k_full(s));
        mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NBOX; ++c)
          tma_load4(sv + s * C::KV_BYTES + c * C::KV_BOX, &tv, c * C::BOXC,
                    t * BK, hk, b, v_full(s));
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_lo = q0 + cw * 64;                // this warpgroup's rows
  const int r0 = row_lo + warp * 16 + lane / 4;   // this thread's: r0, r0 + 8
  const int c0 = 2 * (lane % 4);                  // first column of a pair

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, alpha[2], rs[2];
  float sc[BK / 2];
  uint32_t p16[BK / 4];

  mbar_wait(q_full, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(k_full(s), ph);
    issue_s<DH>(sc, sq, sk + s * C::KV_BYTES, cw);
    wg_wait<0>();
    fence_regs(sc);
    softmax_tile<CAUSAL>(sc, p16, m, alpha, rs, t * BK, row_lo, r0, c0, a);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
    rescale<DH>(o, alpha);
    mbar_wait(v_full(s), ph);
    fence_regs(o);
    issue_pv<DH>(o, p16, sv + s * C::KV_BYTES);
    wg_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }

  // epilogue: rows past L are not written
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) +
                      static_cast<int64_t>(bh) * a.len * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float den = fmaxf(__shfl_sync(0xffffffffu, l[i], lane & ~3), 1e-30f);
    if (row < a.len) {
      __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
            __floats2bfloat162_rn(o[j * 4 + i * 2] / den,
                                  o[j * 4 + i * 2 + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map (dh, L, heads, B) over bf16 with the element strides sl, sh, sb,
// boxes of (box_cols, box_rows, 1, 1), swizzled as the wgmma operands read
// them.  Returns 0 or a CUDA error code (driver errors offset by 10000).
int make_map(CUtensorMap* map, const void* ptr, int64_t dh, int64_t len,
             int64_t heads, int64_t batch, int64_t sl, int64_t sh, int64_t sb,
             int box_cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int DH, bool CAUSAL>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Args& a, int64_t bh_total,
           cudaStream_t stream) {
  constexpr int smem = Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DH, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh_total),
                  static_cast<unsigned>((a.len + BQ - 1) / BQ));
  flash_fwd_tc<DH, CAUSAL><<<grid, NT, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_causal(const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, const Args& a, int64_t bh_total,
                  bool causal, cudaStream_t s) {
  return causal ? launch<DH, true>(tq, tk, tv, a, bh_total, s)
                : launch<DH, false>(tq, tk, tv, a, bh_total, s);
}

}  // namespace fatc
}  // namespace sm90

// bf16 q (B, H, L, dh), k and v (B, Hkv, L, dh) with element strides over
// their B, H and L axes (multiples of 8: 16 bytes), dh contiguous and every
// base address 16-byte aligned (the wrapper checks); o (B, H, L, dh)
// contiguous bf16.  dh 32, 64 or 128; B H < 2^31, L <= 65535 * 128.
extern "C" int sm90_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t heads, int64_t kv_heads, int64_t len, int64_t dh, int64_t sqb,
    int64_t sqh, int64_t sql, int64_t skb, int64_t skh, int64_t skl,
    int64_t svb, int64_t svh, int64_t svl, int64_t causal, float scale,
    void* stream) {
  using namespace sm90::fatc;
  if ((dh != 32 && dh != 64 && dh != 128) || len < 1 ||
      (len + BQ - 1) / BQ > 65535 || batch * heads >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int box_cols = dh < 64 ? static_cast<int>(dh) : 64;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, dh, len, heads, batch, sql, sqh, sqb, box_cols,
                     BQ);
  if (err == 0)
    err = make_map(&tk, k, dh, len, kv_heads, batch, skl, skh, skb, box_cols,
                   BK);
  if (err == 0)
    err = make_map(&tv, v, dh, len, kv_heads, batch, svl, svh, svb, box_cols,
                   BK);
  if (err != 0) return err;
  const Args a{o, static_cast<int>(heads), static_cast<int>(heads / kv_heads),
               static_cast<int>(len),
               scale * 1.4426950408889634f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * heads;
  switch (dh) {
    case 32: return launch_causal<32>(tq, tk, tv, a, bh, causal != 0, s);
    case 64: return launch_causal<64>(tq, tk, tv, a, bh, causal != 0, s);
    default: return launch_causal<128>(tq, tk, tv, a, bh, causal != 0, s);
  }
}
