// Pairwise similarity blocks on Hopper.
//
// Replaces: src/repro/kernels/pairwise.py, pairwise_pallas (TPU).  It builds
// the similarity matrices the GreeDi fast engine caches: every shard's
// round-1 block s11 = sim(local, local) and the merge block
// s2 = sim(local, merged candidates) (src/repro/core/greedi.py:956, 996).
//
// out[b, i, j] = x[b, i] . y[b, j]                          (linear)
//              = exp(-max(|x|^2 - 2 x.y + |y|^2, 0) / h^2)  (rbf)
// f32 or bf16 inputs (widened to f32 on load, as the Pallas body's
// .astype(jnp.float32)), f32 output.
//
// Bound on this card: at d = 64 each output float costs 2 * 64 FLOP for
// 4 bytes written, 32 FLOP/B against the ~20 FLOP/B ridge of FP32 FFMA on an
// H100 SXM (67 TFLOP/s over 3.35 TB/s), so the kernel is bound by its FFMA
// work (s11: 8.2 ms), but writing the output alone takes 5.1 ms: the stores
// have to overlap the products.  Below d of about 40 the output's bytes
// bound it; at wider d the FFMAs do, more so the wider.  No tensor cores:
// the port keeps full FP32 (no TF32) until a later change brings a
// tensor-core mode with its own tolerance.
//
// Design (one persistent block of 256 threads a streaming multiprocessor,
// up to 255 registers a thread; every width and alignment on this kernel):
//   * Output tiles are 256 x-rows by 128 y-rows.  Work units are a 256-row
//     band of one batch entry with a range of its column tiles (the whole
//     row when there are enough bands to fill the card); block j takes
//     units j, j + grid, ... so the blocks working at one time share a
//     batch entry and its y tiles stay in L2.
//   * Operands load by TMA (cp.async.bulk.tensor, 128-byte swizzle, 3-D
//     maps (d, rows, batch) with a row pitch; an operand shared by the
//     batch, stride 0, gets a batch extent of 1 and coordinate 0).  Rows
//     past n and columns past d arrive as TMA's zero fill.  TMA needs
//     16-byte row pitches and bases: the wrapper (kernels/pairwise.py,
//     kernels/ring.py) hands other operands over as a padded copy.
//   * Two ring modes (ring.cuh; the wrapper picks by d, kernels/ring.py):
//     resident (d within 2 boxes of 128 bytes): the x band stays in shared
//     memory for a unit and thread 0 streams the y tiles through a 2-stage
//     ring; streamed (wider d): each stage of a 3-stage ring carries one
//     box of d of the x band and of the y tile, the accumulators carry
//     across the tile's boxes and the epilogue runs after its last.  A full
//     and an empty mbarrier a stage: each warp arrives on the empty one
//     after its products, and thread 0 refills the stage when all have, so
//     the next loads overlap this box's FFMAs and no block barrier sits in
//     the loop.
//   * The FFMA loop: warp w owns tile rows 32 w .. 32 w + 31; lane (h, tx)
//     of it owns 16 of them (8 (i / 4) + 4 h + i % 4) and the columns
//     tx + 16 j (8), a 16 x 8 register micro-tile fed by 24 shared loads of
//     4 k values per 512 FFMA.  The swizzle puts the 8 rows a quarter-warp
//     reads in 8 distinct bank groups, and the half-warps read rows 4
//     apart, so neither the operand reads nor the staging writes conflict.
//     The loop over the 4-value groups is not unrolled: its body stays
//     small enough for the instruction cache.
//   * Epilogue, per warp: its 32 x 64 half-rows at a time to its own two
//     staged 32 x 32 boxes, the rbf transform there (sm90.cuh: sim_of's
//     value without the division's slow path; the warp takes the norms of
//     its rows and the tile's columns from the staged operands, box by
//     box), then lane 0 issues the TMA stores (shared -> global, clipped at
//     nx and ny) and waits for them to have read the boxes
//     (cp.async.bulk.wait_group.read) only before writing them again.  No
//     block barrier: one warp's stores overlap the other warps' products.
//     Where ny is not a multiple of 4 (rows not 16-byte aligned) the warp
//     copies its boxes out with plain stores.
//   * The barriers and TMA loads, the swizzled box, the FFMA loop and the
//     walk over units are in ring.cuh, shared with facility.cu.
//   * Same bits as the first port (a 128 x 128 tile kernel, d staged in
//     chunks of 16): each output is one fmaf chain over k = 0 .. d-1 from
//     0.0f, the rbf norms likewise, in both modes; zero fill and a padded
//     copy's zero columns only add +0 terms.  No atomics: results are
//     bit-reproducible run to run.
#include <type_traits>

#include "ring.cuh"
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {
namespace pw {

using namespace ring;  // barriers, TMA, the swizzled box, box_fma, Walk

constexpr int TM = 128;            // tile columns (y rows); output halves
constexpr int TR = 16 * MI;        // tile rows (the x band)
constexpr int NTH = 256;           // threads a block
constexpr int BOX = TM * 128;      // bytes of a 128-row box, 128 bytes wide
constexpr int XBOX = TR * 128;     // bytes of an x-band box
constexpr int WROWS = TR / 8;      // rows a warp owns (and stores)
constexpr int WBOX = WROWS * 128;  // a warp's staged box: 32 rows x 32 f32
constexpr int OUT_BYTES = 8 * 2 * WBOX;  // each warp's 32 x 64 staging
constexpr int RES_STAGES = 2;      // y stages of the resident mode
constexpr int STR_STAGES = 3;      // (x box, y box) stages of the streamed
constexpr int NORM_BYTES = 8 * (WROWS + TM) * 4;  // rbf norms, per warp

// Dynamic shared memory of a launch: 1024 bytes of alignment slack, the
// staging, the ring (resident: the x band's nb boxes and RES_STAGES y
// stages of nb boxes; streamed: STR_STAGES stages of one x and one y box),
// the barriers (full and empty a stage, and the x band's pair) and the
// norms.  kernels/ring.py pairwise_smem is the same formula.
__host__ __device__ constexpr int smem_bytes(int nb, bool streamed) {
  return 1024 + OUT_BYTES +
         (streamed ? STR_STAGES * (XBOX + BOX)
                   : nb * (XBOX + RES_STAGES * BOX)) +
         8 * (2 + 2 * (streamed ? STR_STAGES : RES_STAGES)) + NORM_BYTES;
}
static_assert(smem_bytes(MAX_RES_BOXES, false) <= SMEM_MAX,
              "the resident mode's widest band does not fit");
static_assert(smem_bytes(1, true) <= SMEM_MAX,
              "the streamed ring does not fit");

struct Args {
  float* out;
  int64_t nx, ny, d, x_bs, y_bs;
  int64_t n_rb, n_ct, cpc, cpb, units;  // row bands, column tiles, tiles
                                        // a unit, units a band, units
  int nb;        // 128-byte boxes of d
  int tma_out;   // TMA stores (ny % 4 == 0)
  float hh;
};

template <typename T, bool RBF, bool STREAM>
__global__ void __launch_bounds__(NTH, 1)
    pairwise_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap omap, const Args a) {
  constexpr int ST = STREAM ? STR_STAGES : RES_STAGES;
  extern __shared__ __align__(16) char smem_raw[];
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  char* stg = sm;                     // OUT_BYTES: each warp's staging
  char* xs = sm + OUT_BYTES;          // resident: the x band (nb boxes);
                                      // streamed: ST stages of (x, y) box
  char* ys = xs + a.nb * XBOX;        // resident: y, ST stages of nb boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      STREAM ? xs + ST * (XBOX + BOX) : ys + ST * a.nb * BOX);
  float* norms = reinterpret_cast<float*>(bars + 2 + 2 * ST);  // 8 x 160
  const uint32_t xfull = smem_u32(bars), xempty = smem_u32(bars + 1);
  auto yfull = [&](int s) { return smem_u32(bars + 2 + s); };
  auto yempty = [&](int s) { return smem_u32(bars + 2 + ST + s); };

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, h = lane >> 4;
  constexpr int BC = 128 / sizeof(T);
  const uint32_t xbytes = static_cast<uint32_t>(a.nb) * XBOX;
  const uint32_t ybytes = static_cast<uint32_t>(a.nb) * BOX;
  const float rhh = __frcp_rn(a.hh);
  char* stw = stg + w * 2 * WBOX;           // this warp's two boxes
  float* xnw = norms + w * (WROWS + TM);    // its rows' |x|^2 (rbf)
  float* ynw = xnw + WROWS;                 // the tile's |y|^2 (rbf)

  auto load_x = [&](const Walk& t) {
    mbar_expect_tx(xfull, xbytes);
    for (int kb = 0; kb < a.nb; ++kb)
      tma_load3(smem_u32(xs + kb * XBOX), &xmap, kb * BC,
                static_cast<int>(t.rb * TR), a.x_bs ? static_cast<int>(t.b) : 0,
                xfull);
  };
  auto load_y = [&](const Walk& t, int s) {
    mbar_expect_tx(yfull(s), ybytes);
    for (int kb = 0; kb < a.nb; ++kb)
      tma_load3(smem_u32(ys + (s * a.nb + kb) * BOX), &ymap, kb * BC,
                static_cast<int>(t.ct * TM), a.y_bs ? static_cast<int>(t.b) : 0,
                yfull(s));
  };
  // streamed: box kb of tile t's x band and y tile into stage s
  auto load_box = [&](const Walk& t, int kb, int s) {
    char* st = xs + s * (XBOX + BOX);
    mbar_expect_tx(yfull(s), XBOX + BOX);
    tma_load3(smem_u32(st), &xmap, kb * BC, static_cast<int>(t.rb * TR),
              a.x_bs ? static_cast<int>(t.b) : 0, yfull(s));
    tma_load3(smem_u32(st + XBOX), &ymap, kb * BC,
              static_cast<int>(t.ct * TM), a.y_bs ? static_cast<int>(t.b) : 0,
              yfull(s));
  };

  Walk cur;
  cur.start(blockIdx.x, a);
  // thread 0's loads: resident, tiles n + 1 and n + 2; streamed, ahead1 and
  // box fkb of it are the next (tile, box) to load
  Walk ahead1 = cur, ahead2 = cur;
  int fkb = 0;
  if (tid == 0) {
    mbar_init(xfull, 1);
    mbar_init(xempty, NTH / 32);  // one arrival a warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(yfull(s), 1);
      mbar_init(yempty(s), NTH / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (STREAM) {
      for (int s = 0; s < ST && ahead1.valid; ++s) {
        load_box(ahead1, fkb, s);
        if (++fkb == a.nb) {
          fkb = 0;
          ahead1.next(a);
        }
      }
    } else if (cur.valid) {
      load_x(cur);
      load_y(cur, 0);
      ahead1.next(a);
      if (ahead1.valid) load_y(ahead1, 1);
      ahead2 = ahead1;
      ahead2.next(a);
    }
  }
  __syncthreads();

  int64_t n = 0;      // tiles done by this block
  uint32_t xi = 0;    // x bands loaded before this tile's (resident)
  Slot q{0, 0};       // the ring position (streamed)
  for (; cur.valid; ++n) {
    const int64_t row0 = cur.rb * TR, col0 = cur.ct * TM, tb = cur.b;
    float acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    // rbf: lane l keeps the chain of its warp's row l, and each lane those
    // of its 8 columns
    float xs2 = 0.0f, y2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y2[j] = 0.0f;
    if constexpr (STREAM) {
      for (int kb = 0; kb < a.nb; ++kb) {
        mbar_wait(yfull(q.s), q.ph);
        const char* xb = xs + q.s * (XBOX + BOX);
        if (RBF)
          xs2 = row_norm<T>(xb, WROWS * w + lane,
                            static_cast<int>(min64(BC, a.d - int64_t{kb} * BC)),
                            xs2);
        box_fma<T, RBF>(xb + (WROWS * w + 4 * h) * 128, xb + XBOX,
                        groups_of(a.d, kb, BC), h, tx, acc, y2);
        // this warp is done with the stage; thread 0 refills it once every
        // warp is
        __syncwarp();
        if (lane == 0) mbar_arrive(yempty(q.s));
        if (tid == 0) {
          mbar_wait(yempty(q.s), q.ph);
          if (ahead1.valid) {
            load_box(ahead1, fkb, q.s);
            if (++fkb == a.nb) {
              fkb = 0;
              ahead1.next(a);
            }
          }
        }
        q.next(ST);
      }
      cur.next(a);
    } else {
      const int s = static_cast<int>(n & 1);
      if (cur.fresh && n > 0) ++xi;
      mbar_wait(xfull, xi & 1);
      mbar_wait(yfull(s), static_cast<uint32_t>((n >> 1) & 1));
      for (int kb = 0; kb < a.nb; ++kb) {
        const char* xb = xs + kb * XBOX;
        const char* yb = ys + (s * a.nb + kb) * BOX;
        if (RBF)
          xs2 = row_norm<T>(xb, WROWS * w + lane,
                            static_cast<int>(min64(BC, a.d - int64_t{kb} * BC)),
                            xs2);
        box_fma<T, RBF>(xb + (WROWS * w + 4 * h) * 128, yb,
                        groups_of(a.d, kb, BC), h, tx, acc, y2);
      }
      cur.next(a);  // the next tile: a fresh one needs a new x band
      // this warp is done with the y stage (and, before a new unit, the x
      // band); thread 0 refills them once every warp is
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(yempty(s));
        if (cur.valid && cur.fresh) mbar_arrive(xempty);
      }
      if (tid == 0) {
        mbar_wait(yempty(s), static_cast<uint32_t>((n >> 1) & 1));
        if (ahead2.valid) load_y(ahead2, s);
        if (ahead1.valid && ahead1.fresh) {
          mbar_wait(xempty, xi & 1);
          load_x(ahead1);
        }
        ahead1 = ahead2;
        ahead2.next(a);
      }
    }
    if (RBF) {
      xnw[lane] = xs2;
      if (h == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ynw[tx + 16 * j] = y2[j];
      }
    }

    // epilogue, this warp's 32 rows x 64 columns at a time through its own
    // two staged boxes: no block barrier, so one warp's stores overlap the
    // others' products; lane 0 waits for its last stores to have read the
    // boxes before they are written again
    const int64_t wrow = row0 + WROWS * w;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = row_in_warp(i, h);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;  // column within the 64
          *reinterpret_cast<float*>(stw + (c >> 5) * WBOX +
                                    swz(r, (c & 31) * 4)) =
              acc[i][4 * k + j];
        }
      }
      if (RBF) {  // the transform of this thread's 64 values from shared
                  // memory, 4 at a time: no accumulator is live across it,
                  // and the straight-line epilogue stays small
        __syncwarp();
        const float* yq = ynw + 64 * k;
#pragma unroll 4
        for (int e = 0; e < 64; ++e) {
          const int r = row_in_warp(e >> 2, h), c = tx + 16 * (e & 3);
          float* pv = reinterpret_cast<float*>(stw + (c >> 5) * WBOX +
                                               swz(r, (c & 31) * 4));
          *pv = sim_rn(*pv, xnw[r], yq[c], a.hh, rhh);
        }
      }
      const int64_t kcol = col0 + 64 * k;
      if (a.tma_out) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          if (wrow < a.nx) {
            for (int bx = 0; bx < 2; ++bx) {
              if (kcol + 32 * bx >= a.ny) break;
              tma_store3(&omap, smem_u32(stw + bx * WBOX),
                         static_cast<int>(kcol + 32 * bx),
                         static_cast<int>(wrow), static_cast<int>(tb));
            }
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
        __syncwarp();
        float* ob = a.out + tb * a.nx * a.ny;
        for (int idx = lane; idx < WROWS * 64; idx += 32) {
          const int r = idx / 64, c = idx % 64;
          if (wrow + r < a.nx && kcol + c < a.ny)
            ob[(wrow + r) * a.ny + kcol + c] = *reinterpret_cast<const float*>(
                stw + (c >> 5) * WBOX + swz(r, (c & 31) * 4));
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host side: the launch
// ---------------------------------------------------------------------------

template <typename T, bool RBF, bool STREAM>
int launch(const CUtensorMap& xm, const CUtensorMap& ym,
           const CUtensorMap& om, const Args& a, int grid,
           cudaStream_t stream) {
  const int smem = smem_bytes(a.nb, STREAM);
  auto kern = pairwise_kernel<T, RBF, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NTH, smem, stream>>>(xm, ym, om, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RBF>
int launch_mode(const CUtensorMap& xm, const CUtensorMap& ym,
                const CUtensorMap& om, const Args& a, int grid,
                bool streamed, cudaStream_t stream) {
  return streamed ? launch<T, RBF, true>(xm, ym, om, a, grid, stream)
                  : launch<T, RBF, false>(xm, ym, om, a, grid, stream);
}

}  // namespace pw
}  // namespace sm90

// x: (batch, nx, d) with rows x_ld elements apart and batch stride x_bs
// elements (0 = shared); y likewise; out: (batch, nx, ny) float32,
// contiguous.  bf16 != 0 selects bfloat16 inputs, rbf != 0 the rbf
// similarity with hh = h * h, streamed != 0 the streamed ring (resident
// takes d within 2 boxes of 128 bytes).  The bases, the pitches and the
// batch strides in bytes must be multiples of 16 (TMA's rule; the wrapper
// copies other operands); nx, ny, batch < 2^31.  Returns the launch's
// cudaGetLastError(), a tensor-map error (driver errors offset by 10000),
// or cudaErrorInvalidValue for operands it does not take.
extern "C" int sm90_pairwise(const void* x, const void* y, void* out,
                             int64_t batch, int64_t nx, int64_t ny, int64_t d,
                             int64_t x_ld, int64_t y_ld, int64_t x_bs,
                             int64_t y_bs, int64_t bf16, int64_t rbf,
                             float hh, int64_t streamed, void* stream) {
  using namespace sm90;
  using namespace sm90::pw;
  if (batch < 1 || nx < 1 || ny < 1 || d < 1 || nx >= (int64_t{1} << 31) ||
      ny >= (int64_t{1} << 31) || batch >= (int64_t{1} << 31) || x_ld < d ||
      y_ld < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esz = bf16 ? 2 : 4;
  const int bc = 128 / esz;  // elements of d a 128-byte box
  Args a{};
  a.out = static_cast<float*>(out);
  a.nx = nx;
  a.ny = ny;
  a.d = d;
  a.x_bs = x_bs;
  a.y_bs = y_bs;
  a.hh = hh;
  a.nb = static_cast<int>(cdiv(d, bc));
  if (!streamed && a.nb > MAX_RES_BOXES)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tma_out = (ny % 4) == 0 && aligned16(out);

  // units: a band of 256 rows with cpc of its column tiles; split a band's
  // columns only when the bands alone do not fill the card
  const int nsm = sm_count();
  a.n_rb = cdiv(nx, TR);
  a.n_ct = cdiv(ny, TM);
  const int64_t bands = batch * a.n_rb;
  int64_t cpb = bands >= nsm ? 1 : cdiv(nsm, bands);
  if (cpb > a.n_ct) cpb = a.n_ct;
  a.cpc = cdiv(a.n_ct, cpb);
  a.cpb = cdiv(a.n_ct, a.cpc);
  a.units = bands * a.cpb;
  const int grid = static_cast<int>(a.units < nsm ? a.units : nsm);

  CUtensorMap xm{}, ym{}, om{};
  const CUtensorMapDataType type = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = make_map(&xm, type, esz, x, d, nx, x_bs ? batch : 1, x_ld,
                     x_bs ? x_bs : nx * x_ld, bc, TR);
  if (err == 0)
    err = make_map(&ym, type, esz, y, d, ny, y_bs ? batch : 1, y_ld,
                   y_bs ? y_bs : ny * y_ld, bc, TM);
  if (err == 0 && a.tma_out)
    err = make_map(&om, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, ny, nx, batch,
                   ny, nx * ny, 32, WROWS);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return rbf ? launch_mode<__nv_bfloat16, true>(xm, ym, om, a, grid,
                                                  streamed, s)
               : launch_mode<__nv_bfloat16, false>(xm, ym, om, a, grid,
                                                   streamed, s);
  return rbf ? launch_mode<float, true>(xm, ym, om, a, grid, streamed, s)
             : launch_mode<float, false>(xm, ym, om, a, grid, streamed, s);
}

// The dynamic shared memory a launch with nb boxes of d takes in either
// mode (host only; the tests hold kernels/ring.py's formula to it).
extern "C" int sm90_pairwise_smem(int64_t nb, int64_t streamed) {
  return sm90::pw::smem_bytes(static_cast<int>(nb), streamed != 0);
}

namespace sm90 {
namespace pw {

// The check behind sm90.cuh sim_rn: over every non-negative finite float d2
// (x2 = d2, dot = y2 = 0, so both functions see d2 itself), block b writes
// to counts[b] how many d2 give a result that differs in any bit from
// tile.cuh sim_of<true> at width hh.
__global__ void __launch_bounds__(NTH) sim_check(float hh, int* counts) {
  __shared__ int per_warp[NTH / 32];
  const float rhh = __frcp_rn(hh);
  const uint32_t stride = gridDim.x * blockDim.x;
  int n = 0;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < 0x7f800000u;
       b += stride) {
    const float d2 = __uint_as_float(b);
    n += __float_as_uint(sim_rn(0.0f, d2, 0.0f, hh, rhh)) !=
         __float_as_uint(sim_of<true>(0.0f, d2, 0.0f, hh));
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) per_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < NTH / 32; ++w) s += per_warp[w];
    counts[blockIdx.x] = s;
  }
}

}  // namespace pw
}  // namespace sm90

// counts: `blocks` int32 entries; their sum is the number of d2 at which
// sim_rn and sim_of differ at width hh (sm90::pw::sim_check).
extern "C" int sm90_sim_mismatches(float hh, void* counts, int64_t blocks,
                                   void* stream) {
  if (blocks < 1 || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  sm90::pw::sim_check<<<static_cast<unsigned>(blocks), sm90::pw::NTH, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      hh, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
