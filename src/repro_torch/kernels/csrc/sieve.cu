// Threshold-sieve admission scan over one append chunk, on Hopper.
//
// Replaces the sequential part of the reference's sieve_update
// (src/repro/kernels/ops.py:365, the lax.scan at :406-434), which has no
// Pallas kernel: XLA runs the scan one row at a time.  The similarity work
// is hoisted out of it, as in the reference, into two pairwise sweeps the
// wrapper makes with csrc/pairwise.cu: s_pre, the chunk against each
// touched shard's standing members (S, ab, T*k), and s_intra, the chunk
// against itself (ab, ab).  What is left is sequential in the rows and
// independent in the buckets.  For shard s and bucket t, rows i = 0..ab-1
// in order:
//
//   red   = max over the bucket's live slots of the member's redundancy:
//           linear  max(sim, 0) / sqrt(rsq[i] * msq)
//           rbf     sim
//           where sim is s_pre[s, i, t*k + slot] for a standing member and
//           s_intra[i, src] for a member admitted earlier in this chunk
//           from row src (whose msq is rsq[src]);
//   score = gains[i] * max(1 - red, 0);
//   admit iff active[s, i] && rgids[i] >= 0 && cnt < k && score >= tau[t],
//           writing gid, score and src = i into slot cnt.
//
// Exact by construction: max is exact and order-free and nothing is
// accumulated, so the state equals the plain version (kernels/ref.py
// sieve_scan_ref) bit for bit.  The quotient and the square root are the
// IEEE ones (no fast-math flag, no rsqrtf, no reciprocal), and the square
// root is taken of the product, as the reference does.
//
// Design: one warp a (shard, bucket), grid S * T.  The bucket's slot state
// (src, and msq for the linear kernel) sits in shared memory, its count in
// a register; slot j's redundancy is computed by lane j % 32 and the max
// taken by a butterfly of shuffles, so every lane holds the same red and
// the admission is warp-uniform.  Each slot is written by its own block
// and the count only grows: no atomics.  Rows are taken 32 at a time: each
// lane tests one row for being a candidate at all (active, a real gid, and
// gains >= tau, since with tau > 0 a row below it cannot reach it: the
// factor max(1 - red, 0) is in [0, 1]), and a ballot hands the warp the
// candidates in order, so rows that cannot be admitted cost no dependent
// step.  A block whose bucket is full stops.
//
// Bound: per chunk at the service's full size (S <= 2 touched shards, ab =
// 1024, T = 13, k = 64) s_pre is 6.8 MB and s_intra 4 MB, both resident in
// L2 after the sweeps that wrote them: about 3 us of bytes at 3.35 TB/s.
// The scan is latency-bound instead: up to ab dependent warp steps (an L2
// read, five shuffles, a compare), the rows a bucket admits or weighs
// before it fills.
#include "sm90.cuh"
#include "tile.cuh"

namespace sm90 {

constexpr int SV_NT = 32;  // one warp a (shard, bucket)

struct SVArgs {
  const float* s_pre;     // (S, ab, T*k)
  const float* s_intra;   // (ab, ab)
  const float* rsq;       // (ab,), linear only
  const float* msq_pre;   // (S, T, k), linear only
  const float* gains;     // (ab,)
  const int64_t* rgids;   // (ab,)
  const uint8_t* active;  // (S, ab)
  const float* tau;       // (T,)
  int64_t* gid;           // (S, T, k) in / out
  float* gain;            // (S, T, k) in / out
  int64_t* src;           // (S, T, k) out: the chunk row admitted, or -1
  int64_t* cnt;           // (S, T) in / out
  int64_t ab, T, k;
};

template <bool LINEAR>
__global__ void __launch_bounds__(SV_NT) sieve_scan(const SVArgs a) {
  extern __shared__ unsigned char smem[];
  int* ssrc = reinterpret_cast<int*>(smem);                 // k slots
  float* smsq = reinterpret_cast<float*>(smem + 4 * a.k);   // k slots
  const int lane = threadIdx.x;
  const int64_t sh = blockIdx.x / a.T;
  const int64_t t = blockIdx.x % a.T;
  const int64_t bucket = sh * a.T + t;
  const int64_t k = a.k;
  int64_t cnt = a.cnt[bucket];
  const int64_t cnt0 = cnt;
  for (int64_t j = lane; j < k; j += SV_NT) {
    ssrc[j] = -1;
    if (LINEAR && j < cnt0) smsq[j] = a.msq_pre[bucket * k + j];
  }
  __syncwarp();
  const float tau = a.tau[t];
  const float* pre = a.s_pre + sh * a.ab * a.T * k + t * k;
  const uint8_t* act = a.active + sh * a.ab;
  for (int64_t base = 0; base < a.ab && cnt < k; base += SV_NT) {
    const int64_t r = base + lane;
    bool cand = false;
    if (r < a.ab) {
      const float g = a.gains[r];
      cand = act[r] != 0 && a.rgids[r] >= 0 && !(tau > 0.0f && !(g >= tau));
    }
    unsigned todo = __ballot_sync(0xffffffffu, cand);
    while (todo != 0u && cnt < k) {
      const int bit = __ffs(static_cast<int>(todo)) - 1;
      todo &= todo - 1u;
      const int64_t i = base + bit;
      const float rsq_i = LINEAR ? a.rsq[i] : 0.0f;
      const float* pre_i = pre + i * a.T * k;
      const float* intra_i = a.s_intra + i * a.ab;
      float red = 0.0f;
      for (int64_t j = lane; j < cnt; j += SV_NT) {
        const int s = ssrc[j];
        const float sim = s >= 0 ? intra_i[s] : pre_i[j];
        if (LINEAR) {
          red = fmaxf(red, fmaxf(sim, 0.0f) / sqrtf(rsq_i * smsq[j]));
        } else {
          red = fmaxf(red, sim);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        red = fmaxf(red, __shfl_xor_sync(0xffffffffu, red, off));
      const float score = a.gains[i] * fmaxf(1.0f - red, 0.0f);
      if (score >= tau) {
        if (lane == 0) {
          a.gid[bucket * k + cnt] = a.rgids[i];
          a.gain[bucket * k + cnt] = score;
          ssrc[cnt] = static_cast<int>(i);
          if (LINEAR) smsq[cnt] = rsq_i;
        }
        ++cnt;
        __syncwarp();
      }
    }
  }
  for (int64_t j = lane; j < k; j += SV_NT) a.src[bucket * k + j] = ssrc[j];
  if (lane == 0) a.cnt[bucket] = cnt;
}

}  // namespace sm90

// The scan over S shards' T buckets of k slots each.  gid, gain and cnt
// hold the state on entry and are updated in place; src is written whole.
// rsq and msq_pre are read only for the linear kernel (NULL for rbf).  All
// tensors contiguous; active is one byte a row (0 / 1).
extern "C" int sm90_sieve_scan(const void* s_pre, const void* s_intra,
                               const void* rsq, const void* msq_pre,
                               const void* gains, const void* rgids,
                               const void* active, const void* tau, void* gid,
                               void* gain, void* src, void* cnt, int64_t S,
                               int64_t ab, int64_t T, int64_t k,
                               int64_t linear, void* stream) {
  using namespace sm90;
  if (S < 1 || T < 1 || k < 1) return 0;
  if (ab >= (int64_t{1} << 31) || k > 4096 || S * T > (int64_t{1} << 31) - 1)
    return cudaErrorInvalidValue;
  SVArgs a{};
  a.s_pre = static_cast<const float*>(s_pre);
  a.s_intra = static_cast<const float*>(s_intra);
  a.rsq = static_cast<const float*>(rsq);
  a.msq_pre = static_cast<const float*>(msq_pre);
  a.gains = static_cast<const float*>(gains);
  a.rgids = static_cast<const int64_t*>(rgids);
  a.active = static_cast<const uint8_t*>(active);
  a.tau = static_cast<const float*>(tau);
  a.gid = static_cast<int64_t*>(gid);
  a.gain = static_cast<float*>(gain);
  a.src = static_cast<int64_t*>(src);
  a.cnt = static_cast<int64_t*>(cnt);
  a.ab = ab;
  a.T = T;
  a.k = k;
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(8 * k);
  const unsigned grid = static_cast<unsigned>(S * T);
  if (linear) {
    if (a.rsq == nullptr || a.msq_pre == nullptr) return cudaErrorInvalidValue;
    sieve_scan<true><<<grid, SV_NT, smem, st>>>(a);
  } else {
    sieve_scan<false><<<grid, SV_NT, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
