"""Plain PyTorch versions of the ported kernels (the port of kernels/ref.py).

These are the semantics every CUDA kernel in this package must reproduce.
The wrappers use them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the kernels against them on the card.  Every function
takes an optional leading batch axis; a 2-D operand next to a batched one is
shared by every batch entry.
"""
from __future__ import annotations

import torch

NEG = -1e30  # masked-gain floor shared with the select kernels / greedy loops


def masked_top1(scores: torch.Tensor, ok: torch.Tensor, floor: float = NEG):
  """Lowest-index argmax of the masked scores over the last axis.

  Returns (best masked score float32, int64 index), each with the leading
  axes of ``scores``.  With no feasible entry the result is (floor, 0).
  Written as a max followed by the least index attaining it, so ties never
  depend on ``torch.argmax``'s tie rule.
  """
  masked = torch.where(ok.bool(), scores.float(), floor)
  best = masked.max(dim=-1).values
  n = masked.shape[-1]
  iota = torch.arange(n, device=scores.device).expand_as(masked)
  idx = torch.where(masked == best.unsqueeze(-1), iota,
                    torch.full_like(iota, n)).min(dim=-1).values
  return best, idx


def _dot(ev: torch.Tensor, cd: torch.Tensor) -> torch.Tensor:
  """ev (..., ne, d) against cd (..., nc, d) -> (..., ne, nc)."""
  return ev @ cd.transpose(-1, -2)


def _sim(ev: torch.Tensor, cd: torch.Tensor, kernel: str,
         h: float) -> torch.Tensor:
  if kernel == "linear":
    return _dot(ev, cd)
  if kernel == "rbf":
    e2 = torch.sum(ev * ev, dim=-1, keepdim=True)
    c2 = torch.sum(cd * cd, dim=-1, keepdim=True)
    d2 = torch.clamp_min(e2 - 2.0 * _dot(ev, cd) + c2.transpose(-1, -2), 0.0)
    return torch.exp(-d2 / (h * h))
  raise ValueError(kernel)


def pairwise_ref(x: torch.Tensor, y: torch.Tensor, *, kernel: str = "rbf",
                 h: float = 0.75) -> torch.Tensor:
  """Full similarity matrix (..., nx, ny) float32."""
  return _sim(x.float(), y.float(), kernel, h)


def facility_gain_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                      cov: torch.Tensor, eval_mask: torch.Tensor, *,
                      kernel: str = "linear", h: float = 0.75) -> torch.Tensor:
  """Unnormalized marginal coverage gains (..., nc) float32.

  gain[j] = sum_i mask_i * max(sim(e_i, c_j) - cov_i, 0)
  """
  sim = _sim(eval_feats.float(), cand_feats.float(), kernel, h)
  inc = torch.clamp_min(sim - cov.float().unsqueeze(-1), 0.0)
  return (eval_mask.float().unsqueeze(-2) @ inc).squeeze(-2)


def coverage_gain_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                      cover: torch.Tensor, cap: torch.Tensor,
                      eval_mask: torch.Tensor, *, kernel: str = "linear",
                      h: float = 0.75) -> torch.Tensor:
  """Unnormalized saturated-coverage gains (Lin & Bilmes), (..., nc)
  float32:

    gain[j] = sum_i mask_i * [min(cover_i + s_ij, cap_i) - min(cover_i, cap_i)]

  with s_ij = max(sim(e_i, c_j), 0).
  """
  sim = torch.clamp_min(_sim(eval_feats.float(), cand_feats.float(), kernel,
                             h), 0.0)
  cover = cover.float().unsqueeze(-1)
  cap = cap.float().unsqueeze(-1)
  inc = torch.minimum(cover + sim, cap) - torch.minimum(cover, cap)
  return (eval_mask.float().unsqueeze(-2) @ inc).squeeze(-2)


# rows of a chunk of the relu column sums: a multiple of 256 that keeps
# the chunks at most 64, so a pass's partial sums stay small beside s
COLSUM_CHUNK = 256
COLSUM_MAX_CHUNKS = 64


def colsum_chunk_rows(nl: int) -> int:
  """Rows a chunk of ``relu_colsum_ref`` and of ``csrc/colsum.cu`` sums at
  nl eval rows: a function of nl alone, so a column's order of additions
  never depends on which columns a call takes."""
  span = COLSUM_CHUNK * COLSUM_MAX_CHUNKS
  return COLSUM_CHUNK * max(1, -(-nl // span))


def relu_colsum_ref(s: torch.Tensor, cov: torch.Tensor,
                    cols: torch.Tensor | None = None) -> torch.Tensor:
  """Masked relu column sums of a cached similarity block, (m, t) float32:

    out[b, c] = sum_i relu(s[b, i, col(b, c)] - cov[b, i])

  with col(b, c) = c over all nc columns of s (m, nl, nc), or cols[b, c]
  for an (m, t) int64 ``cols``; cov is (m, nl).  The additions run in the
  kernel's fixed order: chunks of ``colsum_chunk_rows(nl)`` rows, each
  summed in ascending row order from +0, then the chunks' sums in
  ascending order from +0.  Every step is an elementwise IEEE operation,
  so a column's sum has the same bits in a full pass, in any gathered
  call, on the CPU and in the kernel.
  """
  s = s.float()
  if cols is not None:
    s = torch.stack([s[b].index_select(1, cols[b])
                     for b in range(s.shape[0])])
  m, nl, nc = s.shape
  cov = cov.float()
  ch = colsum_chunk_rows(nl)
  full = nl // ch
  out = torch.zeros((m, nc), dtype=torch.float32, device=s.device)
  tmp = torch.empty((m, max(full, 1), nc), dtype=torch.float32,
                    device=s.device)
  if full:  # every full chunk at once, one row offset a step
    sv = s[:, :full * ch].unflatten(1, (full, ch))
    cv = cov[:, :full * ch].unflatten(1, (full, ch))
    acc = torch.zeros((m, full, nc), dtype=torch.float32, device=s.device)
    for i in range(ch):
      torch.sub(sv[:, :, i], cv[:, :, i, None], out=tmp)
      acc.add_(tmp.clamp_min_(0.0))
    for k in range(full):
      out.add_(acc[:, k])
  if full * ch < nl:  # the ragged last chunk
    acc = torch.zeros((m, nc), dtype=torch.float32, device=s.device)
    t1 = tmp[:, 0]
    for r in range(full * ch, nl):
      torch.sub(s[:, r], cov[:, r, None], out=t1)
      acc.add_(t1.clamp_min_(0.0))
    out.add_(acc)
  return out


def live_linv(linv: torch.Tensor, live) -> torch.Tensor:
  """The live-count contract of the info-gain kernels made explicit:
  ``tril(linv)`` with the rows and columns at or past ``live`` zeroed
  (``live`` () or with linv's leading axes)."""
  k = linv.shape[-1]
  ar = torch.arange(k, device=linv.device)
  live = torch.as_tensor(live, device=linv.device)
  on = ar < live.unsqueeze(-1)                          # (..., k)
  keep = on.unsqueeze(-1) & on.unsqueeze(-2) & (ar[:, None] >= ar[None, :])
  return torch.where(keep, linv, 0.0)


def info_gain_cond_ref(sel_feats: torch.Tensor, linv: torch.Tensor,
                       cand_feats: torch.Tensor, *, kernel: str = "rbf",
                       h: float = 0.75, ridge: float = 1.0,
                       live=None) -> torch.Tensor:
  """Posterior conditional variance of each candidate given the selected
  set, (..., nc) float32:

    cond[j] = k(v_j, v_j) + ridge - || linv @ k(S, v_j) ||^2, clamped at 1e-12

  with k(v, v) = 1 for rbf and |v|^2 for linear.  ``linv`` is inv(L) for
  L = chol(K_SS + ridge I) with the columns past the live selection count
  zeroed, so padded selection rows contribute nothing.  With ``live`` (the
  selection counts) the product uses ``live_linv(linv, live)``, the
  contract the kernel takes with it; without, linv as it is.
  """
  sel = sel_feats.float()
  cd = cand_feats.float()
  lv = linv.float() if live is None else live_linv(linv.float(), live)
  c = lv @ _sim(sel, cd, kernel, h)                      # (..., k, nc)
  if kernel == "rbf":
    k_vv = torch.ones(cd.shape[:-1], dtype=torch.float32, device=cd.device)
  else:
    k_vv = torch.sum(cd * cd, dim=-1)
  cond = k_vv + ridge - torch.sum(c * c, dim=-2)
  return torch.clamp_min(cond, 1e-12)


def graph_cut_cols(in_s: torch.Tensor,
                   ind: torch.Tensor | None = None) -> torch.Tensor:
  """The column vectors of the graph-cut product, c = ind * (1 - 2x),
  (..., n) float32.  ``in_s`` is the indicator x of S; ``ind`` the node
  indicator of a partition's induced subgraph (None: the whole graph)."""
  c = 1.0 - 2.0 * in_s.float()
  return c if ind is None else c * ind.float()


def graph_cut_gain_ref(w: torch.Tensor, in_s: torch.Tensor,
                       ind: torch.Tensor | None = None) -> torch.Tensor:
  """Per-node cut gains deg_v - 2 (W x)_v == (W (1 - 2x))_v, (..., n)
  float32, one row per selection vector over the shared (n, n) W.

  With ``ind`` the column vector is ind * (1 - 2x): on every node of the
  partition this is the gain in the subgraph the partition induces,
  (W * ind ind^T)(1 - 2x), without the masked copy of W.
  """
  return graph_cut_cols(in_s, ind) @ w.float().T


def facility_select_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                        cov: torch.Tensor, eval_mask: torch.Tensor,
                        cand_ok: torch.Tensor, *, kernel: str = "linear",
                        h: float = 0.75):
  gains = facility_gain_ref(eval_feats, cand_feats, cov, eval_mask,
                            kernel=kernel, h=h)
  return masked_top1(gains, cand_ok)


def coverage_select_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                        cover: torch.Tensor, cap: torch.Tensor,
                        eval_mask: torch.Tensor, cand_ok: torch.Tensor, *,
                        kernel: str = "linear", h: float = 0.75):
  gains = coverage_gain_ref(eval_feats, cand_feats, cover, cap, eval_mask,
                            kernel=kernel, h=h)
  return masked_top1(gains, cand_ok)


def info_select_ref(sel_feats: torch.Tensor, linv: torch.Tensor,
                    cand_feats: torch.Tensor, cand_ok: torch.Tensor, *,
                    kernel: str = "rbf", h: float = 0.75, ridge: float = 1.0,
                    live=None):
  """Top-1 over the conditional variances -> (best cond float32, int64
  index).  cond >= 1e-12, so the 0.0 floor of infeasible candidates keeps
  any feasible one ahead; nothing feasible gives (0.0, 0).  The caller maps
  the winning cond through its log, which preserves the order."""
  cond = info_gain_cond_ref(sel_feats, linv, cand_feats, kernel=kernel, h=h,
                            ridge=ridge, live=live)
  return masked_top1(cond, cand_ok, floor=0.0)


def graph_cut_select_ref(w: torch.Tensor, in_s: torch.Tensor,
                         node_ok: torch.Tensor,
                         ind: torch.Tensor | None = None):
  """Top-1 node cut gain over ``node_ok`` -> (best float32, int64 node),
  (NEG, 0) when no node is feasible."""
  return masked_top1(graph_cut_gain_ref(w, in_s, ind), node_ok)


# ---------------------------------------------------------------------------
# threshold-sieve admission: the streaming select-on-append oracle of the
# selection service's standing sieves
# ---------------------------------------------------------------------------


def sieve_redundancy_ref(v: torch.Tensor, members: torch.Tensor,
                         live: torch.Tensor, *, kernel: str = "linear",
                         h: float = 0.75) -> torch.Tensor:
  """Normalized redundancy of item ``v`` (d,) against each sieve bucket,
  (T,) in [0, 1]: the max over the live members of the (T, k, d)
  ``members`` (``live`` (T, k) bool) of ``relu(sim(v, s)) / sqrt(sim(v, v)
  * sim(s, s))`` (rbf: sim itself, since sim(v, v) = 1).  Empty buckets
  score 0."""
  t, k, d = members.shape
  sim = _sim(v[None].float(), members.reshape(t * k, d).float(), kernel,
             h)[0].reshape(t, k)
  if kernel == "linear":
    vsq = torch.clamp_min(torch.sum(v.float() ** 2), 1e-12)
    msq = torch.clamp_min(torch.sum(members.float() ** 2, dim=-1), 1e-12)
    red = torch.clamp_min(sim, 0.0) / torch.sqrt(vsq * msq)
  else:
    red = sim
  return torch.where(live, red, 0.0).amax(dim=1)


def sieve_admit_ref(v: torch.Tensor, gain, gid, active, tau: torch.Tensor,
                    sieve_gid: torch.Tensor, sieve_gain: torch.Tensor,
                    sieve_feat: torch.Tensor, sieve_count: torch.Tensor, *,
                    kernel: str = "linear", h: float = 0.75):
  """ONE streaming admission step, the per-item semantics the chunk scan
  replays row by row: item ``v`` (d,) with standing singleton gain
  ``gain`` and id ``gid`` scores ``gain * relu(1 - redundancy)`` against
  each bucket, and bucket t admits it into slot ``count_t`` iff
  ``active``, the score reaches ``tau[t]``, the bucket has room and gid >=
  0.  Returns the updated (sieve_gid, sieve_gain, sieve_feat,
  sieve_count)."""
  t, k = sieve_gid.shape
  dev = sieve_gid.device
  live = torch.arange(k, device=dev)[None, :] < sieve_count[:, None]
  red = sieve_redundancy_ref(v, sieve_feat, live, kernel=kernel, h=h)
  score = torch.as_tensor(gain, dtype=torch.float32, device=dev) * (
      torch.clamp_min(1.0 - red, 0.0))
  gid = torch.as_tensor(gid, device=dev)
  admit = (torch.as_tensor(active, device=dev) & (score >= tau)
           & (sieve_count < k) & (gid >= 0))
  at = (torch.arange(k, device=dev)[None, :] == sieve_count[:, None]) & (
      admit[:, None])
  return (torch.where(at, gid.to(sieve_gid.dtype), sieve_gid),
          torch.where(at, score[:, None], sieve_gain),
          torch.where(at[..., None], v.float()[None, None, :], sieve_feat),
          sieve_count + admit.to(sieve_count.dtype))


def sieve_scan_ref(s_pre: torch.Tensor, s_intra: torch.Tensor,
                   rsq: torch.Tensor | None, msq_pre: torch.Tensor | None,
                   gains: torch.Tensor, rgids: torch.Tensor,
                   active: torch.Tensor, tau: torch.Tensor,
                   sieve_gid: torch.Tensor, sieve_gain: torch.Tensor,
                   sieve_count: torch.Tensor):
  """The admission scan of one append chunk, the plain version of
  ``csrc/sieve.cu`` (shapes and result as ``sieve.sieve_scan``): rows in
  order, every (shard, bucket) at once, a member admitted earlier in the
  chunk read from ``s_intra`` and a standing one from ``s_pre``.  Each step
  is elementwise or a max, so the kernel agrees in every bit."""
  n_sh, t, k = sieve_gid.shape
  dev = sieve_gid.device
  gid, gain, cnt = sieve_gid.clone(), sieve_gain.clone(), sieve_count.clone()
  src = torch.full((n_sh, t, k), -1, dtype=torch.int64, device=dev)
  slots = torch.arange(k, device=dev)
  pre = s_pre.reshape(n_sh, -1, t, k)
  for i in range(gains.shape[0]):
    live = slots < cnt[..., None]
    own = src >= 0
    at = src.clamp_min(0)
    sim = torch.where(own, s_intra[i][at], pre[:, i])
    if rsq is not None:
      msq = torch.where(own, rsq[at], msq_pre)
      red = torch.clamp_min(sim, 0.0) / torch.sqrt(rsq[i] * msq)
    else:
      red = sim
    red = torch.where(live, red, 0.0).amax(dim=-1)           # (S, T)
    score = gains[i] * torch.clamp_min(1.0 - red, 0.0)
    admit = (active[:, i, None] & (score >= tau) & (cnt < k)
             & (rgids[i] >= 0))
    put = (slots == cnt[..., None]) & admit[..., None]
    gid = torch.where(put, rgids[i], gid)
    gain = torch.where(put, score[..., None], gain)
    src = torch.where(put, i, src)
    cnt = cnt + admit.to(cnt.dtype)
  return gid, gain, src, cnt


def sieve_norms(rows: torch.Tensor, sieve_feat: torch.Tensor):
  """(rsq (ab,), msq_pre (S, T, k)): the squared norms of the chunk rows
  and of the standing members, clamped at 1e-12, that the linear
  redundancy divides by."""
  rsq = torch.clamp_min(torch.sum(rows.float() ** 2, dim=-1), 1e-12)
  msq = torch.clamp_min(torch.sum(sieve_feat.float() ** 2, dim=-1), 1e-12)
  return rsq, msq


def sieve_update_with(sim, scan):
  """``sieve_update`` over the similarity implementation ``sim`` and the
  admission scan ``scan``: ``ops.sieve_update`` takes ``pairwise`` and the
  kernel's ``sieve.sieve_scan``, ``sieve_update_ref`` the plain versions."""

  def sieve_update(rows: torch.Tensor, gains: torch.Tensor,
                   rgids: torch.Tensor, active: torch.Tensor,
                   tau: torch.Tensor, sieve_gid: torch.Tensor,
                   sieve_gain: torch.Tensor, sieve_feat: torch.Tensor,
                   sieve_count: torch.Tensor, *, kernel: str = "linear",
                   h: float = 0.75):
    """Streaming threshold-sieve admission over one append chunk (the port
    of ``src/repro/kernels/ops.py`` ``sieve_update``): each row, in order,
    joins every bucket t that has room when ``gains[i] * relu(1 - max
    redundancy to t's live members) >= tau[t]``, members admitted earlier
    in the chunk included.  Two similarity sweeps (the chunk against the
    standing members, and against itself), then the row scan, then the
    admitted rows' features.  The state is one shard's, ((T, k) gid int64,
    (T, k) gain, (T, k, d) float32 features, (T,) count int64) with
    ``active`` (ab,), or S shards' stacked ((S, T, k), ...) with ``active``
    (S, ab): the store passes only the shards the chunk lands on.
    ``rgids`` (ab,) int64, -1 for padding; ``tau`` (T,) float32.  Returns
    the four updated arrays (new tensors; the inputs are not modified).
    """
    one = sieve_gid.dim() == 2
    if one:
      sieve_gid, sieve_gain, sieve_feat, sieve_count, active = (
          x.unsqueeze(0) for x in (sieve_gid, sieve_gain, sieve_feat,
                                   sieve_count, active))
    n_sh, t, k, d = sieve_feat.shape
    rows = rows.float().contiguous()
    s_pre = sim(rows, sieve_feat.reshape(n_sh, t * k, d), kernel=kernel,
                h=h)
    s_intra = sim(rows, rows, kernel=kernel, h=h)
    rsq, msq = (sieve_norms(rows, sieve_feat) if kernel == "linear"
                else (None, None))
    gid, gain, src, cnt = scan(s_pre, s_intra, rsq, msq, gains.float(),
                               rgids, active.bool(), tau.float(), sieve_gid,
                               sieve_gain, sieve_count)
    feat = torch.where((src >= 0)[..., None], rows[src.clamp_min(0)],
                       sieve_feat)
    if one:
      return gid[0], gain[0], feat[0], cnt[0]
    return gid, gain, feat, cnt

  return sieve_update


sieve_update_ref = sieve_update_with(pairwise_ref, sieve_scan_ref)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: float | None = None) -> torch.Tensor:
  """Reference GQA attention. q: (B, H, Lq, dh); k, v: (B, Hkv, Lk, dh).

  KV heads repeated to H, float32 logits times ``scale`` (default
  dh ** -0.5), a -1e30 causal mask with the (Lk - Lq) offset, softmax, and
  the output cast back to ``q.dtype``: the plain version of the
  flash-attention kernel.
  """
  b, hq, lq, dh = q.shape
  hkv, lk = k.shape[1], k.shape[2]
  group = hq // hkv
  if scale is None:
    scale = dh ** -0.5
  kr = k.repeat_interleave(group, dim=1)
  vr = v.repeat_interleave(group, dim=1)
  logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
  if causal:
    mask = (torch.arange(lq, device=q.device)[:, None] + (lk - lq)
            >= torch.arange(lk, device=q.device)[None, :])
    logits = torch.where(mask, logits, NEG)
  p = torch.softmax(logits, dim=-1)
  out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
  return out.to(q.dtype)
