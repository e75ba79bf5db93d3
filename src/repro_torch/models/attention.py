"""Attention (the port of ``src/repro/models/attention.py``).

Four lowerings and one rule (``self_attention``):

  * ``chunked_attention`` -- online-softmax attention over query and key
    chunks, the reference's own training route (it trains through
    ``chunked_attention`` everywhere but on the TPU, and its Pallas kernel
    has no backward either), and the encoder's bidirectional attention;
  * the flash-attention kernel through ``ops.flash_attention``: every
    causal, unwindowed call outside autograd;
  * ``local_attention`` -- causal sliding-window attention, each query
    chunk against a key span of ``window + q_chunk`` (RecurrentGemma's
    local-attention layers; they stay off the kernel, as in the reference:
    windowed, and their head width of 256 is not the kernel's);
  * ``cross_attention`` -- full attention over an encoder or image memory.

The rule reads only the window, grad mode and ``requires_grad``, never
whether the kernel builds: a kernel that fails still raises.  The
reference sends only causal calls whose length is a multiple of 128 to its
kernel, because the Pallas BlockSpec needs whole tiles; the CUDA kernel
masks ragged lengths itself, so the port launches it at any length.
Decode attention (one token against the cache) is not a kernel in the
reference either: it stays inline in ``transformer.apply_block``.
``_full_attention`` belongs to the reference's dry-run cost pass and has no
counterpart.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG


def _gqa_split(q: torch.Tensor, n_kv: int) -> torch.Tensor:
  b, h, l, dh = q.shape
  return q.reshape(b, n_kv, h // n_kv, l, dh)


def needs_grad(*ts: torch.Tensor) -> bool:
  """True when autograd would differentiate a call on these tensors."""
  return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _q_chunk(q5, k, v, q0: int, *, causal: bool, k_chunk: int,
             lk_true: int) -> torch.Tensor:
  """One query chunk (B, Hkv, G, qc, dh) against the key chunks it can see,
  with the online softmax in float32; the output in q's dtype."""
  b, hkv, g, qc, dh = q5.shape
  lk = k.shape[2]
  q32 = q5.float() * dh ** -0.5
  m = torch.full((b, hkv, g, qc), NEG, dtype=torch.float32, device=q5.device)
  l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=q5.device)
  acc = torch.zeros((b, hkv, g, qc, dh), dtype=torch.float32,
                    device=q5.device)
  qpos = q0 + torch.arange(qc, device=q5.device)
  for k0 in range(0, lk, k_chunk):
    if causal and k0 > q0 + qc - 1:
      break  # blocks above the diagonal contribute nothing: skipped
    kc = k[:, :, k0:k0 + k_chunk].float()
    vc = v[:, :, k0:k0 + k_chunk].float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", q32, kc)
    kpos = k0 + torch.arange(kc.shape[2], device=q5.device)
    mask = (kpos < lk_true)[None, :].expand(qc, -1)
    if causal:
      mask = mask & (qpos[:, None] >= kpos[None, :])
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
    m = m_new
  return (acc / l.clamp_min(1e-30)[..., None]).to(q5.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 256,
                      k_chunk: int = 1024) -> torch.Tensor:
  """q: (B, H, Lq, dh); k, v: (B, Hkv, Lk, dh) with Lq == Lk -> (B, H, Lq,
  dh) in q's dtype.

  Query chunks of ``q_chunk`` against key chunks of ``k_chunk`` with the
  online softmax in float32 (GQA by reshaping the queries to (B, Hkv, G,
  L, dh), never repeating KV heads); lengths padded to the chunks, padded
  keys masked, blocks above the diagonal skipped.  Under autograd each
  query chunk is recomputed in the backward pass
  (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does,
  so no (qc, Lk) probability block outlives its chunk's forward.  Windows
  take ``local_attention``.
  """
  b, h, lq, dh = q.shape
  hkv, lk = k.shape[1], k.shape[2]
  q_chunk = min(q_chunk, lq)
  k_chunk = min(k_chunk, lk)
  lq_true, lk_true = lq, lk
  pq, pk = (-lq) % q_chunk, (-lk) % k_chunk
  if pq or pk:  # pad to chunk multiples; padded keys masked
    q = torch.nn.functional.pad(q, (0, 0, 0, pq))
    k = torch.nn.functional.pad(k, (0, 0, 0, pk))
    v = torch.nn.functional.pad(v, (0, 0, 0, pk))
    lq = lq + pq
  q5 = _gqa_split(q, hkv)
  kw = dict(causal=causal, k_chunk=k_chunk, lk_true=lk_true)
  recompute = needs_grad(q, k, v)
  outs = []
  for q0 in range(0, lq, q_chunk):
    qc = q5[:, :, :, q0:q0 + q_chunk]
    if recompute:
      outs.append(checkpoint(_q_chunk, qc, k, v, q0, use_reentrant=False,
                             **kw))
    else:
      outs.append(_q_chunk(qc, k, v, q0, **kw))
  out = torch.cat(outs, dim=3).reshape(b, h, lq, dh)
  return out[:, :, :lq_true]


def _local_chunk(q5, k, v, q0: int, *, window: int, span: int):
  """One query chunk (B, Hkv, G, qc, dh) of ``local_attention`` against its
  key span; the softmax in float32, the output in q's dtype."""
  qc, dh = q5.shape[3], q5.shape[4]
  lk = k.shape[2]
  start = min(max(q0 + qc - span, 0), lk - span)
  kc = k[:, :, start:start + span].float()
  vc = v[:, :, start:start + span].float()
  s = torch.einsum("bkgqd,bkcd->bkgqc", q5.float() * dh ** -0.5, kc)
  qpos = q0 + torch.arange(qc, device=q5.device)
  kpos = start + torch.arange(span, device=q5.device)
  diff = qpos[:, None] - kpos[None, :]
  s = torch.where((diff >= 0) & (diff < window), s, NEG)
  p = torch.softmax(s, dim=-1)
  return torch.einsum("bkgqc,bkcd->bkgqd", p, vc).to(q5.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_chunk: int = 1024) -> torch.Tensor:
  """Causal sliding-window attention: a query at position i sees the keys
  at i - window + 1 .. i.  q (B, H, L, dh); k, v (B, Hkv, L, dh) -> (B, H,
  L, dh) in q's dtype.

  Each chunk of ``q_chunk`` queries attends to a key span of static length
  ``window + q_chunk`` (clipped to the sequence), so the work is O(L *
  (window + q_chunk)) and no O(L^2) logits exist.  The reference's
  precondition holds: L a multiple of ``min(q_chunk, L)``.  Under autograd
  each chunk is recomputed in the backward pass."""
  b, h, lq, dh = q.shape
  hkv, lk = k.shape[1], k.shape[2]
  q_chunk = min(q_chunk, lq)
  if lq % q_chunk:
    raise ValueError(f"local_attention: length {lq} is not a multiple of "
                     f"the query chunk {q_chunk}")
  span = min(window + q_chunk, lk)
  q5 = _gqa_split(q, hkv)
  recompute = needs_grad(q, k, v)
  outs = []
  for q0 in range(0, lq, q_chunk):
    qc = q5[:, :, :, q0:q0 + q_chunk]
    if recompute:
      outs.append(checkpoint(_local_chunk, qc, k, v, q0, window=window,
                             span=span, use_reentrant=False))
    else:
      outs.append(_local_chunk(qc, k, v, q0, window=window, span=span))
  return torch.cat(outs, dim=3).reshape(b, h, lq, dh)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_chunk: int = 256) -> torch.Tensor:
  """Full (non-causal) attention over an encoder or image memory.  q (B, H,
  Lq, dh); k, v (B, Hkv, Lk, dh) -> (B, H, Lq, dh) in q's dtype, the
  softmax in float32.  Every query row is independent, so the queries go
  in chunks of ``q_chunk`` (the reference's argument, which it leaves
  unused) and no (Lq, Lk) block of all the queries exists at once."""
  b, h, lq, dh = q.shape
  hkv = k.shape[1]
  q5 = _gqa_split(q, hkv).float() * dh ** -0.5
  kf, vf = k.float(), v.float()
  outs = []
  for q0 in range(0, lq, q_chunk):
    s = torch.einsum("bkgqd,bkcd->bkgqc", q5[:, :, :, q0:q0 + q_chunk], kf)
    outs.append(torch.einsum("bkgqc,bkcd->bkgqd", torch.softmax(s, dim=-1),
                             vf))
  return torch.cat(outs, dim=3).reshape(b, h, lq, dh).to(q.dtype)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   backend: str = "auto") -> torch.Tensor:
  """q: (B, H, L, dh); k, v: (B, Hkv, L, dh) -> (B, H, L, dh).

  The rule: a window takes ``local_attention``; otherwise, under autograd
  (grad enabled and q, k or v requiring grad) the call goes to
  ``chunked_attention``, and every other call to the kernel (``backend``
  as for every kernel: "cuda" launches it and raises on CPU tensors, "ref"
  runs the plain version, "auto" picks by device).
  """
  if window:
    return local_attention(q, k, v, window=window)
  if needs_grad(q, k, v):
    return chunked_attention(q, k, v, causal=causal)
  return ops.flash_attention(q, k, v, causal=causal, backend=backend)
