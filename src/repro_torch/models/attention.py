"""Self-attention of the dense decoder (the port of
``src/repro/models/attention.py``).

Two lowerings, one rule (``self_attention``): a call that autograd must
differentiate goes to ``chunked_attention``, the reference's own training
route (it trains through ``chunked_attention`` everywhere but on the TPU,
and its Pallas kernel has no backward either); every other call goes to the
flash-attention kernel through ``ops.flash_attention``.  The rule reads
only grad mode and ``requires_grad``, never whether the kernel builds: a
kernel that fails still raises.

The reference sends only causal calls whose length is a multiple of 128 to
its kernel, because the Pallas BlockSpec needs whole tiles; the CUDA kernel
masks ragged lengths itself, so the port launches it at any length.
Decode attention (one token against the cache) is not a kernel in the
reference either: it stays inline in ``transformer.apply_block``.
``local_attention``, ``cross_attention`` and ``decode_attention`` come with
the families that use them (ROADMAP.md); ``_full_attention`` belongs to the
reference's dry-run cost pass and has no counterpart.
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
  so no (qc, Lk) probability block outlives its chunk's forward.  The
  reference's sliding window comes with ``local_attention`` (ROADMAP.md).
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


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   backend: str = "auto") -> torch.Tensor:
  """q: (B, H, L, dh); k, v: (B, Hkv, L, dh) -> (B, H, L, dh).

  The rule: under autograd (grad enabled and q, k or v requiring grad) the
  call goes to ``chunked_attention``; every other call goes to the kernel
  (``backend`` as for every kernel: "cuda" launches it and raises on CPU
  tensors, "ref" runs the plain version, "auto" picks by device).
  """
  if window:
    raise NotImplementedError(
        "sliding-window attention (local_attention) is not ported yet; "
        "ROADMAP.md lists it with the hybrid family")
  if needs_grad(q, k, v):
    return chunked_attention(q, k, v, causal=causal)
  return ops.flash_attention(q, k, v, causal=causal, backend=backend)
