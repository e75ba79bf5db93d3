"""Self-attention of the dense decoder (the port of
``src/repro/models/attention.py``).

Every unwindowed self-attention call goes to the flash-attention kernel
through ``ops.flash_attention``.  The reference sends only causal calls
whose length is a multiple of 128 there, because the Pallas BlockSpec needs
whole tiles; the CUDA kernel masks ragged lengths itself, so the port
launches it at any length.  Decode attention (one token against the cache)
is not a kernel in the reference either: it stays inline in
``transformer.apply_block``.  ``chunked_attention``, ``local_attention``,
``cross_attention`` and ``decode_attention`` come with the families that
use them (ROADMAP.md); ``_full_attention`` belongs to the reference's
dry-run cost pass and has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _gqa_split(q: torch.Tensor, n_kv: int) -> torch.Tensor:
  b, h, l, dh = q.shape
  return q.reshape(b, n_kv, h // n_kv, l, dh)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   backend: str = "auto") -> torch.Tensor:
  """q: (B, H, L, dh); k, v: (B, Hkv, L, dh) -> (B, H, L, dh).

  ``backend`` as for every kernel: "cuda" launches the kernel (and raises
  on CPU tensors), "ref" runs the plain version, "auto" picks by device.
  """
  if window:
    raise NotImplementedError(
        "sliding-window attention (local_attention) is not ported yet; "
        "ROADMAP.md lists it with the hybrid family")
  return ops.flash_attention(q, k, v, causal=causal, backend=backend)
