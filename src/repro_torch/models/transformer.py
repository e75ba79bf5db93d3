"""The dense decoder block (the port of ``src/repro/models/transformer.py``).

Three modes share one block implementation:

  train    (B, S) hidden states through the block, teacher forcing
  prefill  the same, and the block's KV cache filled from slot 0
  decode   one token against the cache

Parameters live in ``Params`` modules whose names follow the reference's
pytree (``attn.wq``, ``mlp.gate``), one module per layer where the
reference stacks periods.  Caches are dicts of tensors updated IN PLACE:
the reference is functional and returns new caches; the port writes the
given ones and returns them.  The MoE, RG-LRU, Mamba and cross-attention
blocks and the reference's GSPMD ``_cache_spec`` come with their families
(ROADMAP.md).

Over a model axis (``tp``, a ``TPShard``) a block holds its rank's heads
and MLP columns and ``cfg`` is the rank's local config (``n_heads`` and
``n_kv_heads`` divided by the axis; ``d_ff`` too when the MLP is split):
the normed input enters the split region through ``enter_group``, the qkv
biases (replicated leaves) through ``split_group``, and the ``wo`` /
``down`` products leave it through ``leave_group``.  Without ``tp`` the
block runs exactly as on one device.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.ref import NEG
from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, enter_group,
                                       leave_group, rms_norm, split_group,
                                       swiglu)

NOT_PORTED = ("the MoE, RG-LRU, Mamba and cross-attention blocks are not "
              "ported yet; ROADMAP.md lists them")


class Params(nn.Module):
  """A named tree of parameters: tensors become ``nn.Parameter``s and
  nested dicts child ``Params``, so ``state_dict`` keys read like the
  reference's pytree paths."""

  def __init__(self, tree: dict):
    super().__init__()
    for name, x in tree.items():
      if isinstance(x, dict):
        self.add_module(name, Params(x))
      else:
        self.register_parameter(name, nn.Parameter(x))


@dataclasses.dataclass(frozen=True)
class TPShard:
  """A rank's place on the model axis: ``group`` (a
  ``launch.mesh.ProcessMesh`` of the model group) and whether the MLP is
  split (``d_ff`` a multiple of the axis; else it runs replicated).
  Attention is always split, by whole heads."""
  group: object
  mlp: bool


# ---------------------------------------------------------------------------
# block parameter init
# ---------------------------------------------------------------------------


def block_shapes(cfg: ModelConfig) -> dict:
  """The shapes of one dense block's leaves, by name, in its
  ``state_dict`` order (no tensor is allocated)."""
  d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
  hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
  out = {"ln1": (d,), "ln2": (d,), "attn.wq": (d, hq), "attn.wk": (d, hkv),
         "attn.wv": (d, hkv), "attn.wo": (hq, d)}
  if cfg.qkv_bias:
    out.update({"attn.bq": (hq,), "attn.bk": (hkv,), "attn.bv": (hkv,)})
  if cfg.qk_norm:
    out.update({"attn.q_norm": (dh,), "attn.k_norm": (dh,)})
  out.update({"mlp.gate": (d, f), "mlp.up": (d, f), "mlp.down": (f, d)})
  return out


def _init_mlp(cfg: ModelConfig, dtype, generator, device) -> dict:
  d, f = cfg.d_model, cfg.d_ff
  kw = dict(generator=generator, device=device)
  return {"gate": dense_init((d, f), dtype, **kw),
          "up": dense_init((d, f), dtype, **kw),
          "down": dense_init((f, d), dtype, **kw)}


def _init_attn(cfg: ModelConfig, dtype, generator, device) -> dict:
  d = cfg.d_model
  hq = cfg.n_heads * cfg.head_dim
  hkv = cfg.n_kv_heads * cfg.head_dim
  kw = dict(generator=generator, device=device)
  p = {"wq": dense_init((d, hq), dtype, **kw),
       "wk": dense_init((d, hkv), dtype, **kw),
       "wv": dense_init((d, hkv), dtype, **kw),
       "wo": dense_init((hq, d), dtype, **kw)}
  if cfg.qkv_bias:
    p["bq"] = torch.zeros((hq,), dtype=dtype, device=device)
    p["bk"] = torch.zeros((hkv,), dtype=dtype, device=device)
    p["bv"] = torch.zeros((hkv,), dtype=dtype, device=device)
  if cfg.qk_norm:
    p["q_norm"] = torch.zeros((cfg.head_dim,), device=device)
    p["k_norm"] = torch.zeros((cfg.head_dim,), device=device)
  return p


def init_block(btype: str, cfg: ModelConfig, dtype, *, generator,
               device) -> Params:
  """One block's parameters, drawn from ``generator`` with the reference's
  distributions (norm gains float32 zeros, biases zeros)."""
  if btype != "attn" or cfg.moe.num_experts:
    raise NotImplementedError(f"block {btype!r}: {NOT_PORTED}")
  d = cfg.d_model
  return Params({"ln1": torch.zeros((d,), device=device),
                 "attn": _init_attn(cfg, dtype, generator, device),
                 "ln2": torch.zeros((d,), device=device),
                 "mlp": _init_mlp(cfg, dtype, generator, device)})


# ---------------------------------------------------------------------------
# block cache init (decode)
# ---------------------------------------------------------------------------


def init_block_cache(btype: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device) -> dict:
  """k, v (B, Hkv, max_len, dh) zeros in the model dtype; kpos (max_len,)
  int32 -1 (an empty slot)."""
  if btype != "attn":
    raise NotImplementedError(f"block {btype!r}: {NOT_PORTED}")
  shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
  return {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device),
          "kpos": torch.full((max_len,), -1, dtype=torch.int32,
                             device=device)}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _project_qkv(x, p, cfg: ModelConfig, positions, tp=None):
  """q (B, H, S, dh), k and v (B, Hkv, S, dh): the projections, the qk-norm
  and rope; v is the transposed view (the kernel takes strides).  Over a
  model axis the heads are the rank's and so are the biases' slices."""
  b, s, _ = x.shape
  dh = cfg.head_dim
  q = x @ p.wq
  k = x @ p.wk
  v = x @ p.wv
  if cfg.qkv_bias:
    group = None if tp is None else tp.group
    q = q + split_group(p.bq, group)
    k = k + split_group(p.bk, group)
    v = v + split_group(p.bv, group)
  q = q.reshape(b, s, cfg.n_heads, dh)
  k = k.reshape(b, s, cfg.n_kv_heads, dh)
  v = v.reshape(b, s, cfg.n_kv_heads, dh)
  if cfg.qk_norm:
    q = rms_norm(q, p.q_norm, cfg.rmsnorm_eps)
    k = rms_norm(k, p.k_norm, cfg.rmsnorm_eps)
  q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
  k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
  return q, k, v.transpose(1, 2)


def _attn_out(attn, p, b, s):
  return attn.transpose(1, 2).reshape(b, s, -1) @ p.wo


def _ffn(h, p, cfg: ModelConfig, tp=None):
  x = rms_norm(h, p.ln2, cfg.rmsnorm_eps)
  if tp is None or not tp.mlp:
    return h + swiglu(x, p.mlp.gate, p.mlp.up, p.mlp.down)
  y = swiglu(enter_group(x, tp.group), p.mlp.gate, p.mlp.up, p.mlp.down)
  return h + leave_group(y, tp.group)


def _decode_attention(q, cache, pos: int, cfg: ModelConfig, dtype):
  """One token against the cache, masked to slots written at positions
  <= pos: the reference's inline einsum / softmax, in float32."""
  kc, vc, kpos = cache["k"], cache["v"], cache["kpos"]
  b = q.shape[0]
  valid = (kpos >= 0) & (kpos <= pos)
  qd = A._gqa_split(q, cfg.n_kv_heads)[..., 0, :]           # (B, Hkv, G, dh)
  sc = torch.einsum("bkgd,bksd->bkgs", qd.float() * cfg.head_dim ** -0.5,
                    kc.float())
  sc = torch.where(valid[None, None, None, :], sc, NEG)
  pr = torch.softmax(sc, dim=-1)
  attn = torch.einsum("bkgs,bksd->bkgd", pr, vc.float())
  return attn.reshape(b, cfg.n_heads, 1, cfg.head_dim).to(dtype)


def apply_block(btype: str, h: torch.Tensor, p: Params, cfg: ModelConfig, *,
                mode: str, cache: dict | None = None, pos: int | None = None,
                backend: str = "auto", tp: TPShard | None = None):
  """Returns (h, cache); ``cache`` is written in place in the prefill and
  decode modes.  ``pos`` (decode) is the new token's position, a Python
  int; ``backend`` picks the attention kernel or its plain version; ``tp``
  the rank's place on the model axis (``cfg`` then the local config).  The
  reference's ``window`` (sliding-window blocks, ring-buffer decode) comes
  with the hybrid family."""
  if btype != "attn":
    raise NotImplementedError(f"block {btype!r}: {NOT_PORTED}")
  if mode not in ("train", "prefill", "decode"):
    raise ValueError(f"mode {mode!r}")
  b, s, _ = h.shape
  x = rms_norm(h, p.ln1, cfg.rmsnorm_eps)
  if mode == "decode":
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
  else:
    positions = torch.arange(s, device=h.device)
  if tp is not None:
    x = enter_group(x, tp.group)
  q, k, v = _project_qkv(x, p.attn, cfg, positions, tp)

  if mode == "decode":
    slot = min(pos, cache["k"].shape[2] - 1)
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]
    cache["kpos"][slot] = pos
    attn = _decode_attention(q, cache, pos, cfg, h.dtype)
  else:
    attn = A.self_attention(q, k, v, causal=True, backend=backend)
    if mode == "prefill":
      s_cache = cache["k"].shape[2]
      if s <= s_cache:
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
        cache["kpos"][:s] = torch.arange(s, dtype=torch.int32,
                                         device=h.device)
      else:  # a cache shorter than the prompt keeps the prompt's tail
        cache["k"].copy_(k[:, :, -s_cache:])
        cache["v"].copy_(v[:, :, -s_cache:])
        cache["kpos"].copy_(torch.arange(s - s_cache, s, dtype=torch.int32,
                                         device=h.device))
  out = _attn_out(attn, p.attn, b, s)
  h = h + (out if tp is None else leave_group(out, tp.group))
  return _ffn(h, p, cfg, tp), cache
