"""The decoder blocks of every family (the port of
``src/repro/models/transformer.py``).

Four block types (``config.py``): "attn" (self-attention, optionally
windowed, + SwiGLU MLP or MoE), "cross" (an "attn" block plus
cross-attention over an encoder or image memory before the FFN), "rec"
(the RG-LRU recurrent block + MLP) and "mamba" (the Mamba-2 SSD block
alone).  Three modes share one block implementation:

  train    (B, S) hidden states through the block, teacher forcing
  prefill  the same, and the block's cache filled
  decode   one token against the cache

Parameters live in ``Params`` modules whose names follow the reference's
pytree (``attn.wq``, ``mlp.gate``, ``moe.router``, ``rec.lam``,
``mamba.a_log``, ``xattn.wq``), one module per layer where the reference
stacks periods.  Caches are dicts of tensors updated IN PLACE: the
reference is functional and returns new caches; the port writes the given
ones and returns them.

Caches: an attention block's k, v (B, Hkv, S, dh) and kpos (S,) (-1 an
empty slot).  In the hybrid family a windowed cache holds ``min(max_len,
window)`` rows as a ring: decode writes position p at slot ``p % S`` and
masks the keys outside the window by kpos; a prefill longer than the cache
keeps the prompt's tail, position p at slot ``p % S`` too (the reference
stores the tail in order from slot 0, which puts it at ``p % S`` only when
the prompt length is a multiple of S; decoding past such a prompt then
overwrites a key the window still needs, so the port's layout is the
reference's where the reference is exact, and exact where it is not).  A
cross block also holds xk, xv (B, Hkv, M, dh): the memory's keys and
values, filled by the prefill and read by every decode step.  The "rec"
and "mamba" blocks hold conv (B, W-1, C) in the model dtype and h (their
float32 recurrent state).

Over a model axis (``tp``, a ``TPShard``) a block holds its rank's slices
by ``registry.param_specs`` and ``cfg`` is the rank's local config
(``n_heads`` divided by the axis, ``n_kv_heads`` the KV heads the rank
reads, ``d_ff`` divided when the MLP is split): the normed input (and a
cross block's memory) enters the split region through ``enter_group``,
the qkv biases (replicated leaves) through ``split_group``, and the
``wo`` / ``down`` products leave it through ``leave_group`` (under
``TPShard.seq``, sequence sharding, h is the rank's slice of the
sequence between sub-blocks: each gathers it before its norm,
``_whole``, and its output leaves by a reduce-scatter along the
sequence, ``layers.leave``).  Query heads
split by whole heads; KV heads too where the axis divides them, and
otherwise (``TPShard.kv_gather``: fewer KV heads than ranks, as in
multi-query attention) ``wk`` / ``wv`` split inside a head, the K / V
projection is gathered whole (``layers.gather_summed``) and each rank
keeps the one KV head its query heads read, in its cache too.  Where the
axis does not divide the query heads but does the projections' columns
(``TPShard.heads``: whisper-tiny's 6 heads or recurrentgemma-2b's 10 on
16 ranks, the reference's column split inside a head) the q / k / v
columns are gathered whole, every rank computes every head, and each
takes its columns of the output into its rows of ``wo``; its caches hold
its 1 / M of every head's head_dim (the reference's ``cache_specs``), and
a decode step sums the partial scores over the group in rank order and
gathers the output's slices (``_cache_attention``).  The MoE
FFN (``moe.moe_ffn``), the Mamba-2 block (``ssm.mamba_block``) and the
RG-LRU block (``rglru.recurrent_block``) take ``tp`` themselves.  Without
``tp`` the block runs exactly as on one device.  A batch-1 cache split by
length over the data ranks (``KVSplit``, the reference's ``cache_specs``
with ``batch_shardable=False``) keeps a rank's slots of k, v and kpos (of
the ring too) and of a cross block's memory K/V; prefill stores the slots
a rank holds, decode writes the slot of its rank, and attention combines
the ranks' partial softmax statistics.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.ref import NEG
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, enter_group,
                                       gather_group, gather_summed, leave,
                                       rms_norm, split_group, swiglu)

BLOCKS = ("attn", "cross", "rec", "mamba")


class Gathered:
  """A module mixin for FSDP: while ``_whole`` (a dict an owner installs
  for the span of one use) names a parameter, reading the attribute gives
  that whole tensor instead of the rank's shard (``registry.Model``'s
  ``_gathered``)."""

  def __getattr__(self, name):
    whole = self.__dict__.get("_whole")
    if whole is not None and name in whole:
      return whole[name]
    return super().__getattr__(name)


class Params(Gathered, nn.Module):
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
  ``launch.mesh.ProcessMesh`` of the model group); whether the MLP is
  split (``d_ff`` a multiple of the axis; else it runs replicated), and
  the MoE's shared experts likewise (``shared``); the routed experts'
  layout (``experts``: "tp" splits each expert's width, "ep" deals whole
  experts, None keeps them replicated); and, where the KV heads are fewer
  than the ranks, ``kv_gather`` with the one KV head the rank's query
  heads read (``kv_head``).  Query heads always split, by whole heads."""
  group: object
  mlp: bool
  shared: bool = False
  experts: str | None = None
  kv_gather: bool = False
  kv_head: int = 0
  seq: bool = False
  heads: bool = False   # the axis splits inside the query heads


@dataclasses.dataclass(frozen=True)
class KVSplit:
  """A batch-1 cache split by length over the data group ``group`` (a
  ``launch.mesh.ProcessMesh``): rank i holds slots i * S / D .. (i + 1) *
  S / D - 1 of the one-process cache (of its ring in the hybrid family),
  and of a cross block's memory K/V likewise; a decode step's attention
  is each rank's partial softmax statistics combined in rank order
  (``_decode_attention``)."""
  group: object

  def span(self, local: int) -> tuple[int, int]:
    """(first slot, whole slots) of a cache whose rank holds ``local``."""
    return self.group.rank * local, local * self.group.world


def _whole(h: torch.Tensor, tp) -> torch.Tensor:
  """The residual stream's whole sequence: under sequence sharding the
  ranks' slices gathered along dim 1 (the rank's slice of the gradient
  backward: what follows reads it alike on every rank)."""
  return gather_group(h, tp.group, 1) if tp is not None and tp.seq else h


def _seq(tp):
  """The model group when the residual stream is sharded by sequence."""
  return tp.group if tp is not None and tp.seq else None


# ---------------------------------------------------------------------------
# block parameter init
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> dict:
  d, dh = cfg.d_model, cfg.head_dim
  hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
  out = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
  if cfg.qkv_bias:
    out.update({"bq": (hq,), "bk": (hkv,), "bv": (hkv,)})
  if cfg.qk_norm:
    out.update({"q_norm": (dh,), "k_norm": (dh,)})
  return out


def _under(prefix: str, shapes: dict) -> dict:
  return {f"{prefix}.{n}": shape for n, shape in shapes.items()}


def _ffn_shapes(cfg: ModelConfig) -> dict:
  if cfg.moe.num_experts:
    return _under("moe", MOE.moe_shapes(cfg))
  d, f = cfg.d_model, cfg.d_ff
  return {"mlp.gate": (d, f), "mlp.up": (d, f), "mlp.down": (f, d)}


def block_shapes(btype: str, cfg: ModelConfig) -> dict:
  """The shapes of one block's leaves, by name, in its ``state_dict``
  order (no tensor is allocated)."""
  d = cfg.d_model
  if btype == "attn":
    return {"ln1": (d,), "ln2": (d,), **_under("attn", _attn_shapes(cfg)),
            **_ffn_shapes(cfg)}
  if btype == "cross":   # a module's own leaves come before its children's
    return {"ln1": (d,), "ln2": (d,), "lnx": (d,),
            **_under("attn", _attn_shapes(cfg)), **_ffn_shapes(cfg),
            **_under("xattn", _attn_shapes(cfg))}
  if btype == "rec":
    return {"ln1": (d,), "ln2": (d,), **_under("rec", RG.rglru_shapes(cfg)),
            **_ffn_shapes(cfg)}
  if btype == "mamba":
    return {"ln1": (d,), **_under("mamba", SSM.mamba_shapes(cfg))}
  raise ValueError(f"block {btype!r} not in {BLOCKS}")


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


def _init_ffn(cfg: ModelConfig, dtype, generator, device) -> dict:
  if cfg.moe.num_experts:
    return {"moe": MOE.init_moe(cfg, dtype, generator=generator,
                                device=device)}
  return {"mlp": _init_mlp(cfg, dtype, generator, device)}


def init_block(btype: str, cfg: ModelConfig, dtype, *, generator,
               device) -> Params:
  """One block's parameters, drawn from ``generator`` with the reference's
  distributions (norm gains float32 zeros, biases zeros)."""
  d = cfg.d_model
  kw = dict(generator=generator, device=device)

  def zeros():
    return torch.zeros((d,), device=device)

  if btype == "attn":
    tree = {"ln1": zeros(), "attn": _init_attn(cfg, dtype, generator, device),
            "ln2": zeros(), **_init_ffn(cfg, dtype, generator, device)}
  elif btype == "cross":
    tree = {"ln1": zeros(), "attn": _init_attn(cfg, dtype, generator, device),
            "ln2": zeros(), **_init_ffn(cfg, dtype, generator, device),
            "lnx": zeros(),
            "xattn": _init_attn(cfg, dtype, generator, device)}
  elif btype == "rec":
    tree = {"ln1": zeros(), "rec": RG.init_rglru(cfg, dtype, **kw),
            "ln2": zeros(), **_init_ffn(cfg, dtype, generator, device)}
  elif btype == "mamba":
    tree = {"ln1": zeros(), "mamba": SSM.init_mamba(cfg, dtype, **kw)}
  else:
    raise ValueError(f"block {btype!r} not in {BLOCKS}")
  return Params(tree)


# ---------------------------------------------------------------------------
# block cache init (decode)
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
  """An attention cache's rows: the window's in the hybrid family (a
  ring), else ``max_len``."""
  if cfg.sliding_window and cfg.family == "hybrid":
    return min(max_len, cfg.sliding_window)
  return max_len


def _split_len(n: int, split: KVSplit | None, what: str) -> int:
  if split is None:
    return n
  if n % split.group.world:
    raise ValueError(f"a batch-1 cache splits {what} ({n}) by length over "
                     f"{split.group.world} data ranks; it does not divide")
  return n // split.group.world


def init_block_cache(btype: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device, memory: torch.Tensor | None = None,
                     ranks: int = 1, kv_split: KVSplit | None = None,
                     dh_ranks: int = 1) -> dict:
  """Zeros in the model dtype (the recurrent states float32); kpos int32
  -1 (an empty slot).  A cross block's memory K/V take ``memory``'s length
  (``n_img_tokens`` without one).  ``cfg`` is the rank's local config and
  ``ranks`` the model axis, whose share of the recurrent channels and SSM
  heads a rank holds; ``kv_split`` splits the attention caches by length
  (the cache keeps it under "kv_split"); ``dh_ranks`` splits their
  head_dim (``TPShard.heads``: the rank's 1 / M of every head's)."""
  zeros = dict(dtype=dtype, device=device)
  if btype in ("attn", "cross"):
    rows = _split_len(cache_len(cfg, max_len), kv_split, "the cache rows")
    if cfg.head_dim % dh_ranks:
      raise ValueError(f"head_dim {cfg.head_dim} does not split over "
                       f"{dh_ranks} model ranks")
    dh = cfg.head_dim // dh_ranks
    shape = (batch, cfg.n_kv_heads, rows, dh)
    c = {"k": torch.zeros(shape, **zeros), "v": torch.zeros(shape, **zeros),
         "kpos": torch.full((shape[2],), -1, dtype=torch.int32,
                            device=device)}
    if btype == "cross":
      n_mem = memory.shape[1] if memory is not None else cfg.n_img_tokens
      mshape = (batch, cfg.n_kv_heads,
                _split_len(n_mem, kv_split, "the memory"), dh)
      c["xk"] = torch.zeros(mshape, **zeros)
      c["xv"] = torch.zeros(mshape, **zeros)
    if kv_split is not None:
      c["kv_split"] = kv_split
    return c
  if btype == "rec":
    w = RG.lru_width(cfg) // ranks
    return {"conv": torch.zeros((batch, cfg.rec.conv_width - 1, w), **zeros),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
  if btype == "mamba":
    s = cfg.ssm
    conv = SSM.conv_dim(cfg) - SSM.d_inner(cfg) * (ranks - 1) // ranks
    return {"conv": torch.zeros((batch, s.conv_width - 1, conv), **zeros),
            "h": torch.zeros((batch, SSM.n_heads(cfg) // ranks, s.head_dim,
                              s.d_state), dtype=torch.float32,
                             device=device)}
  raise ValueError(f"block {btype!r} not in {BLOCKS}")


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _project_q(x, p, cfg: ModelConfig, positions, tp=None):
  """q (B, H, S, dh): the projection, its bias, the qk-norm and rope
  (under ``tp.heads`` the rank's columns gathered whole)."""
  b, s, _ = x.shape
  q = x @ p.wq
  if cfg.qkv_bias:
    q = q + split_group(p.bq, None if tp is None else tp.group)
  if tp is not None and tp.heads:
    q = gather_group(q, tp.group)
  q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
  if cfg.qk_norm:
    q = rms_norm(q, p.q_norm, cfg.rmsnorm_eps)
  return apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)


def _kv_heads(x, p, cfg: ModelConfig, tp, bias: bool):
  """x @ wk and x @ wv (+ their biases): the rank's KV heads' columns, or
  under ``tp.kv_gather`` the projection gathered whole and the one head
  the rank's query heads read."""
  k = x @ p.wk
  v = x @ p.wv
  group = None if tp is None else tp.group
  if bias:
    k = k + split_group(p.bk, group)
    v = v + split_group(p.bv, group)
  if tp is not None and tp.heads:
    k, v = gather_group(k, group), gather_group(v, group)
  elif tp is not None and tp.kv_gather:
    dh = cfg.head_dim
    k = gather_summed(k, group).narrow(-1, tp.kv_head * dh, dh)
    v = gather_summed(v, group).narrow(-1, tp.kv_head * dh, dh)
  return k, v


def _project_qkv(x, p, cfg: ModelConfig, positions, tp=None):
  """q (B, H, S, dh), k and v (B, Hkv, S, dh): the projections, the qk-norm
  and rope; v is the transposed view (the kernel takes strides).  Over a
  model axis the heads are the rank's and so are the biases' slices."""
  b, s, _ = x.shape
  dh = cfg.head_dim
  k, v = _kv_heads(x, p, cfg, tp, cfg.qkv_bias)
  k = k.reshape(b, s, cfg.n_kv_heads, dh)
  v = v.reshape(b, s, cfg.n_kv_heads, dh)
  if cfg.qk_norm:
    k = rms_norm(k, p.k_norm, cfg.rmsnorm_eps)
  k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
  return _project_q(x, p, cfg, positions, tp), k, v.transpose(1, 2)


def _memory_kv(memory, p, cfg: ModelConfig, tp=None):
  """The memory's keys and values (B, Hkv, M, dh): plain projections (no
  bias, norm or rope, as in the reference); the rank's KV heads over a
  model axis, the memory entering the group."""
  mb, ms, _ = memory.shape
  if tp is not None:
    memory = enter_group(memory, tp.group)
  k, v = _kv_heads(memory, p, cfg, tp, False)
  return (k.reshape(mb, ms, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2),
          v.reshape(mb, ms, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2))


def _attn_out(attn, p, b, s, tp=None):
  """The attention output's projection (under ``tp.heads``, every head
  was computed on every rank: the rank's columns, ``wo``'s rows)."""
  flat = attn.transpose(1, 2).reshape(b, s, -1)
  if tp is not None and tp.heads:
    flat = split_group(flat, tp.group)
  return flat @ p.wo


def _ffn(h, p, cfg: ModelConfig, tp=None, dp=None, pod=None):
  """The FFN sub-block: (h + FFN(norm(h)), aux).  aux is the MoE
  load-balance term, None for an MLP; ``dp`` the data group h is a shard
  of and ``pod`` the pod group the experts are dealt over
  (``moe.moe_ffn``)."""
  x = rms_norm(_whole(h, tp), p.ln2, cfg.rmsnorm_eps)
  if cfg.moe.num_experts:
    y, aux = MOE.moe_ffn(x, p.moe, cfg, dp=dp, tp=tp, pod=pod)
    return h + y, aux
  if tp is None or not tp.mlp:
    return h + leave(swiglu(x, p.mlp.gate, p.mlp.up, p.mlp.down), None,
                     _seq(tp)), None
  y = swiglu(enter_group(x, tp.group), p.mlp.gate, p.mlp.up, p.mlp.down)
  return h + leave(y, tp.group, _seq(tp)), None


def _split_softmax(sc, vc, split: KVSplit):
  """softmax(sc) @ vc over a length split: each rank's max, sum of
  exponentials and weighted values over its slots, gathered and combined
  in rank order with log-sum-exp (float32)."""
  m = sc.amax(dim=-1, keepdim=True)
  pr = torch.exp(sc - m)
  part = torch.cat([m, pr.sum(dim=-1, keepdim=True),
                    torch.einsum("bkgs,bksd->bkgd", pr, vc)], dim=-1)
  parts = split.group.gather_parts(part.contiguous())
  top = parts[0][..., :1]
  for p_ in parts[1:]:
    top = torch.maximum(top, p_[..., :1])
  den = num = None
  for p_ in parts:
    w = torch.exp(p_[..., :1] - top)
    den = p_[..., 1:2] * w if den is None else den + p_[..., 1:2] * w
    num = p_[..., 2:] * w if num is None else num + p_[..., 2:] * w
  return num / den


def _dh_group(tp):
  """The model group where the caches hold 1 / M of head_dim
  (``TPShard.heads``), else None."""
  return tp.group if tp is not None and tp.heads else None


def _dh_part(x: torch.Tensor, tp) -> torch.Tensor:
  """x (..., dh) cut to the rank's slice of head_dim where the caches
  split it (``_dh_group``)."""
  group = _dh_group(tp)
  if group is None:
    return x
  n = x.shape[-1] // group.world
  return x.narrow(-1, group.rank * n, n)


def _cache_attention(q, kc, vc, valid, cfg: ModelConfig, dtype,
                     split: KVSplit | None, dh_group):
  """One token's q (B, H, 1, dh) against cached keys and values, masked to
  ``valid`` slots (None: all): the reference's inline einsum / softmax in
  float32, over a length split ``_split_softmax``.  With ``dh_group`` the
  caches hold the rank's slice of head_dim: the scores are the partial
  products summed over the group in rank order, and the output's slices
  are gathered."""
  b = q.shape[0]
  qd = A._gqa_split(q, cfg.n_kv_heads)[..., 0, :]           # (B, Hkv, G, dh)
  if dh_group is not None:
    n = kc.shape[-1]
    qd = qd.narrow(-1, dh_group.rank * n, n)
  sc = torch.einsum("bkgd,bksd->bkgs", qd.float() * cfg.head_dim ** -0.5,
                    kc.float())
  if dh_group is not None:
    sc = dh_group.sum(sc)
  if valid is not None:
    sc = torch.where(valid[None, None, None, :], sc, NEG)
  if split is not None:
    attn = _split_softmax(sc, vc.float(), split)
  else:
    pr = torch.softmax(sc, dim=-1)
    attn = torch.einsum("bkgs,bksd->bkgd", pr, vc.float())
  if dh_group is not None:
    attn = dh_group.all_gather(attn.contiguous(), dim=-1)
  return attn.reshape(b, cfg.n_heads, 1, cfg.head_dim).to(dtype)


def _decode_attention(q, cache, pos: int, window: int, cfg: ModelConfig,
                      dtype, tp=None):
  """One token against the cache, masked to slots written at positions
  <= pos (and within the window): ``_cache_attention``."""
  kpos = cache["kpos"]
  valid = (kpos >= 0) & (kpos <= pos)
  if window:
    valid = valid & (kpos > pos - window)
  return _cache_attention(q, cache["k"], cache["v"], valid, cfg, dtype,
                          cache.get("kv_split"), _dh_group(tp))


def _slot(cache, pos: int, window: int):
  """The local slot a decode step writes position ``pos`` to (None: another
  rank of a length split holds it)."""
  local = cache["k"].shape[2]
  first, s_cache = (cache["kv_split"].span(local) if "kv_split" in cache
                    else (0, local))
  slot = pos % s_cache if window else min(pos, s_cache - 1)
  return slot - first if first <= slot < first + local else None


def _fill_cache(cache, k, v, s: int, window: int):
  """A prefill's keys and values into the cache: from slot 0 when the
  prompt fits, else its tail, position p at slot p % S when windowed (the
  ring decode reads) and in order otherwise (a full cache shorter than
  the prompt).  Over a length split a rank keeps the slots it holds."""
  local = cache["k"].shape[2]
  split = cache.get("kv_split")
  first, s_cache = split.span(local) if split else (0, local)
  dev = k.device
  if split is None and s <= s_cache:
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    cache["kpos"][:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return
  if s <= s_cache:
    pos = torch.arange(s, device=dev)
    slots = pos
  else:
    pos = torch.arange(s - s_cache, s, device=dev)
    slots = pos % s_cache if window else torch.arange(s_cache, device=dev)
  if split is not None:
    mine = (slots >= first) & (slots < first + local)
    pos, slots = pos[mine], slots[mine] - first
  cache["k"][:, :, slots] = k[:, :, pos]
  cache["v"][:, :, slots] = v[:, :, pos]
  cache["kpos"][slots] = pos.to(torch.int32)


def _attention(h, p, cfg, *, mode, window, cache, pos, positions, backend,
               tp):
  """The self-attention sub-block: h + attention(norm(h))."""
  x = rms_norm(_whole(h, tp), p.ln1, cfg.rmsnorm_eps)
  b, s, _ = x.shape
  if tp is not None:
    x = enter_group(x, tp.group)
  q, k, v = _project_qkv(x, p.attn, cfg, positions, tp)
  if mode == "decode":
    slot = _slot(cache, pos, window)
    if slot is not None:
      cache["k"][:, :, slot] = _dh_part(k, tp)[:, :, 0]
      cache["v"][:, :, slot] = _dh_part(v, tp)[:, :, 0]
      cache["kpos"][slot] = pos
    attn = _decode_attention(q, cache, pos, window, cfg, h.dtype, tp)
  else:
    attn = A.self_attention(q, k, v, causal=True, window=window,
                            backend=backend)
    if mode == "prefill":
      _fill_cache(cache, _dh_part(k, tp), _dh_part(v, tp), s, window)
  out = _attn_out(attn, p.attn, b, s, tp)
  return h + (out if tp is None else leave(out, tp.group, _seq(tp)))


def _cross(h, p, cfg, *, mode, memory, cache, positions, tp):
  """The cross-attention sub-block: h + cross_attention(norm(h), memory).
  The memory's K/V are computed from ``memory`` (train), computed and
  stored (prefill) or read from the cache (decode)."""
  group = None if tp is None else tp.group
  x = enter_group(rms_norm(_whole(h, tp), p.lnx, cfg.rmsnorm_eps), group)
  b, s, _ = x.shape
  q = _project_q(x, p.xattn, cfg, positions, tp)
  split = None if cache is None else cache.get("kv_split")
  if mode == "decode":
    xk, xv = cache["xk"], cache["xv"]
  else:
    xk, xv = _memory_kv(memory, p.xattn, cfg, tp)
    if mode == "prefill":
      n = cache["xk"].shape[2]
      first = split.span(n)[0] if split else 0
      cache["xk"].copy_(_dh_part(xk, tp)[:, :, first:first + n])
      cache["xv"].copy_(_dh_part(xv, tp)[:, :, first:first + n])
  if mode == "decode" and (split is not None or _dh_group(tp) is not None):
    # one token against the split memory, unmasked
    attn = _cache_attention(q, xk, xv, None, cfg, q.dtype, split,
                            _dh_group(tp))
  else:
    attn = A.cross_attention(q, xk, xv)
  out = _attn_out(attn, p.xattn, b, s, tp)
  return h + leave(out, group, _seq(tp))


def _recurrent(h, p, cfg, *, mode, cache, block, sub, tp):
  """The "rec" / "mamba" sub-block: h + block(norm(h)) over the block's
  parameters ``sub``, the decode state read from and the final state
  written to the cache."""
  x = rms_norm(_whole(h, tp), p.ln1, cfg.rmsnorm_eps)
  state = (cache["conv"], cache["h"]) if mode == "decode" else None
  y, (conv_new, h_new) = block(x, sub, cfg, decode_state=state, tp=tp)
  if mode != "train":
    cache["conv"].copy_(conv_new)
    cache["h"].copy_(h_new)
  return h + y


def apply_block(btype: str, h: torch.Tensor, p: Params, cfg: ModelConfig, *,
                mode: str, window: int = 0,
                memory: torch.Tensor | None = None,
                cache: dict | None = None, pos: int | None = None,
                backend: str = "auto", tp: TPShard | None = None,
                dp=None, pod=None):
  """Returns (h, aux, cache): aux the block's MoE load-balance term (a
  float32 scalar) or None; ``cache`` is written in place in the prefill
  and decode modes.  ``window`` the attention's sliding window (0: none);
  ``memory`` (B, M, d) the encoder or image memory of a cross block (train
  and prefill); ``pos`` (decode) the new token's position, a Python int;
  ``backend`` picks the attention kernel or its plain version; ``tp`` the
  rank's place on the model axis (``cfg`` then the local config; under
  ``tp.seq`` h is the rank's slice of the sequence, and so is the
  output); ``dp`` the data group h is a shard of, for the MoE routing
  (train mode); ``pod`` the pod group of expert parallelism over pods."""
  if mode not in ("train", "prefill", "decode"):
    raise ValueError(f"mode {mode!r}")
  if btype not in BLOCKS:
    raise ValueError(f"block {btype!r} not in {BLOCKS}")
  if btype == "mamba":   # no FFN
    return _recurrent(h, p, cfg, mode=mode, cache=cache,
                      block=SSM.mamba_block, sub=p.mamba, tp=tp), None, cache
  if btype == "rec":
    h = _recurrent(h, p, cfg, mode=mode, cache=cache,
                   block=RG.recurrent_block, sub=p.rec, tp=tp)
  else:
    length = h.shape[1] * (tp.group.world if tp is not None and tp.seq
                           else 1)
    positions = (torch.full((1,), pos, dtype=torch.int32, device=h.device)
                 if mode == "decode" else
                 torch.arange(length, device=h.device))
    h = _attention(h, p, cfg, mode=mode, window=window, cache=cache,
                   pos=pos, positions=positions, backend=backend, tp=tp)
    if btype == "cross":
      h = _cross(h, p, cfg, mode=mode, memory=memory, cache=cache,
                 positions=positions, tp=tp)
  h, aux = _ffn(h, p, cfg, tp, dp, pod)
  return h, aux, cache
