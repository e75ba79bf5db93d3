"""Model: init / train forward and loss / prefill / decode for every
architecture, and its layout over a training mesh (the port of
``src/repro/models/registry.py``).

``Model`` wires the embedding -> one block module per layer (the config's
pattern repeated, remainder layers included) -> final norm -> LM head, and
for the enc-dec family a bidirectional encoder whose output is the cross
blocks' memory (``Encoder``, the reference's ``_encode``; the VLM's memory
is the batch's ``img_embeds``). It is an ``nn.Module`` whose parameters
are drawn on ``device`` from a ``torch.Generator`` with the reference's
distributions (its own draws; ``interop.lm_params`` carries the
reference's across).

Training: ``apply_train`` returns (logits, aux) and ``loss_fn`` (xent +
aux, {"xent", "aux"}), aux the MoE load-balance terms summed over layers
(0 without MoE).  ``loss_fn`` is the reference's sequence-chunked
cross-entropy (the (B, S, V) logits never exist at once), and under
autograd every layer runs inside ``torch.utils.checkpoint`` by the
``remat`` policy ("dots" keeps the matmul outputs, "full" keeps nothing).
Attention under autograd takes ``chunked_attention``
(``attention.self_attention``'s rule); a forward under ``torch.no_grad()``
launches the flash kernel for every causal, unwindowed layer.

Layout: ``Parallelism`` and ``param_specs`` are the reference's, keyed by
the port's parameter names (shapes from the config, ``param_shapes``; the
stacked experts by the reference's ``ep`` / ``ep_pod`` rule).  Given a
``launch.mesh.TrainMesh``, a ``Model`` holds only its rank's slices by
those specs and runs the model axis as tensor parallelism for every
family: ``wq`` / ``wk`` / ``wv`` / ``gate`` / ``up`` split by column (whole
query heads: ``n_heads`` must be a multiple of the axis; KV heads whole
too, or gathered inside a head where they are fewer than the ranks),
``wo`` / ``down`` by row with their products summed over the model group;
the MoE experts by ``d_expert`` or, under ``ep`` (``Model(par=)``), dealt
whole; the Mamba-2 and RG-LRU blocks by heads and channels
(``transformer``'s docstring and its blocks' say how); the embedding by
vocabulary row (a masked lookup summed over the group) and the head by
vocabulary column (``_chunked_xent`` combines the max, the sum of
exponentials and the target's logit over the group, so no rank holds a
(B, chunk, V) block), both replicated where the axis does not divide the
vocabulary.  Every sum is the group's rank-ordered sum
(``ProcessMesh.sum``), so the replicated activations, and the gradients of
the replicated leaves, have the same bits on every rank of a group.  The
data axis is the train step's (``train.train_step``); in training each
rank routes its MoE groups as the whole batch's (``moe.moe_ffn``'s ``dp``:
the groups cut from the global token count, f_e meaned over the group),
so the data axis trains what one process does on the whole batch.
``fsdp``, ``seq_shard`` and ``ep_pod`` are spec-only (``check_supported``
refuses them; ``launch/dryrun.py`` is to use them); ``_act`` is a GSPMD
layout constraint with no runtime counterpart: a rank's activations are
already laid out by the data it is handed.  ``cache_specs`` belongs to
``launch/dryrun.py`` (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, enter_group,
                                       gather_group, leave_group, rms_norm,
                                       token_nll)
from repro_torch.models.attention import chunked_attention
from repro_torch.models.rglru import lru_width
from repro_torch.models.ssm import mamba_shapes
from repro_torch.models.ssm import n_heads as ssm_heads
from repro_torch.models.transformer import (TPShard, _attn_out, _ffn,
                                            _project_qkv, apply_block,
                                            block_shapes, init_block,
                                            init_block_cache)


def check_supported(cfg: ModelConfig, model: int = 1, par=None) -> None:
  """Raise for what the port does not run: the layouts that stay
  spec-only (``fsdp``, ``seq_shard``, ``ep_pod``, a pod axis; ROADMAP.md
  names the slice that runs them) as NotImplementedError, and a model
  axis of ``model`` ranks that does not divide the architecture
  (``check_model_axis``)."""
  if par is not None:
    spec_only = [f for f in ("fsdp", "seq_shard", "ep_pod") if getattr(
        par, f)]
    if (spec_only or par.model_axis != "model"
        or tuple(par.dp_axes) not in ((), ("data",))):
      raise NotImplementedError(
          f"{cfg.name}: {', '.join(spec_only) or 'a pod axis'} is "
          f"spec-only in the port (par {par}); it runs the ('data', "
          "'model') mesh with tensor parallelism and, for MoE, ep.  "
          "ROADMAP.md lists the slice that runs the rest")
  check_model_axis(cfg, model)


# ---------------------------------------------------------------------------
# the layout: Parallelism and param_specs (the reference's rules, by name)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Parallelism:
  """The reference's ``Parallelism``, every field and default."""
  dp_axes: tuple = ("data",)
  model_axis: str = "model"
  ep: bool = False      # shard MoE experts on model_axis (E % axis == 0)
  fsdp: bool = False    # additionally shard params over dp_axes (ZeRO-3)
  dp_size: int = 0      # product of dp axis sizes (fsdp divisibility)
  min_fsdp_size: int = 1 << 20  # don't bother sharding small leaves
  seq_shard: bool = False  # sequence parallelism of the residual stream
  model_size: int = 0      # model axis size (divisibility checks)
  ep_pod: bool = False     # expert parallelism over the pod axis
  dp_axis_sizes: tuple = ()  # per-axis sizes matching dp_axes


def param_shapes(cfg: ModelConfig) -> dict:
  """Every parameter's shape by its ``state_dict`` name, from the config
  alone (nothing is allocated), in the model's order."""
  out = {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,)}
  if not cfg.tie_embeddings:
    out["head"] = (cfg.d_model, cfg.vocab)
  blocks = {bt: block_shapes(bt, cfg) for bt in set(cfg.pattern)}
  for i, bt in enumerate(cfg.full_pattern):
    out.update({f"layers.{i}.{n}": shape for n, shape in blocks[bt].items()})
  if cfg.encoder.n_layers:
    out["encoder.ln_f"] = (cfg.d_model,)
    enc = block_shapes("attn", cfg)
    for j in range(cfg.encoder.n_layers):
      out.update({f"encoder.layers.e{j}.{n}": shape
                  for n, shape in enc.items()})
  return out


_COLUMN = ("wq", "wk", "wv", "gate", "up", "w_in", "w_x", "w_gate", "w_a",
           "w_i")
_ROW = ("wo", "down", "w_out")


def _rule(name: str, ndim: int, par: Parallelism) -> tuple:
  """The reference's ``rule``: a tuple of one entry a dim.  The stacked
  experts (E, d, f) / (E, f, d) go on E over the model axis under ``ep``,
  on E over the pod axis and f over the model axis under ``ep_pod``, and
  on f over the model axis otherwise."""
  mx = par.model_axis
  if name.endswith("embed"):
    base = (mx, None)
  elif name.endswith("head"):
    base = (None, mx)
  elif name.endswith(_COLUMN):
    base = (None, mx)
  elif name.endswith(_ROW):
    base = (mx, None)
  else:
    base = ()
  if (base and ".moe." in f".{name}" and ".shared." not in name
      and name.endswith(("gate", "up", "down"))):
    column = name.endswith(("gate", "up"))
    if par.ep:
      base = (mx, None, None)
    elif par.ep_pod:
      base = ("pod", None, mx) if column else ("pod", mx, None)
    else:
      base = (None, None, mx) if column else (None, mx, None)
  return (None,) * (ndim - len(base)) + base


def _add_fsdp(spec: tuple, shape, par: Parallelism) -> tuple:
  """The reference's ``add_fsdp``: shard the largest not-yet-sharded dim
  over the dp axes (ZeRO-3), dp axes the spec already uses excluded."""
  size = 1
  for s in shape:
    size *= s
  if not par.fsdp or par.dp_size <= 1 or size < par.min_fsdp_size:
    return spec
  used = {a for e in spec
          for a in (e if isinstance(e, (tuple, list)) else (e,))
          if a is not None}
  sizes = (dict(zip(par.dp_axes, par.dp_axis_sizes)) if par.dp_axis_sizes
           else {a: 0 for a in par.dp_axes})
  avail = tuple(a for a in par.dp_axes if a not in used)
  if not avail:
    return spec
  if len(avail) == len(par.dp_axes):
    asz = par.dp_size
  else:
    asz = 1
    for a in avail:
      if not sizes.get(a):
        return spec  # unknown partial size: skip rather than guess
      asz *= sizes[a]
  dims = list(spec) + [None] * (len(shape) - len(spec))
  cands = [(shape[i], i) for i in range(len(shape))
           if dims[i] is None and asz > 1 and shape[i] % asz == 0]
  if not cands:
    return spec
  _, i = max(cands)
  dims[i] = avail if len(avail) > 1 else avail[0]  # PartitionSpec's form
  return tuple(dims)


def _check_divisibility(spec: tuple, shape, par: Parallelism) -> tuple:
  """The reference's ``_check_divisibility``: drop a split whose dim the
  axis size does not divide (a vocab of 50280 on a 16-way axis stays
  replicated)."""
  def axis_size(entry) -> int:
    if entry is None:
      return 1
    if isinstance(entry, (tuple, list)):
      return max(par.dp_size, 1) if tuple(entry) == tuple(par.dp_axes) else 0
    if entry == par.model_axis:
      return max(par.model_size, 1)
    if (entry,) == tuple(par.dp_axes):
      return max(par.dp_size, 1)
    return 0

  dims = list(spec) + [None] * (len(shape) - len(spec))
  out = []
  for size, entry in zip(shape, dims):
    asz = axis_size(entry)
    if entry is not None and asz > 1 and size % asz != 0:
      entry = None
    out.append(entry)
  return tuple(out)


def _stacked(cfg: ModelConfig, name: str) -> bool:
  """Whether the reference stacks this leaf over the periods (a layer of
  the periodic part; the remainder layers, the encoder and the embedding
  are leaves of their own)."""
  if not name.startswith("layers."):
    return False
  return int(name.split(".")[1]) < cfg.n_periods * len(cfg.pattern)


def param_specs(cfg: ModelConfig, par: Parallelism = Parallelism()) -> dict:
  """The reference's ``Model.param_specs`` keyed by the port's parameter
  names: a tuple a leaf, one entry a dim (None, an axis name, or a tuple
  of dp axes), from ``param_shapes``.  A layer of the periodic part is
  ruled as the reference rules its stacked (n_periods, ...) leaf (fsdp's
  size threshold and its choice of dim see the period dim too), then the
  period dim's entry is dropped."""
  out = {}
  for name, shape in param_shapes(cfg).items():
    lead = (cfg.n_periods,) if _stacked(cfg, name) else ()
    full = lead + tuple(shape)
    spec = _check_divisibility(
        _add_fsdp(_rule(name, len(full), par), full, par), full, par)
    out[name] = spec[len(lead):]
  return out


def check_model_axis(cfg: ModelConfig, model: int) -> None:
  """Raise unless a model axis of ``model`` ranks divides what it splits:
  the query heads, by whole heads (a query head is never split); the KV
  heads, by whole heads or (fewer KV heads than ranks) with each rank's
  query heads inside one KV head's group; the SSM heads and ``w_in``'s
  columns; the RG-LRU width."""
  if model <= 1:
    return
  hq, hkv = cfg.n_heads, cfg.n_kv_heads
  if hq % model or (hkv % model and (model % hkv or hkv * cfg.head_dim
                                     % model)):
    raise ValueError(
        f"{cfg.name}: the model axis splits attention by whole query "
        f"heads, so n_heads ({hq}) must be a multiple of the model axis "
        f"({model}), and n_kv_heads ({hkv}) a multiple or a divisor of it; "
        "a query head is never split")
  blocks = set(cfg.full_pattern)
  if "mamba" in blocks:
    width = mamba_shapes(cfg)["w_in"][1]
    if ssm_heads(cfg) % model or width % model:
      raise ValueError(
          f"{cfg.name}: the model axis splits the SSM heads "
          f"({ssm_heads(cfg)}) and w_in's {width} columns; both must be "
          f"multiples of the model axis ({model})")
  if "rec" in blocks and lru_width(cfg) % model:
    raise ValueError(
        f"{cfg.name}: the model axis splits the RG-LRU width "
        f"({lru_width(cfg)}); it must be a multiple of {model}")


def mesh_parallelism(cfg: ModelConfig, mesh, ep: bool = False
                     ) -> Parallelism:
  """The layout a ``Model`` runs over ``mesh`` (None: one device): the
  launcher's ``Parallelism(dp_axes=("data",), dp_size=D)`` with
  ``model_size=M`` (and ``ep``, the MoE experts dealt whole over the model
  axis).  Raises for a model axis that does not divide the architecture
  (``check_model_axis``)."""
  if mesh is None:
    return Parallelism(ep=ep)
  check_model_axis(cfg, mesh.model)
  return Parallelism(dp_axes=("data",), dp_size=mesh.data,
                     model_size=mesh.model, ep=ep)


def _splits(specs: dict, suffix: str) -> bool:
  """Whether the leaves named ``*suffix`` are split over the model axis
  (False where the model has none)."""
  return any("model" in spec for n, spec in specs.items()
             if n.endswith(suffix))


# the matmuls the "dots" policy keeps (the reference's
# dots_with_no_batch_dims_saveable, here with the batched attention products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
  return (CheckpointPolicy.MUST_SAVE if op in _DOTS
          else CheckpointPolicy.PREFER_RECOMPUTE)


REMATS = (None, "dots", "full")


class Model(nn.Module):
  def __init__(self, cfg: ModelConfig, *, device="cuda",
               generator: torch.Generator | None = None,
               backend: str = "auto", remat: str | None = "dots",
               mesh=None, par: Parallelism | None = None):
    """``device`` defaults to the card and raises without one unless
    "cpu" is asked for; ``generator`` (on ``device``; seed 0 when None)
    draws the weights; ``backend`` ("auto" | "cuda" | "ref") picks the
    attention kernel or its plain version, as for every kernel; ``remat``
    (None | "dots" | "full") is the activation checkpointing of a layer
    under autograd ("dots" keeps the matmul outputs, "full" recomputes
    everything in the backward pass).

    ``mesh`` (a ``launch.mesh.TrainMesh``) lays the parameters out by
    ``param_specs`` of the layout ``par`` (by default
    ``mesh_parallelism(cfg, mesh)``; a caller may set ``ep``, the
    reference's expert parallelism, and nothing else of the mesh's
    layout): each leaf is drawn whole, as on one device, and the rank
    keeps its slice, so the model's values are the one-device model's
    whatever the mesh."""
    super().__init__()
    base = mesh_parallelism(cfg, mesh, ep=bool(par is not None and par.ep))
    check_supported(cfg, 1 if mesh is None else mesh.model, par)
    if par is not None and par != base:
      raise ValueError(f"par={par}: over this mesh the model runs {base} "
                       "(only ep is the caller's to set)")
    if remat not in REMATS:
      raise ValueError(f"remat {remat!r} not in {REMATS}")
    dev = resolve_device(device)
    self.cfg = cfg
    self.backend = backend
    self.remat = remat
    self.mesh = mesh
    self.par = base
    self.specs = param_specs(cfg, self.par)
    self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    split = mesh is not None and mesh.model > 1
    self.tp = mesh.tp if split else None
    # the data group a training forward's MoE routes over (None: one rank)
    self.dp = mesh.dp if mesh is not None and mesh.data > 1 else None
    self.vocab_split = split and self.specs["embed"][0] is not None
    self.shard = None
    self.lcfg = cfg
    if split:
      m = mesh.model
      mlp = _splits(self.specs, ".mlp.gate")
      kv_gather = bool(cfg.n_kv_heads % m)
      experts = (("ep" if self.par.ep else "tp")
                 if _splits(self.specs, ".moe.gate") else None)
      self.shard = TPShard(self.tp, mlp,
                           shared=_splits(self.specs, ".moe.shared.gate"),
                           experts=experts, kv_gather=kv_gather,
                           kv_head=self.tp.rank * cfg.n_kv_heads // m)
      # the block config a rank runs: its query heads, the KV heads it
      # reads (and MLP columns)
      self.lcfg = dataclasses.replace(
          cfg, n_heads=cfg.n_heads // m,
          n_kv_heads=1 if kv_gather else cfg.n_kv_heads // m,
          d_ff=cfg.d_ff // m if mlp else cfg.d_ff)
    if generator is None:
      generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=generator, device=dev)
    dt = self.dtype
    self.embed = nn.Parameter(self._keep("embed", embed_init(
        (cfg.vocab, cfg.d_model), dt, **kw)))
    self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), device=dev))
    if not cfg.tie_embeddings:
      self.head = nn.Parameter(self._keep("head", dense_init(
          (cfg.d_model, cfg.vocab), dt, **kw)))
    self.layers = nn.ModuleList()
    for i, bt in enumerate(cfg.full_pattern):
      layer = init_block(bt, cfg, dt, **kw)
      for name, p in layer.named_parameters():
        p.data = self._keep(f"layers.{i}.{name}", p.data)
      self.layers.append(layer)
    if cfg.encoder.n_layers:
      self.encoder = Encoder(cfg, dt, **kw)
      for name, p in self.encoder.named_parameters():
        p.data = self._keep(f"encoder.{name}", p.data)
    # leaves split over the model axis, and the replicated leaves used
    # inside a split region, whose gradients are partial on each rank: the
    # qk-norm gains (the replicated leaves a rank reads by slice enter
    # through split_group, whose backward already gathers their whole
    # gradient, and those every rank reads whole inside a split block
    # through enter_group, whose backward sums it)
    self.sharded = frozenset(n for n, spec in self.specs.items()
                             if split and "model" in spec)
    self.partial_leaves = tuple(
        n for n in self.specs
        if split and n.endswith(("attn.q_norm", "attn.k_norm")))

  def _keep(self, name: str, full: torch.Tensor) -> torch.Tensor:
    """The rank's slice of a whole leaf (a copy; the leaf itself without a
    model axis)."""
    if self.tp is None:
      return full
    return self.mesh.local(full, self.specs[name]).clone(
        memory_format=torch.contiguous_format)

  def param_specs(self, par: Parallelism | None = None) -> dict:
    """``param_specs(cfg, par)``; the model's own layout by default."""
    return param_specs(self.cfg, self.par if par is None else par)

  @property
  def device(self) -> torch.device:
    return self.embed.device

  def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding lookup; over a vocabulary split each rank looks up
    the tokens in its rows (zeros elsewhere) and the group sums them."""
    if not self.vocab_split:
      return self.embed[tokens]
    rows = self.embed.shape[0]
    local = tokens - self.tp.rank * rows
    ok = (local >= 0) & (local < rows)
    h = self.embed[local.clamp(0, rows - 1)].masked_fill(~ok[..., None], 0)
    return leave_group(h, self.tp)

  def _head(self) -> torch.Tensor:
    return self.embed.T if self.cfg.tie_embeddings else self.head

  def _logits(self, h: torch.Tensor) -> torch.Tensor:
    """Final norm and head: the whole (..., V) logits on every rank (over a
    vocabulary split, the rank's columns gathered)."""
    cfg = self.cfg
    h = rms_norm(h, self.ln_f, cfg.rmsnorm_eps)
    if not self.vocab_split:
      return h @ self._head()
    return gather_group(enter_group(h, self.tp) @ self._head(), self.tp)

  def _train_block(self, btype: str, h: torch.Tensor, layer, window: int,
                   memory):
    h, aux, _ = apply_block(btype, h, layer, self.lcfg, mode="train",
                            window=window, memory=memory,
                            backend=self.backend, tp=self.shard, dp=self.dp)
    # checkpoint hands back tensors: an MLP block's aux (None) as a zero
    return h, (torch.zeros((), device=h.device) if aux is None else aux)

  def _window(self, btype: str) -> int:
    """The reference's ``win``: the sliding window of an "attn" block."""
    cfg = self.cfg
    return cfg.sliding_window if btype == "attn" and cfg.sliding_window else 0

  def _stack(self, h, *, mode, caches=None, pos=None, memory=None):
    """Every layer in order; returns (h, aux summed over the layers)."""
    remat = (mode == "train" and self.remat is not None
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (bt, layer) in enumerate(zip(self.cfg.full_pattern, self.layers)):
      win = self._window(bt)
      if remat:  # "full": checkpoint's default keeps only the inputs
        h, a = checkpoint(self._train_block, bt, h, layer, win, memory,
                          use_reentrant=False,
                          **({"context_fn": functools.partial(
                              create_selective_checkpoint_contexts,
                              _keep_dots)} if self.remat == "dots" else {}))
      else:
        h, a, _ = apply_block(bt, h, layer, self.lcfg, mode=mode, window=win,
                              memory=memory,
                              cache=None if caches is None else caches[i],
                              pos=pos, backend=self.backend, tp=self.shard,
                              dp=self.dp if mode == "train" else None)
      if a is not None:
        aux = aux + a
    return h, aux

  def memory(self, batch: dict) -> torch.Tensor | None:
    """The cross blocks' memory (the reference's ``_memory``): the encoder
    over ``batch["frames"]`` (B, F, d) for the enc-dec family, the VLM's
    ``batch["img_embeds"]`` (B, M, d) in the model dtype, None otherwise."""
    if self.cfg.family == "encdec":
      return self.encoder(batch["frames"], self.lcfg, self.shard)
    if self.cfg.family == "vlm":
      return batch["img_embeds"].to(self.dtype)
    return None

  def _xent_chunk(self, h, labels, mask) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk: the final norm, the head
    and the logsumexp, the (B, chunk, V) logits in float32.  Over a
    vocabulary split the rank projects its columns only and the max, the
    sum of exponentials and the target's logit are combined over the
    group."""
    if not self.vocab_split:
      return (token_nll(self._logits(h), labels) * mask).sum()
    tp = self.tp
    h = enter_group(rms_norm(h, self.ln_f, self.cfg.rmsnorm_eps), tp)
    logits = (h @ self._head()).float()
    cols = logits.shape[-1]
    top = tp.max(logits.detach().amax(dim=-1))
    z = leave_group(torch.exp(logits - top[..., None]).sum(dim=-1), tp)
    local = labels - tp.rank * cols
    ok = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None].long())
    gold = leave_group(gold[..., 0].masked_fill(~ok, 0.0), tp)
    return ((torch.log(z) + top - gold) * mask).sum()

  def _chunked_xent(self, h, labels, mask, chunk: int) -> torch.Tensor:
    """Sequence-chunked cross-entropy: each (B, chunk, V) slice of the
    logits is projected and reduced (and, under autograd, recomputed in
    the backward pass), so the (B, S, V) logits never exist at once.
    ``chunk = s`` when it does not divide s (the reference's rule)."""
    b, s, _ = h.shape
    if mask is None:
      mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    chunk = min(chunk, s)
    if s % chunk:
      chunk = s
    grad = torch.is_grad_enabled()
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
      part = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
              mask[:, c0:c0 + chunk])
      nll_sum = nll_sum + (
          checkpoint(self._xent_chunk, *part, use_reentrant=False) if grad
          else self._xent_chunk(*part))
    return nll_sum / mask.sum().clamp_min(1.0)

  # --------------------------------------------------------------- public
  def apply_train(self, batch: dict):
    """tokens (B, S) [+ frames / img_embeds] -> (logits (B, S, V), aux),
    teacher forcing; aux the MoE load-balance terms summed over layers
    (a float32 zero without MoE).  Under autograd the layers follow
    ``remat`` and attention runs ``chunked_attention``; under
    ``torch.no_grad()`` attention launches the kernel."""
    memory = self.memory(batch)
    h = self._embed(batch["tokens"])
    h, aux = self._stack(h, mode="train", memory=memory)
    return self._logits(h), aux

  def loss_fn(self, batch: dict, *, loss_chunk: int = 512):
    """batch: tokens, labels (B, S) [+ mask (B, S) float32, frames,
    img_embeds] -> (xent + aux, {"xent", "aux"}): the mean masked token
    cross-entropy through ``_chunked_xent`` and the MoE load-balance terms
    summed over layers (0 without MoE)."""
    memory = self.memory(batch)
    h = self._embed(batch["tokens"])
    h, aux = self._stack(h, mode="train", memory=memory)
    xent = self._chunked_xent(h, batch["labels"], batch.get("mask"),
                              loss_chunk)
    return xent + aux, {"xent": xent, "aux": aux}

  def init_cache(self, batch_size: int, max_len: int,
                 memory: torch.Tensor | None = None) -> list[dict]:
    """One cache dict per layer, on the model's device: an attention
    layer's k, v, kpos (the rank's KV heads; the window's rows as a ring
    in the hybrid family), a cross layer's memory K/V too (``memory``'s
    length), a recurrent layer's conv and h."""
    ranks = 1 if self.tp is None else self.tp.world
    return [init_block_cache(bt, self.lcfg, batch_size, max_len, self.dtype,
                             self.device, memory, ranks)
            for bt in self.cfg.full_pattern]

  @torch.no_grad()
  def prefill(self, batch: dict, caches: list[dict],
              memory: torch.Tensor | None = None):
    """Fill ``caches`` (in place) from the prompt ``batch["tokens"]``
    (B, S) (and the memory: ``memory`` if given, else ``self.memory
    (batch)``); returns (last-token logits (B, V), caches)."""
    if memory is None:
      memory = self.memory(batch)
    h = self._embed(batch["tokens"])
    h, _ = self._stack(h, mode="prefill", caches=caches, memory=memory)
    return self._logits(h[:, -1:])[:, 0], caches

  @torch.no_grad()
  def decode_step(self, token: torch.Tensor, pos: int, caches: list[dict]):
    """token (B, 1) at position ``pos`` (a Python int) against the caches,
    written in place; returns (logits (B, V), caches)."""
    h = self._embed(token)
    h, _ = self._stack(h, mode="decode", caches=caches, pos=int(pos))
    return self._logits(h)[:, 0], caches


class Encoder(nn.Module):
  """The enc-dec family's bidirectional encoder (the reference's
  ``_encode``): ``layers`` e0 .. e{n-1}, each an "attn" block's parameters
  run with ``chunked_attention(causal=False)`` (never the kernel, as in
  the reference), then the final norm ``ln_f``.  Frames (B, F, d) are the
  stubbed modality frontend's embeddings.  Over a model axis the layers
  hold their rank's heads and MLP columns (``forward``'s ``tp``, the
  rank's local config ``lcfg``) as the decoder's "attn" blocks do."""

  def __init__(self, cfg: ModelConfig, dtype, *, generator, device):
    super().__init__()
    self.cfg = cfg
    self.dtype = dtype
    self.layers = nn.ModuleDict({
        f"e{j}": init_block("attn", cfg, dtype, generator=generator,
                            device=device)
        for j in range(cfg.encoder.n_layers)})
    self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), device=device))

  def forward(self, frames: torch.Tensor, lcfg: ModelConfig | None = None,
              tp: TPShard | None = None) -> torch.Tensor:
    cfg = self.cfg if lcfg is None else lcfg
    group = None if tp is None else tp.group
    h = frames.to(self.dtype)
    for p in self.layers.values():
      x = enter_group(rms_norm(h, p.ln1, cfg.rmsnorm_eps), group)
      b, s, _ = x.shape
      q, k, v = _project_qkv(x, p.attn, cfg,
                             torch.arange(s, device=x.device), tp)
      out = _attn_out(chunked_attention(q, k, v, causal=False), p.attn, b, s)
      h = h + leave_group(out, group)
      h, _ = _ffn(h, p, cfg, tp)
    return rms_norm(h, self.ln_f, cfg.rmsnorm_eps)


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None,
                backend: str = "auto", remat: str | None = "dots",
                mesh=None, par: Parallelism | None = None) -> Model:
  return Model(cfg, device=device, generator=generator, backend=backend,
               remat=remat, mesh=mesh, par=par)
