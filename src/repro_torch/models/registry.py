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

The dry run's layouts run too, over a mesh of up to three axes (pod x
data x model, ``launch.mesh.TrainMesh``; ``Model(par=)`` sets them):

  * ``fsdp`` (ZeRO-3): a rank keeps only its shard of a leaf past
    ``min_fsdp_size`` (``_add_fsdp``: the largest dim left free, over the
    data axes its spec leaves free) and its moments with it.  A module's
    use gathers the whole leaf just before (``_gathered``: a layer's
    leaves at its entry, inside ``torch.utils.checkpoint``, so the
    recompute gathers again) and drops it after; the whole leaf's
    gradient is reduce-scattered to the shard as soon as the leaf's
    backward is done (``Model.fsdp_grad``: the shard's ``.grad`` is its
    part of the data mean, in the bits of the mean without FSDP), so a
    rank holds whole gradients of one layer at a time.
  * ``seq_shard``: between blocks a rank's residual stream is its 1/M of
    the sequence where S divides by M (the reference's ``_act(seq=True)``
    guard); a block gathers the sequence before its norm and input
    projections (the GEMMs keep their shapes) and reduce-scatters the
    ``wo`` / ``down`` partial products by sequence (``layers.leave``).
  * ``ep_pod``: the experts dealt over the pod group, their width over
    the model axis (``moe.moe_ffn``'s ``pod``).
  * ``cache_specs`` is the reference's, leaf for leaf; serving honours its
    data axes (``serve.generate``: rows split a batch, a batch of one its
    cache length, ``transformer.KVSplit``).  The port keeps its KV-head
    split over the model axis where the reference splits ``head_dim``.
  * A model axis that does not divide the query heads but does the
    projections' columns runs every head on every rank, its caches 1 / M
    of head_dim (``TPShard.heads``).

``_act`` is otherwise a GSPMD layout constraint with no runtime
counterpart: a rank's activations are laid out by the data it is handed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch._dynamo  # noqa: F401  (see below)
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# torch.utils.checkpoint imports torch._dynamo at its first call, and that
# import keeps the frames on the stack at that moment alive for the life of
# the process: the first model a process trains (its parameters, and the
# optimizer state and batches of the frames above it) was never freed.
# Importing it with this module keeps every model's frames off that stack.

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, enter_group,
                                       gather_group, leave, leave_group,
                                       rms_norm, split_group, token_nll)
from repro_torch.models.attention import chunked_attention
from repro_torch.models.rglru import lru_width
from repro_torch.models.ssm import mamba_shapes
from repro_torch.models.ssm import n_heads as ssm_heads
from repro_torch.models.transformer import (Gathered, KVSplit, TPShard,
                                            _attn_out, _ffn, _project_qkv,
                                            _whole, apply_block,
                                            block_shapes, init_block,
                                            init_block_cache)


DP_AXES = ((), ("data",), ("pod", "data"))


def check_supported(cfg: ModelConfig, model: int = 1, par=None) -> None:
  """Raise for what the port does not run: axes other than the
  reference's meshes' (a model axis not named "model", data axes other
  than ``DP_AXES``) as NotImplementedError, and a model axis of ``model``
  ranks that does not divide the architecture (``check_model_axis``).
  ``fsdp``, ``seq_shard``, ``ep`` and ``ep_pod`` all run."""
  if par is not None and (par.model_axis != "model"
                          or tuple(par.dp_axes) not in DP_AXES):
    raise NotImplementedError(
        f"{cfg.name}: par {par} names axes the port's meshes lack; it runs "
        "('data', 'model') and ('pod', 'data', 'model') (ROADMAP.md)")
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


def param_specs(cfg: ModelConfig, par: Parallelism = Parallelism(), *,
                periods: int | None = None) -> dict:
  """The reference's ``Model.param_specs`` keyed by the port's parameter
  names: a tuple a leaf, one entry a dim (None, an axis name, or a tuple
  of dp axes), from ``param_shapes``.  A layer of the periodic part is
  ruled as the reference rules its stacked (n_periods, ...) leaf (fsdp's
  size threshold and its choice of dim see the period dim too), then the
  period dim's entry is dropped.  ``periods`` (default the config's) is
  the period count the rules see: the dry run lays a model cut in depth
  out as the whole one."""
  out = {}
  for name, shape in param_shapes(cfg).items():
    lead = ((periods or cfg.n_periods,) if _stacked(cfg, name) else ())
    full = lead + tuple(shape)
    spec = _check_divisibility(
        _add_fsdp(_rule(name, len(full), par), full, par), full, par)
    out[name] = spec[len(lead):]
  return out


def check_model_axis(cfg: ModelConfig, model: int) -> None:
  """Raise unless a model axis of ``model`` ranks divides what it splits:
  the query heads, by whole heads, and the KV heads, by whole heads or
  (fewer KV heads than ranks) with each rank's query heads inside one KV
  head's group; or else (the query heads not a multiple of the axis) the
  q and KV projections' columns and head_dim, every rank computing every
  head and caching its slice of head_dim (``TPShard.heads``); the SSM
  heads and ``w_in``'s columns; the RG-LRU width."""
  if model <= 1:
    return
  hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
  if hq % model:
    ok = not (hq * dh % model or hkv * dh % model or dh % model)
  else:
    ok = not (hkv % model and (model % hkv or hkv * dh % model))
  if not ok:
    raise ValueError(
        f"{cfg.name}: the model axis splits attention by whole query "
        f"heads (n_heads {hq} a multiple of the model axis {model}, "
        f"n_kv_heads {hkv} a multiple or a divisor of it), or else by the "
        f"projections' columns and head_dim ({hq} x {dh}, {hkv} x {dh} and "
        f"{dh} multiples of {model})")
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


# the fields of a Parallelism a caller chooses; the rest follow the mesh
CHOSEN = ("ep", "ep_pod", "fsdp", "seq_shard", "min_fsdp_size")


def mesh_parallelism(cfg: ModelConfig, mesh, ep: bool = False,
                     **chosen) -> Parallelism:
  """The layout a ``Model`` runs over ``mesh`` (None: one device): the
  launcher's ``Parallelism(dp_axes=("data",), dp_size=D)`` with
  ``model_size=M``, over a pod axis ``dp_axes=("pod", "data")``, ``dp_size
  = P x D`` and ``dp_axis_sizes`` (the reference's ``parallelism_for``
  fields), and the caller's ``ep`` and ``chosen`` (``CHOSEN``: ``ep_pod``,
  ``fsdp``, ``seq_shard``, ``min_fsdp_size``).  Raises for a model axis
  that does not divide the architecture (``check_model_axis``)."""
  if mesh is None:
    return Parallelism(ep=ep, **chosen)
  check_model_axis(cfg, mesh.model)
  if mesh.pod is None:
    return Parallelism(dp_axes=("data",), dp_size=mesh.data,
                       model_size=mesh.model, ep=ep, **chosen)
  return Parallelism(dp_axes=("pod", "data"), dp_size=mesh.dp_size,
                     model_size=mesh.model, ep=ep,
                     dp_axis_sizes=(mesh.pod, mesh.data), **chosen)


_CACHE_LEAVES = {"attn": {"k": 4, "v": 4, "kpos": 1},
                 "cross": {"k": 4, "v": 4, "kpos": 1, "xk": 4, "xv": 4},
                 "rec": {"conv": 3, "h": 2}, "mamba": {"conv": 3, "h": 4}}


def cache_specs(cfg: ModelConfig, par: Parallelism = Parallelism(), *,
                batch_shardable: bool = True) -> dict:
  """The reference's ``Model.cache_specs``, leaf for leaf: its cache tree
  ({"periods": {"b<j>": leaves, stacked over the periods} or None, "rem":
  {"r<j>": leaves}}) with a tuple spec a leaf.  The batch on the data axes
  when it is shardable, else the cache length; ``head_dim`` on the model
  axis where it divides; conv and the SSM / RG-LRU states on the model
  axis.  The port runs the batch and length splits (``Model.init_cache
  (kv_split=)``, ``serve.generate``) and keeps its split of the KV heads
  over the model axis, not the reference's split of ``head_dim``, except
  where the query heads do not divide the axis (``TPShard.heads``)
  (ROADMAP.md)."""
  dp = par.dp_axes
  mx = par.model_axis
  msz = max(par.model_size, 1)

  def rule(name: str, ndim: int, rem: bool) -> tuple:
    bdim = dp if batch_shardable else None
    if name in ("k", "v", "xk", "xv"):
      seq = None if batch_shardable else dp
      base = (bdim, None, seq,
              mx if (msz > 1 and cfg.head_dim % msz == 0) else None)
    elif name == "kpos":
      base = (None,)
    elif name == "conv":
      base = (bdim, None, mx)
    elif name == "h" and ndim - (0 if rem else 1) == 4:
      base = (bdim, mx, None, None)
    elif name == "h":
      base = (bdim, mx)
    else:
      base = ()
    return (None,) * (ndim - len(base)) + base

  def block(bt: str, stacked: bool) -> dict:
    return {n: rule(n, nd + stacked, not stacked)
            for n, nd in _CACHE_LEAVES[bt].items()}

  return {"periods": ({f"b{j}": block(bt, True)
                       for j, bt in enumerate(cfg.pattern)}
                      if cfg.n_periods else None),
          "rem": {f"r{j}": block(cfg.pattern[j], False)
                  for j in range(cfg.n_remainder)}}


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


class _FSDPGather(torch.autograd.Function):
  """A leaf's FSDP shard -> its whole (the model-axis part a rank runs):
  gathered over each data-axis split forward; backward, as soon as the
  whole leaf's gradient is done, its mean over the data ranks
  reduce-scattered to the shard (``Model.fsdp_grad``), so no whole
  gradient outlives the leaf's own backward."""

  @staticmethod
  def forward(ctx, shard, model, name):
    ctx.model, ctx.name = model, name
    whole = shard
    for dim, axes in model.fsdp[name]:
      whole = model.mesh.group(axes).all_gather(whole, dim=dim)
    return whole

  @staticmethod
  def backward(ctx, g):
    return ctx.model.fsdp_grad(ctx.name, g), None, None


class Model(Gathered, nn.Module):
  def __init__(self, cfg: ModelConfig, *, device="cuda",
               generator: torch.Generator | None = None,
               backend: str = "auto", remat: str | None = "dots",
               mesh=None, par: Parallelism | None = None,
               periods: int | None = None):
    """``device`` defaults to the card and raises without one unless
    "cpu" (or "meta", the dry run's: shapes only, nothing drawn) is asked
    for; ``generator`` (on ``device``; seed 0 when None) draws the weights;
    ``backend`` ("auto" | "cuda" | "ref") picks the attention kernel or its
    plain version, as for every kernel; ``remat`` (None | "dots" | "full")
    is the activation checkpointing of a layer under autograd ("dots"
    keeps the matmul outputs, "full" recomputes everything in the backward
    pass).

    ``mesh`` (a ``launch.mesh.TrainMesh``) lays the parameters out by
    ``param_specs`` of the layout ``par`` (by default
    ``mesh_parallelism(cfg, mesh)``; a caller may set the ``CHOSEN``
    fields, ``ep``, ``ep_pod``, ``fsdp``, ``seq_shard`` and
    ``min_fsdp_size``, and nothing else of the mesh's layout): each leaf is
    drawn whole, as on one device, and the rank keeps its part, so the
    model's values are the one-device model's whatever the mesh.
    ``periods`` is ``param_specs``' (the dry run's depth cut)."""
    super().__init__()
    chosen = {} if par is None else {f: getattr(par, f) for f in CHOSEN}
    base = mesh_parallelism(cfg, mesh, **chosen)
    if (par is not None and mesh is not None and par.dp_axis_sizes
        == tuple(mesh.shape[a] for a in base.dp_axes)):
      base = dataclasses.replace(base, dp_axis_sizes=par.dp_axis_sizes)
    check_supported(cfg, 1 if mesh is None else mesh.model, par)
    if par is not None and par != base:
      raise ValueError(f"par={par}: over this mesh the model runs {base} "
                       f"(only {', '.join(CHOSEN)} are the caller's to set)")
    if remat not in REMATS:
      raise ValueError(f"remat {remat!r} not in {REMATS}")
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    self.cfg = cfg
    self.backend = backend
    self.remat = remat
    self.mesh = mesh
    self.par = base
    self.specs = param_specs(cfg, self.par, periods=periods)
    self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    split = mesh is not None and mesh.model > 1
    self.tp = mesh.tp if split else None
    # the data group a training forward's MoE routes over (None: one rank)
    self.dp = mesh.dp if mesh is not None and mesh.dp_size > 1 else None
    # the pod group the experts are dealt over (ep_pod)
    self.pod = (mesh.group(("pod",)) if self.par.ep_pod and mesh is not None
                and mesh.pod and mesh.pod > 1 else None)
    self.vocab_split = split and self.specs["embed"][0] is not None
    self.seq = split and self.par.seq_shard
    self.shard = None
    self.lcfg = cfg
    # FSDP: each leaf's (dim, data axes) splits beyond its model layout,
    # and every leaf's data axes its gradient is averaged over (the data
    # axes its model layout does not deal it over: all but the pod for
    # the experts under ep_pod)
    plain = param_specs(cfg, dataclasses.replace(self.par, fsdp=False),
                        periods=periods)
    self.fsdp, self.mean_axes = {}, {}
    if mesh is not None:
      dp = tuple(a for a in mesh.axis_names if a != "model")
      for n, spec in self.specs.items():
        own = plain[n] + (None,) * (len(spec) - len(plain[n]))
        self.fsdp[n] = [(d, a) for d, a in mesh.splits(spec, len(spec))
                        if own[d] != spec[d]]
        used = {a for _, axes in mesh.splits(plain[n], len(plain[n]))
                for a in axes}
        self.mean_axes[n] = tuple(a for a in dp if a not in used)
      self.fsdp = {n: d for n, d in self.fsdp.items() if d}
    if split:
      m = mesh.model
      mlp = _splits(self.specs, ".mlp.gate")
      heads = bool(cfg.n_heads % m)
      kv_gather = bool(cfg.n_kv_heads % m) and not heads
      experts = (("ep" if self.par.ep else "tp")
                 if _splits(self.specs, ".moe.gate") else None)
      self.shard = TPShard(self.tp, mlp,
                           shared=_splits(self.specs, ".moe.shared.gate"),
                           experts=experts, kv_gather=kv_gather,
                           kv_head=self.tp.rank * cfg.n_kv_heads // m,
                           heads=heads)
      # the block config a rank runs: its query heads, the KV heads it
      # reads (every head under ``heads``; and MLP columns)
      self.lcfg = dataclasses.replace(
          cfg, n_heads=cfg.n_heads if heads else cfg.n_heads // m,
          n_kv_heads=(cfg.n_kv_heads if heads else
                      1 if kv_gather else cfg.n_kv_heads // m),
          d_ff=cfg.d_ff // m if mlp else cfg.d_ff)
    if generator is None and dev.type != "meta":
      generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=generator, device=dev)
    dt = self.dtype
    self.embed = nn.Parameter(self._keep("embed", embed_init(
        (cfg.vocab, cfg.d_model), dt, **kw)))
    self.ln_f = nn.Parameter(self._keep("ln_f", torch.zeros(
        (cfg.d_model,), device=dev)))
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
        if split and not self.shard.heads
        and n.endswith(("attn.q_norm", "attn.k_norm")))
    # the axes each leaf's squares are summed over in the global norm:
    # every axis it is split over (model, the data axes of FSDP, the pod
    # of ep_pod)
    self.norm_axes = {} if mesh is None else {
        n: tuple(axes for _, axes in mesh.splits(spec, len(spec)))
        for n, spec in self.specs.items()}
    self._owners = {n: self._owner(n) for n in self.fsdp}

  def fsdp_grad(self, name: str, whole: torch.Tensor) -> torch.Tensor:
    """An FSDP leaf's shard gradient from its whole gradient on this rank:
    summed over the model group first where the leaf is partial, then
    the mean over its data axes reduce-scattered (the rank-ordered sum /
    P x D, then the slice: the bits the train step's mean over the data
    ranks gives the whole leaf without FSDP, then the rank's part)."""
    mesh = self.mesh
    (dim, axes), = self.fsdp[name]
    if axes != self.mean_axes[name]:
      raise ValueError(f"{name}: FSDP over {axes}, its gradient's mean over "
                       f"{self.mean_axes[name]}")
    if name in self.partial_leaves:
      whole = self.tp.sum(whole)
    return mesh.group(axes).reduce_scatter(whole.contiguous(), dim=dim,
                                           div=mesh.dp_size)

  def _keep(self, name: str, full: torch.Tensor) -> torch.Tensor:
    """The rank's part of a whole leaf (a copy; the leaf itself without a
    mesh or where the spec splits nothing)."""
    if self.mesh is None:
      return full
    part = self.mesh.local(full, self.specs[name])
    if part is full:
      return full
    return part.clone(memory_format=torch.contiguous_format)

  def _owner(self, name: str):
    """(module, attribute) of the parameter ``name``."""
    mod, _, attr = name.rpartition(".")
    return (self.get_submodule(mod) if mod else self), attr

  @contextlib.contextmanager
  def _gathered(self, *names):
    """Within the block, reading an FSDP leaf named in ``names`` (a name or
    the prefix of a module's, e.g. "layers.3") gives its whole, gathered
    once on entry (``_FSDPGather``); the wholes are dropped on exit.
    Nothing happens without FSDP leaves there."""
    hits = [n for n in self.fsdp
            if any(n == p or n.startswith(p + ".") for p in names)]
    for n in hits:
      mod, attr = self._owners[n]
      mod.__dict__.setdefault("_whole", {})[attr] = _FSDPGather.apply(
          mod._parameters[attr], self, n)
    try:
      yield
    finally:
      for n in hits:
        mod, attr = self._owners[n]
        mod.__dict__["_whole"].pop(attr, None)

  def param_specs(self, par: Parallelism | None = None) -> dict:
    """``param_specs(cfg, par)``; the model's own layout by default."""
    return param_specs(self.cfg, self.par if par is None else par)

  def cache_specs(self, par: Parallelism | None = None, *,
                  batch_shardable: bool = True) -> dict:
    """``cache_specs(cfg, par)``; the model's own layout by default."""
    return cache_specs(self.cfg, self.par if par is None else par,
                       batch_shardable=batch_shardable)

  @property
  def device(self) -> torch.device:
    return self.embed.device

  def _shard_tp(self, length: int) -> TPShard | None:
    """The model-axis shard a (B, ``length``, d) call runs with: sequence
    sharded (``seq_shard``) where the length divides by the axis (the
    reference's guard; a decode step's one token never is)."""
    if self.seq and length > 1 and length % self.tp.world == 0:
      return dataclasses.replace(self.shard, seq=True)
    return self.shard

  def _embed(self, tokens: torch.Tensor, tp: TPShard | None = None):
    """The embedding lookup; over a vocabulary split each rank looks up
    the tokens in its rows (zeros elsewhere) and the group sums them
    (under sequence sharding, reduce-scatters them by sequence)."""
    seq = self.tp if tp is not None and tp.seq else None
    with self._gathered("embed"):
      if not self.vocab_split:
        return leave(self.embed[tokens], None, seq)
      rows = self.embed.shape[0]
      local = tokens - self.tp.rank * rows
      ok = (local >= 0) & (local < rows)
      h = self.embed[local.clamp(0, rows - 1)].masked_fill(~ok[..., None],
                                                           0)
    return leave(h, self.tp, seq)

  def _head_name(self) -> str:
    return "embed" if self.cfg.tie_embeddings else "head"

  def _head(self) -> torch.Tensor:
    return self.embed.T if self.cfg.tie_embeddings else self.head

  def _logits(self, h: torch.Tensor) -> torch.Tensor:
    """Final norm and head: the whole (..., V) logits on every rank (over a
    vocabulary split, the rank's columns gathered)."""
    cfg = self.cfg
    with self._gathered("ln_f", self._head_name()):
      h = rms_norm(h, self.ln_f, cfg.rmsnorm_eps)
      if not self.vocab_split:
        return h @ self._head()
      return gather_group(enter_group(h, self.tp) @ self._head(), self.tp)

  def _train_block(self, i: int, btype: str, h: torch.Tensor, layer,
                   window: int, memory, tp):
    with self._gathered(f"layers.{i}"):
      h, aux, _ = apply_block(btype, h, layer, self.lcfg, mode="train",
                              window=window, memory=memory,
                              backend=self.backend, tp=tp, dp=self.dp,
                              pod=self.pod)
    # checkpoint hands back tensors: an MLP block's aux (None) as a zero
    return h, (torch.zeros((), device=h.device) if aux is None else aux)

  def _window(self, btype: str) -> int:
    """The reference's ``win``: the sliding window of an "attn" block."""
    cfg = self.cfg
    return cfg.sliding_window if btype == "attn" and cfg.sliding_window else 0

  def _stack(self, h, *, mode, tp, caches=None, pos=None, memory=None):
    """Every layer in order; returns (h, aux summed over the layers), h
    whole again where the layers ran on sequence slices."""
    remat = (mode == "train" and self.remat is not None
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (bt, layer) in enumerate(zip(self.cfg.full_pattern, self.layers)):
      win = self._window(bt)
      if remat:  # "full": checkpoint's default keeps only the inputs
        h, a = checkpoint(self._train_block, i, bt, h, layer, win, memory,
                          tp, use_reentrant=False,
                          **({"context_fn": functools.partial(
                              create_selective_checkpoint_contexts,
                              _keep_dots)} if self.remat == "dots" else {}))
      else:
        with self._gathered(f"layers.{i}"):
          h, a, _ = apply_block(bt, h, layer, self.lcfg, mode=mode,
                                window=win, memory=memory,
                                cache=None if caches is None else caches[i],
                                pos=pos, backend=self.backend, tp=tp,
                                dp=self.dp if mode == "train" else None,
                                pod=self.pod)
      if a is not None:
        aux = aux + a
    return _whole(h, tp), aux

  def memory(self, batch: dict) -> torch.Tensor | None:
    """The cross blocks' memory (the reference's ``_memory``): the encoder
    over ``batch["frames"]`` (B, F, d) for the enc-dec family, the VLM's
    ``batch["img_embeds"]`` (B, M, d) in the model dtype, None otherwise."""
    if self.cfg.family == "encdec":
      frames = batch["frames"]
      return self.encoder(frames, self.lcfg, self._shard_tp(frames.shape[1]),
                          self._gathered)
    if self.cfg.family == "vlm":
      return batch["img_embeds"].to(self.dtype)
    return None

  def _xent_chunk(self, h, labels, mask, gamma, head) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk: the final norm (gain
    ``gamma``), the head and the logsumexp, the (B, chunk, V) logits in
    float32.  Over a vocabulary split the rank projects its columns only
    and the max, the sum of exponentials and the target's logit are
    combined over the group."""
    h = rms_norm(h, gamma, self.cfg.rmsnorm_eps)
    if not self.vocab_split:
      return (token_nll(h @ head, labels) * mask).sum()
    tp = self.tp
    logits = (enter_group(h, tp) @ head).float()
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
    ``chunk = s`` when it does not divide s (the reference's rule).  The
    final norm's gain and the head are read (gathered, under FSDP) once."""
    b, s, _ = h.shape
    if mask is None:
      mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    chunk = min(chunk, s)
    if s % chunk:
      chunk = s
    grad = torch.is_grad_enabled()
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    with self._gathered("ln_f", self._head_name()):
      gamma, head = self.ln_f, self._head()
      for c0 in range(0, s, chunk):
        part = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], gamma, head)
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
    tp = self._shard_tp(batch["tokens"].shape[1])
    h = self._embed(batch["tokens"], tp)
    h, aux = self._stack(h, mode="train", tp=tp, memory=memory)
    return self._logits(h), aux

  def loss_fn(self, batch: dict, *, loss_chunk: int = 512):
    """batch: tokens, labels (B, S) [+ mask (B, S) float32, frames,
    img_embeds] -> (xent + aux, {"xent", "aux"}): the mean masked token
    cross-entropy through ``_chunked_xent`` and the MoE load-balance terms
    summed over layers (0 without MoE)."""
    memory = self.memory(batch)
    tp = self._shard_tp(batch["tokens"].shape[1])
    h = self._embed(batch["tokens"], tp)
    h, aux = self._stack(h, mode="train", tp=tp, memory=memory)
    xent = self._chunked_xent(h, batch["labels"], batch.get("mask"),
                              loss_chunk)
    return xent + aux, {"xent": xent, "aux": aux}

  def init_cache(self, batch_size: int, max_len: int,
                 memory: torch.Tensor | None = None,
                 kv_split: KVSplit | None = None) -> list[dict]:
    """One cache dict per layer, on the model's device: an attention
    layer's k, v, kpos (the rank's KV heads, or under ``TPShard.heads``
    the rank's slice of every head's head_dim; the window's rows as a ring
    in the hybrid family), a cross layer's memory K/V too (``memory``'s
    length), a recurrent layer's conv and h.  ``kv_split`` (a batch-1
    cache over the data ranks) keeps the rank's slots of the attention
    caches (``transformer.KVSplit``)."""
    ranks = 1 if self.tp is None else self.tp.world
    dh_ranks = ranks if self.shard is not None and self.shard.heads else 1
    return [init_block_cache(bt, self.lcfg, batch_size, max_len, self.dtype,
                             self.device, memory, ranks, kv_split, dh_ranks)
            for bt in self.cfg.full_pattern]

  @torch.no_grad()
  def prefill(self, batch: dict, caches: list[dict],
              memory: torch.Tensor | None = None):
    """Fill ``caches`` (in place) from the prompt ``batch["tokens"]``
    (B, S) (and the memory: ``memory`` if given, else ``self.memory
    (batch)``); returns (last-token logits (B, V), caches)."""
    if memory is None:
      memory = self.memory(batch)
    tp = self._shard_tp(batch["tokens"].shape[1])
    h = self._embed(batch["tokens"], tp)
    h, _ = self._stack(h, mode="prefill", tp=tp, caches=caches,
                       memory=memory)
    return self._logits(h[:, -1:])[:, 0], caches

  @torch.no_grad()
  def decode_step(self, token: torch.Tensor, pos: int, caches: list[dict]):
    """token (B, 1) at position ``pos`` (a Python int) against the caches,
    written in place; returns (logits (B, V), caches)."""
    h = self._embed(token)
    h, _ = self._stack(h, mode="decode", tp=self.shard, caches=caches,
                       pos=int(pos))
    return self._logits(h)[:, 0], caches


class Encoder(Gathered, nn.Module):
  """The enc-dec family's bidirectional encoder (the reference's
  ``_encode``): ``layers`` e0 .. e{n-1}, each an "attn" block's parameters
  run with ``chunked_attention(causal=False)`` (never the kernel, as in
  the reference), then the final norm ``ln_f``.  Frames (B, F, d) are the
  stubbed modality frontend's embeddings.  Over a model axis the layers
  hold their rank's heads and MLP columns (``forward``'s ``tp``, the
  rank's local config ``lcfg``) as the decoder's "attn" blocks do, under
  ``tp.seq`` on the rank's slice of the frames between layers."""

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
              tp: TPShard | None = None, gathered=None) -> torch.Tensor:
    cfg = self.cfg if lcfg is None else lcfg
    gathered = gathered or (lambda *_: contextlib.nullcontext())
    group = None if tp is None else tp.group
    seq = group if tp is not None and tp.seq else None
    h = frames.to(self.dtype)
    if seq is not None:
      h = split_group(h, seq, 1)
    for j, p in self.layers.items():
      with gathered(f"encoder.layers.{j}"):
        x = enter_group(rms_norm(_whole(h, tp), p.ln1, cfg.rmsnorm_eps),
                        group)
        b, s, _ = x.shape
        q, k, v = _project_qkv(x, p.attn, cfg,
                               torch.arange(s, device=x.device), tp)
        out = _attn_out(chunked_attention(q, k, v, causal=False), p.attn, b,
                        s, tp)
        h = h + leave(out, group, seq)
        h, _ = _ffn(h, p, cfg, tp)
    with gathered("encoder.ln_f"):
      return rms_norm(_whole(h, tp), self.ln_f, cfg.rmsnorm_eps)


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None,
                backend: str = "auto", remat: str | None = "dots",
                mesh=None, par: Parallelism | None = None) -> Model:
  return Model(cfg, device=device, generator=generator, backend=backend,
               remat=remat, mesh=mesh, par=par)
