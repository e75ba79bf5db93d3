"""Carrying data across between the JAX reference and the port.

The system has no weights; what crosses over is data: the ground set's
features, the partition permutation the reference drew (``random_partition``
returns it as an (m, ceil(n/m)) int32 array with -1 padding), global
document ids, objective states the reference built part way through a
greedy run (``ig_state``/``ig_shard_state``/``satcov_state``/``cut_state``),
the draw tables of the random greedy modes built from the reference's key
chain (``rank_table``/``keep_table``), the selection service's host
bound table (``bound_table``) and its standing sieves (``sieve_state``), and
for the LM substrate the reference's parameters, gradients and optimizer
state keyed by the port's parameter names (``lm_tree``, ``lm_params``,
``opt_state``) and its parameter specs (``lm_specs``).  These helpers take the
reference's numpy arrays to tensors on a given device, and a port result
back to numpy with the reference's dtypes (int32 ids), so one test can run
both sides on the same data, the same partition and the same state.
Nothing here imports JAX: callers pass ``np.asarray(jax_array)`` (or a
state NamedTuple whose leaves are numpy arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.objectives import (CutState, IGShardState, IGState,
                                        SatCovState)
from repro_torch.models.registry import Model
from repro_torch.service.store import SieveState
from repro_torch.train.optimizer import OptState


def features(x, device="cpu", dtype=torch.float32) -> torch.Tensor:
  """(n, d) features as a contiguous tensor on ``device``."""
  return torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()


def perm(p, device="cpu") -> torch.Tensor:
  """A ``random_partition`` perm ((m, npp) or flat, -1 padding) as int64."""
  return torch.as_tensor(np.asarray(p).astype(np.int64), device=device)


def gids(g, device="cpu") -> torch.Tensor:
  """Global document ids (-1 = hole) as int64."""
  return torch.as_tensor(np.asarray(g).astype(np.int64), device=device)


def to_numpy(result):
  """A port ``GreediResult``/``GreedyResult`` (or any NamedTuple of
  tensors, nested states included) as the same NamedTuple of numpy arrays;
  int64 ids become the reference's int32."""
  if isinstance(result, torch.Tensor):
    a = result.detach().cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a
  if isinstance(result, tuple):
    return type(result)(*(to_numpy(x) for x in result))
  return result


def ig_state(state, device="cpu") -> IGState:
  """A reference ``IGState`` (sel_feats, count, chol, value as numpy
  arrays, optionally with a leading partition axis) as the port's; the
  int32 count becomes int64."""
  return IGState(features(state.sel_feats, device),
                 torch.as_tensor(np.asarray(state.count).astype(np.int64),
                                 device=device),
                 features(state.chol, device),
                 torch.as_tensor(np.array(state.value, np.float32),
                                 device=device))


def ig_shard_state(state, device="cpu") -> IGShardState:
  """A reference ``IGShardState`` (inner ``IGState``, n_live) as the
  port's."""
  return IGShardState(ig_state(state.inner, device),
                      torch.as_tensor(np.array(state.n_live, np.float32),
                                      device=device))


def satcov_state(state, device="cpu") -> SatCovState:
  """A reference ``SatCovState`` (cover, cap, eval_feats, eval_mask, value
  as numpy arrays, optionally with a leading partition axis) as the
  port's."""
  return SatCovState(features(state.cover, device),
                     features(state.cap, device),
                     features(state.eval_feats, device),
                     features(state.eval_mask, device),
                     torch.as_tensor(np.array(state.value, np.float32),
                                     device=device))


def cut_state(state, device="cpu") -> CutState:
  """A reference ``CutState`` (w, in_s, value as numpy arrays) as the
  port's, over the whole graph (``ind`` None); the indicator and the value
  become float32."""
  return CutState(features(np.asarray(state.w, np.float32), device),
                  torch.as_tensor(np.array(state.in_s, np.float32),
                                  device=device),
                  torch.as_tensor(np.array(state.value, np.float32),
                                  device=device))


def rank_table(t, device="cpu") -> torch.Tensor:
  """A ((P,) k, kk) table of RandomGreedy ranks (``greedy(draws=...)`` in
  mode "random") as int64."""
  return torch.as_tensor(np.asarray(t).astype(np.int64), device=device)


def keep_table(t, device="cpu") -> torch.Tensor:
  """A ((P,) k, n) table of stochastic-greedy samples (mode "stochastic")
  as bool."""
  return torch.as_tensor(np.asarray(t).astype(bool), device=device)


def bound_table(ubound, device="cpu") -> torch.Tensor:
  """The reference store's host ``ubound`` (float64, the sum of its
  double-float pair) as the port's float64 table on ``device``."""
  return torch.as_tensor(np.asarray(ubound, np.float64), device=device)


def sieve_state(state, device="cpu") -> SieveState:
  """A reference store's ``sieve_state_host()`` (gid, gain, feat, count,
  delta, jtop as numpy arrays) as the port's ``SieveState``, int32 ids,
  counts and exponents as int64; ``CorpusStore.set_sieve_state`` takes
  it."""
  gid, gain, feat, cnt, delta, jtop = (np.asarray(x) for x in state)

  def as64(a):
    return torch.as_tensor(a.astype(np.int64), device=device)

  return SieveState(as64(gid), torch.as_tensor(gain.astype(np.float32),
                                               device=device),
                    features(feat.astype(np.float32), device), as64(cnt),
                    torch.as_tensor(delta.astype(np.float32), device=device),
                    as64(jtop))


def tensor(a) -> torch.Tensor:
  """A numpy array (or array-like) as a CPU tensor of the same dtype.  A
  bfloat16 array (``ml_dtypes``, what ``np.asarray`` gives for a JAX bf16
  array, and which ``torch.as_tensor`` refuses) crosses as its uint16 bits
  and is re-viewed as ``torch.bfloat16``: bit-exact, no float32 detour."""
  a = np.array(a)
  if a.dtype.name == "bfloat16":
    return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def _by_name(cfg, tree: dict, leaf_of) -> dict:
  """The leaves of a pytree shaped like the reference's ``Model.init``
  parameters keyed by the port's parameter names: ``leaf_of(leaf, index)``
  with ``index`` the period of a stacked ``periods/b{j}/...`` leaf (period
  t, block j is layer t * len(pattern) + j), None elsewhere; ``rem/r{j}``
  maps to the layers after the periods, ``encoder/layers/e{j}/...`` and
  ``encoder/ln_f`` to ``encoder.layers.e{j}....`` and ``encoder.ln_f``.
  Every block's leaves keep their names (the stacked experts ``moe.gate``
  (E, d, f), ``moe.shared.*``, ``moe.router``, ``rec.*``, ``mamba.*``,
  ``lnx``, ``xattn.*``)."""
  width = len(cfg.pattern)
  out = {}

  def walk(prefix: str, sub: dict, index=None) -> None:
    for name, leaf in sub.items():
      if isinstance(leaf, dict):
        walk(f"{prefix}{name}.", leaf, index)
      else:
        out[prefix + name] = leaf_of(leaf, index)

  walk("", {n: tree[n] for n in ("embed", "ln_f", "head", "encoder")
            if n in tree})
  periods, rem = tree.get("periods") or {}, tree.get("rem") or {}
  for t in range(cfg.n_periods):
    for j in range(width):
      if f"b{j}" in periods:
        walk(f"layers.{t * width + j}.", periods[f"b{j}"], t)
  for j in range(cfg.n_remainder):
    if f"r{j}" in rem:
      walk(f"layers.{cfg.n_periods * width + j}.", rem[f"r{j}"])
  return out


def lm_tree(model: Model, tree: dict) -> dict[str, torch.Tensor]:
  """A pytree shaped like the reference's ``Model.init`` parameters
  (params, their gradients, an optimizer's moments; leaves as numpy arrays)
  as a dict keyed by the port's parameter names, CPU tensors of the leaves'
  dtypes (``_by_name``'s mapping)."""
  return _by_name(model.cfg, tree, lambda leaf, index: tensor(
      leaf if index is None else leaf[index]))


def lm_specs(cfg, specs: dict) -> dict[str, tuple]:
  """The reference's ``Model.param_specs`` tree (PartitionSpec leaves) of a
  model with config ``cfg``, keyed by the port's parameter names
  (``_by_name``) as the port's ``param_specs`` spells them: a tuple of
  one entry a dim, a stacked leaf's period dim dropped.  ``cfg`` may be
  the port's or the reference's config (only its pattern and depth are
  read)."""
  return _by_name(cfg, specs, lambda spec, index: tuple(
      spec if index is None else tuple(spec)[1:]))


@torch.no_grad()
def lm_params(model: Model, params: dict) -> Model:
  """Fill ``model`` with the reference's ``Model.init`` pytree (leaves as
  numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``), mapped by
  ``lm_tree``; a model over a training mesh takes its rank's slice of each
  leaf (``TrainMesh.local`` by the model's specs).  Shapes and dtypes must
  match the model's: nothing is cast.  Every parameter of the model must
  be filled.  Returns ``model``.
  """
  state = model.state_dict()
  tree = lm_tree(model, params)
  for name, src in tree.items():
    dst = state[name]
    if model.mesh is not None:
      src = model.mesh.local(src, model.specs[name])
    if src.shape != dst.shape or src.dtype != dst.dtype:
      raise ValueError(f"{name}: reference {tuple(src.shape)} {src.dtype}, "
                       f"port {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)
  missing = sorted(set(state) - set(tree))
  if missing:
    raise ValueError(f"parameters the reference pytree did not fill: "
                     f"{missing}")
  return model


def opt_state(model: Model, state) -> OptState:
  """The reference's ``OptState`` (step, mu, nu; leaves as numpy arrays) as
  the port's, on the model's device: the moments keyed by the port's
  parameter names (``lm_tree``; a rank's slices over a training mesh, as
  ``lm_params``), float32; the int32 step as int64."""
  dev = model.device

  def mine(name, t):
    return (t if model.mesh is None
            else model.mesh.local(t, model.specs[name]))

  def moments(tree):
    return {n: mine(n, t).to(device=dev, dtype=torch.float32).contiguous()
            for n, t in lm_tree(model, tree).items()}

  return OptState(torch.as_tensor(int(np.asarray(state.step)),
                                  dtype=torch.int64, device=dev),
                  moments(state.mu), moments(state.nu))
