"""Mixture-of-Experts FFN with capacity-based routing (the port of
``src/repro/models/moe.py``).

DeepSeekMoE-style: ``num_shared`` always-on experts plus ``num_experts``
routed experts with top-k gating, the gates renormalised over the top k.
Tokens are taken in groups of ``sg = min(group_size, B * S)`` (the last
group zero-padded; padding tokens neither dispatch nor take capacity).  An
expert takes at most ``cap`` tokens a group: ``sg`` when ``sg <= 32`` (so a
decode step routes exactly), else ``int(sg * k * capacity_factor / E)``.
Priority is token-major, choice-minor: a (token, choice) pair's rank in its
expert is the number of earlier pairs of the group routed there, and the
pairs ranked at ``cap`` or later are dropped.

The reference dispatches through a dense one-hot (G, Sg, E, C) tensor and
einsums; the port keeps the same kept set and scatters each kept token
into its (expert, slot) row of a (G, E * C, d) buffer (a copy: the
reference's one-hot product moves the same value exactly), runs the
experts as batched matmuls over E, and gathers each token's k outputs back
weighted by its gates.  ``route`` is that routing alone (``assign`` its
part after the choice of experts).

Top-k takes a stable descending sort, so tied probabilities go to the
lowest expert index, as ``jax.lax.top_k`` does (``torch.topk`` on CUDA
promises no order among ties).  The GSPMD sharding constraints (``ep_axis``,
``dp_axes``) have no runtime counterpart on one device.

Over a data group (``dp``, a ``launch.mesh.ProcessMesh`` of D ranks, each
holding an equal shard of the batch's rows) a call routes as the
reference's global arrays do: the groups are cut from the global token
count, so a rank's tokens must be a whole number of groups
(``data_group_len``), and each rank's aux term takes the group's mean
routed share f_e (summed over the ranks in rank order) against its own
P_e.  The mean of the ranks' terms is then the global aux, and so is the
mean of their gradients (f_e carries none).

Over a model group (``tp``: ``tp.group``, ``tp.experts`` and
``tp.shared``, a ``transformer.TPShard``) the router is replicated, so
the routing, the drops and the aux term are computed whole on every rank
from the same bits.  The experts are split as ``tp.experts`` says: "tp"
(each expert's ``d_expert`` columns of gate / up and rows of down), "ep"
(a rank holds E / M whole experts, contiguous, and serves the kept pairs
routed to them), or None (replicated, run whole).  The dispatch and the
gates enter the group (``enter_group``: their gradients summed over it),
and each rank's combine, its partial products or its experts' pairs,
leaves it in float32 (``leave_group``), so the pairs of a token are summed
in another order than one process's choice order (a tolerance, not bits).
The shared experts split as the dense MLP does (``tp.shared``); where the
routed experts are split too, their partial product joins the combine's
before the one sum.

Over pods (``pod``, the reference's ``ep_pod``: ``P("pod", None, mx)`` /
``P("pod", mx, None)``) a rank holds E / P experts of its pod (and their
width split over the model axis as "tp"); it routes its own token
groups, fills the dispatch rows of every expert, and an all-to-all over
the pod group (``layers.all_to_all``, its own inverse in the backward
pass) carries each pod's rows to it and the outputs back, pod-major, for
the combine in float32.  The dispatch writes every (token, choice) pair,
a dropped one into a spare row cut off after, so its shapes are fixed:
no host read, and the dry run on meta runs the same path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (all_to_all, dense_init, enter_group,
                                       leave, swiglu)


def moe_shapes(cfg: ModelConfig) -> dict:
  """The MoE leaves' shapes by name under ``moe.``: the router (d, E), the
  stacked experts (E, d, f) / (E, f, d) and the shared experts' SwiGLU (d,
  num_shared * f)."""
  d, e = cfg.d_model, cfg.moe
  out = {"router": (d, e.num_experts),
         "gate": (e.num_experts, d, e.d_expert),
         "up": (e.num_experts, d, e.d_expert),
         "down": (e.num_experts, e.d_expert, d)}
  if e.num_shared:
    fs = e.num_shared * e.d_expert
    out.update({"shared.gate": (d, fs), "shared.up": (d, fs),
                "shared.down": (fs, d)})
  return out


def init_moe(cfg: ModelConfig, dtype, *, generator, device) -> dict:
  """``moe_shapes``'s leaves with the reference's scales (``dense_init``'s
  fan-in is a leaf's first dim, E for the stacked experts), the router in
  float32."""
  kw = dict(generator=generator, device=device)
  p = {}
  for name, shape in moe_shapes(cfg).items():
    leaf = dense_init(shape, torch.float32 if name == "router" else dtype,
                      **kw)
    if name.startswith("shared."):
      p.setdefault("shared", {})[name[len("shared."):]] = leaf
    else:
      p[name] = leaf
  return p


class Route(NamedTuple):
  """One call's routing, per group of ``sg`` tokens (G groups)."""
  probs: torch.Tensor     # (G, Sg, E) float32 router softmax
  top_p: torch.Tensor     # (G, Sg, k) gates, renormalised over the top k
  top_e: torch.Tensor     # (G, Sg, k) int64 experts, ties to the lowest
  rank: torch.Tensor      # (G, Sg, k) int64 the pair's rank in its expert
  keep: torch.Tensor      # (G, Sg, k) bool: a real token within capacity
  valid: torch.Tensor     # (G, Sg) bool: not padding
  cap: int


def group_len(cfg: ModelConfig, tokens: int, group: int | None = None) -> int:
  """sg: ``group`` (the config's ``group_size`` when None) or every token
  of a smaller call."""
  return min(group or cfg.moe.group_size, tokens)


def data_group_len(cfg: ModelConfig, tokens: int, ranks: int,
                   group: int | None = None) -> int:
  """sg of a call whose ``tokens`` are one of ``ranks`` equal shards of
  the batch: ``group_len`` of the global count.  With ``ranks`` > 1 it
  raises unless the rank's tokens are a whole number of groups (a
  multiple of the group size), since a group cut across two ranks routes
  and drops as neither rank can alone."""
  sg = group_len(cfg, tokens * ranks, group)
  if ranks > 1 and tokens % sg:
    raise ValueError(
        f"{cfg.name}: a data axis of {ranks} ranks cuts the MoE groups of "
        f"{sg} tokens: a rank holds {tokens} tokens, not a multiple of "
        f"{sg}; give each rank a multiple of group_size "
        f"{group or cfg.moe.group_size} tokens")
  return sg


def capacity(cfg: ModelConfig, sg: int) -> int:
  """Slots an expert has in a group: the whole group up to 32 tokens
  (exact routing), else ``int(sg * k * capacity_factor / E)``."""
  e = cfg.moe
  if sg <= 32:
    return sg
  return max(int(sg * e.top_k * e.capacity_factor / e.num_experts), 1)


def _grouped(x: torch.Tensor, sg: int):
  """x (B, S, d) -> (G, Sg, d) zero-padded, and the (G, Sg) valid mask."""
  b, s, d = x.shape
  t_true = b * s
  pad = (-t_true) % sg
  xf = x.reshape(t_true, d)
  if pad:
    xf = F.pad(xf, (0, 0, 0, pad))
  g = (t_true + pad) // sg
  valid = (torch.arange(t_true + pad, device=x.device) < t_true).reshape(g,
                                                                         sg)
  return xf.reshape(g, sg, d), valid


def assign(probs: torch.Tensor, top_e: torch.Tensor, valid: torch.Tensor,
           cfg: ModelConfig) -> Route:
  """The routing of chosen experts ``top_e`` (G, Sg, k): their gates,
  renormalised over the k, and each pair's rank in its expert in
  token-major, choice-minor order (padding tokens count nowhere), kept
  while the rank is below the capacity."""
  e = cfg.moe
  g, sg, _ = probs.shape
  top_p = torch.gather(probs, -1, top_e)
  top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
  onehot = F.one_hot(top_e, e.num_experts) * valid[..., None, None]
  flat = onehot.reshape(g, sg * e.top_k, e.num_experts)
  before = torch.cumsum(flat, dim=1) - flat                 # exclusive
  rank = torch.gather(before, 2, top_e.reshape(g, -1, 1)).reshape(
      g, sg, e.top_k)
  cap = capacity(cfg, sg)
  keep = (rank < cap) & valid[..., None]
  return Route(probs, top_p, top_e, rank, keep, valid, cap)


def route(xg: torch.Tensor, valid: torch.Tensor, router: torch.Tensor,
          cfg: ModelConfig) -> Route:
  """The router in float32, softmax, top-k by a stable descending sort
  (ties to the lowest expert), then ``assign``."""
  probs = torch.softmax(xg.float() @ router, dim=-1)         # (G, Sg, E)
  top_e = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.moe.top_k]
  return assign(probs, top_e, valid, cfg)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig, *,
            group_size: int | None = None, dp=None, tp=None, pod=None):
  """x (B, S, d) -> (y (B, S, d) in x's dtype, aux float32 scalar).

  ``p`` is the block's ``moe`` parameters (``init_moe``'s names).  The aux
  term is the Switch load-balance loss E * sum_e f_e * P_e times
  ``router_aux_weight`` (f_e the share of group slots routed to e, P_e the
  mean router probability, both over every slot of the groups, padding
  included, as the reference takes them).  ``dp`` is the data group x is
  a shard of (None: x is the whole batch); ``tp`` the rank's place on the
  model axis (None: every expert whole); ``pod`` the pod group the
  experts are dealt over (``ep_pod``; None: no pod axis); see the module
  docstring."""
  b, s, d = x.shape
  e = cfg.moe
  n_exp = e.num_experts
  ranks = 1 if dp is None else dp.world
  sg = data_group_len(cfg, b * s, ranks, group_size)
  xg, valid = _grouped(x, sg)
  g = xg.shape[0]
  r = route(xg, valid, p.router, cfg)
  cap = r.cap

  group = tp.group if tp is not None and tp.experts else None
  seq = tp.group if tp is not None and tp.seq else None
  # the experts this rank holds: e0 .. e0 + n_loc - 1 (all but under "ep"
  # and, over pods, its pod's), and those it dispatches to (n_disp: every
  # expert over pods, whose rows are exchanged with the owning pod)
  n_loc = p.gate.shape[0]
  pods = 1 if pod is None else pod.world
  n_disp = n_loc * pods
  e0 = group.rank * n_loc if group is not None and tp.experts == "ep" else 0
  mine = r.keep
  if n_disp != n_exp:
    mine = mine & (r.top_e >= e0) & (r.top_e < e0 + n_disp)

  # dispatch: each kept pair's token into row e * cap + rank of its group
  slot = ((r.top_e - e0).clamp(0, n_disp - 1) * cap
          + r.rank.clamp_max(cap - 1))                       # (G, Sg, k)
  gi = torch.arange(g, device=x.device)[:, None, None].expand_as(slot)
  si = torch.arange(sg, device=x.device)[None, :, None].expand_as(slot)
  xin = enter_group(xg, group)
  # every pair is written (fixed shapes, no host read): a dropped pair or
  # another rank's into a spare last row, which is cut off
  rows = n_disp * cap
  buf = xg.new_zeros((g, rows + 1, d))
  buf[gi, torch.where(mine, slot, rows)] = xin[gi, si]
  buf = buf[:, :rows]
  # (G, P, E_loc, C, d): each pod's experts' rows to that pod, every pod's
  # rows for this rank's experts back, pod-major
  buf = all_to_all(buf.reshape(g, pods, n_loc, cap, d).transpose(0, 1),
                   pod)
  buf = buf.permute(2, 0, 1, 3, 4).reshape(n_loc, pods * g * cap, d)
  h = (F.silu(torch.bmm(buf, p.gate).float()).to(x.dtype)
       * torch.bmm(buf, p.up))
  out = torch.bmm(h, p.down)                         # (E_loc, P*G*C, d)
  out = all_to_all(out.reshape(n_loc, pods, g, cap, d).permute(
      1, 2, 0, 3, 4).contiguous(), pod)
  out = out.transpose(0, 1).reshape(g, n_disp * cap, d)

  # combine: each token's kept outputs in float32, weighted by its gates
  picked = out[gi, slot].float()                             # (G, Sg, k, d)
  w = torch.where(mine, enter_group(r.top_p, group),
                  torch.zeros_like(r.top_p))
  y = (picked * w[..., None]).sum(dim=2).reshape(g * sg, d)[:b * s]
  y = y.reshape(b, s, d)

  shared = None
  if e.num_shared:
    sh = p.shared
    split = tp.group if tp is not None and tp.shared else None
    shared = swiglu(enter_group(x, split), sh.gate, sh.up, sh.down)
    if split is not None and group is not None:   # both partial: one sum
      y, shared = y + shared.float(), None
    else:
      shared = leave(shared, split, seq)
  y = leave(y, group, seq).to(x.dtype)
  if shared is not None:
    y = y + shared

  routed = F.one_hot(r.top_e, n_exp).float() * valid[..., None, None]
  f_e = routed.amax(dim=2).mean(dim=(0, 1))                  # (E,)
  if ranks > 1:
    f_e = dp.sum(f_e, div=ranks)
  p_e = r.probs.mean(dim=(0, 1))
  aux = n_exp * torch.sum(f_e * p_e) * e.router_aux_weight
  return y, aux
