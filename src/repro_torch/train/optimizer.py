"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the port of ``src/repro/train/optimizer.py``).

The state is the reference's: float32 first and second moments beside
every parameter, keyed by the parameter's name (the port's names are the
reference's leaf paths as ``interop.lm_params`` maps them), and the step
count as a tensor on the parameters' device, so an update makes no host
sync.  ``adamw_update`` writes the parameters and the state in place under
``torch.no_grad()``.

Arithmetic as in the reference: the schedule and the bias corrections
``b ** step`` in float32, the moments in float32, the update cast back to
the parameter's dtype, no decay on the names ``_decay_mask`` exempts.  The
clip runs leaf by leaf inside the update loop, after one pass for the
global norm: the reference first builds a whole float32 tree of clipped
gradients (+16.4 GiB at qwen3-4b), and the result is the same because the
scale is one scalar.

Over a mesh (``mesh=`` a ``launch.mesh.TrainMesh`` and ``axes=`` each
leaf's split axes, ``Model.norm_axes``: the model axis, FSDP's data axes,
the pod of ``ep_pod``) the global norm sums each leaf's squares over the
groups of its split axes, one group after another in the leaf's dim
order, each in rank order, and counts the replicated leaves once, so
every rank clips by the same scale.  Over a mesh the squares are
summed in float64 and the norm cast to float32 once, so how a leaf is
split does not show in the norm's bits (an FSDP run clips by the scale
of the run without it); one process keeps the float32 sums.  The moments are allocated like their parameter,
so they are sharded with it: an FSDP rank steps only its shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
  lr: float = 3e-4
  min_lr_frac: float = 0.1
  warmup_steps: int = 100
  total_steps: int = 10_000
  b1: float = 0.9
  b2: float = 0.95
  eps: float = 1e-8
  weight_decay: float = 0.1
  clip_norm: float = 1.0


class OptState(NamedTuple):
  step: torch.Tensor               # () int64, on the parameters' device
  mu: dict[str, torch.Tensor]      # first moments (float32, like params)
  nu: dict[str, torch.Tensor]      # second moments (float32, like params)


def _named(params) -> dict[str, torch.Tensor]:
  """A module's named parameters, or a mapping of name -> tensor as is."""
  if isinstance(params, nn.Module):
    return dict(params.named_parameters())
  return dict(params)


def init_opt_state(params) -> OptState:
  """Zero moments for ``params`` (a module or a name -> tensor mapping) and
  step 0, on the parameters' device."""
  params = _named(params)
  mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in params.items()}
  nu = {n: torch.zeros_like(t) for n, t in mu.items()}
  dev = next(iter(params.values())).device
  return OptState(torch.zeros((), dtype=torch.int64, device=dev), mu, nu)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
  """Linear warm-up to ``lr``, then a cosine decay to ``min_lr_frac * lr``
  at ``total_steps``; float32."""
  step = torch.as_tensor(step)
  warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
  t = torch.clamp((step - cfg.warmup_steps)
                  / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
  cos = 0.5 * (1.0 + torch.cos(math.pi * t))
  frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
  return cfg.lr * warm * frac


_SQUARE_CHUNK = 1 << 24   # elements a leaf's float64 squares take at once


def _squares(leaves) -> torch.Tensor:
  """Each leaf's float32 sum of squares, stacked."""
  return torch.stack([torch.sum(torch.square(x.float())) for x in leaves])


def _squares64(leaves) -> torch.Tensor:
  """The float64 sum of every leaf's float64 sum of squares (a leaf in
  chunks of ``_SQUARE_CHUNK`` elements, so the float64 copy stays small)."""
  sums = []
  for x in leaves:
    flat = x.reshape(-1)
    sums.append(torch.stack([torch.sum(torch.square(
        flat[i:i + _SQUARE_CHUNK].double()))
        for i in range(0, max(flat.numel(), 1), _SQUARE_CHUNK)]).sum())
  return torch.stack(sums).sum()


def global_norm(tree, *, mesh=None, axes=None) -> torch.Tensor:
  """sqrt of the sum of squares of every leaf (a mapping's values or an
  iterable of tensors) in float32.  With ``mesh`` and ``axes`` (leaf
  name -> the tuple of axes tuples it is split over) the squares are
  summed in float64, a leaf's over each of its axes' groups in turn, the
  rest counted once, and the norm cast to float32."""
  if mesh is None:
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(_squares(leaves).sum())
  items = (list(tree.items()) if isinstance(tree, Mapping)
           else list(enumerate(tree)))
  axes = axes or {}
  by: dict = {}   # leaves by the axes they cross, in first-seen order
  for n, x in items:
    by.setdefault(axes.get(n, ()), []).append(x)
  total = None
  for split, leaves in by.items():
    part = _squares64(leaves)
    for a in split:
      part = mesh.group(a).sum(part)
    total = part if total is None else total + part
  return torch.sqrt(total).float()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
  return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
  """(float32 gradients scaled to a global norm of at most ``max_norm``,
  the norm before clipping).  ``adamw_update`` clips leaf by leaf
  instead, with the same scale."""
  norm = global_norm(grads)
  scale = _clip_scale(norm, max_norm)
  return {n: g.float() * scale for n, g in grads.items()}, norm


def _decay_mask(path: str) -> bool:
  """No weight decay on norms / biases / scalars."""
  lowered = path.lower()
  return not any(s in lowered for s in ("ln", "norm", "bias", "b_a", "b_i",
                                        "lam", "a_log", "dt_bias", "d_skip"))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads: Mapping[str, torch.Tensor],
                 state: OptState, *, mesh=None, axes=None) -> dict:
  """One AdamW step, in place: ``params`` (a module or a name -> tensor
  mapping) and ``state`` are written; ``grads`` maps every parameter name
  to its gradient (any float dtype).  ``mesh`` / ``axes``: the split
  leaves, for the global norm (module docstring).  Returns {"grad_norm"
  (before clipping), "lr"} as float32 tensors on the device."""
  params = _named(params)
  gnorm = global_norm({n: grads[n] for n in params}, mesh=mesh, axes=axes)
  scale = _clip_scale(gnorm, cfg.clip_norm)
  state.step.add_(1)
  lr = schedule(cfg, state.step)
  stepf = state.step.float()
  b1c = 1.0 - cfg.b1 ** stepf
  b2c = 1.0 - cfg.b2 ** stepf
  for name, p in params.items():
    g32 = grads[name].float() * scale
    mu, nu = state.mu[name], state.nu[name]
    mu.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
    nu.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32 * g32)
    del g32
    upd = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
    if _decay_mask(name):
      upd.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * upd)
  return {"grad_norm": gnorm, "lr": lr}
