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

Over a model axis (``group=`` the model group, ``sharded=`` the names of
the leaves split over it) the global norm sums the squares of the sharded
leaves over the group, in rank order, and counts the replicated leaves
once, so every rank clips by the one-device scale.  The moments are
allocated like their parameter, so they are sharded with it.
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


def _squares(leaves) -> torch.Tensor:
  return torch.stack([torch.sum(torch.square(x.float())) for x in leaves])


def global_norm(tree, *, group=None, sharded=frozenset()) -> torch.Tensor:
  """sqrt of the sum of squares of every leaf (a mapping's values or an
  iterable of tensors), in float32.  With ``group`` (a model group) the
  mapping's leaves named in ``sharded`` are the rank's slices: their
  squares are summed over the group in rank order, the others counted
  once."""
  if group is None or group.world == 1 or not sharded:
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(_squares(leaves).sum())
  split = _squares([x for n, x in tree.items() if n in sharded]).sum()
  rest = [x for n, x in tree.items() if n not in sharded]
  total = group.sum(split)
  return torch.sqrt(total + _squares(rest).sum() if rest else total)


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
                 state: OptState, *, group=None,
                 sharded=frozenset()) -> dict:
  """One AdamW step, in place: ``params`` (a module or a name -> tensor
  mapping) and ``state`` are written; ``grads`` maps every parameter name
  to its gradient (any float dtype).  ``group`` / ``sharded``: the model
  axis, for the global norm (module docstring).  Returns {"grad_norm"
  (before clipping), "lr"} as float32 tensors on the device."""
  params = _named(params)
  gnorm = global_norm({n: grads[n] for n in params}, group=group,
                      sharded=sharded)
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
