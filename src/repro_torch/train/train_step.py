"""Training and evaluation steps (the port of
``src/repro/train/train_step.py``).

A train step is the loss, its backward and one AdamW update, the model's
parameters and the optimizer state written in place.  With
``microbatches > 1`` the batch's leaves carry a leading (microbatches,
per-microbatch batch, ...) layout, and the float32 gradients accumulate
divided by ``microbatches``, as the reference's scan does.  The eval step
runs the same loss under ``torch.no_grad()``: on the card its attention
launches the flash kernel (one launch a layer), where a train step's
attention runs ``chunked_attention`` (``models.attention``'s rule).
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update


def make_train_step(model: Model, opt_cfg: OptConfig, *,
                    microbatches: int = 1):
  """Returns ``step(opt_state, batch) -> metrics``: {"loss", "xent", "aux",
  "grad_norm", "lr"} as float32 tensors on the device (the loss the mean
  over microbatches, xent and aux the last microbatch's)."""
  params = dict(model.named_parameters())

  def grads_of(batch):
    for p in params.values():
      p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}

  def step(opt_state: OptState, batch: dict) -> dict:
    if microbatches == 1:
      loss, metrics = grads_of(batch)
      grads = {n: p.grad for n, p in params.items()}
    else:
      grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
      loss = torch.zeros((), dtype=torch.float32,
                         device=next(iter(params.values())).device)
      for i in range(microbatches):
        l, metrics = grads_of({k: v[i] for k, v in batch.items()})
        for n, p in params.items():
          grads[n].add_(p.grad.float() / microbatches)
        loss = loss + l / microbatches
    om = adamw_update(opt_cfg, params, grads, opt_state)
    del grads
    for p in params.values():
      p.grad = None
    return dict(metrics, loss=loss, **om)

  return step


def make_eval_step(model: Model):
  """Returns ``step(batch) -> {"loss", "xent", "aux"}`` under
  ``torch.no_grad()``."""

  @torch.no_grad()
  def step(batch: dict) -> dict:
    loss, metrics = model.loss_fn(batch)
    return dict(metrics, loss=loss)

  return step
