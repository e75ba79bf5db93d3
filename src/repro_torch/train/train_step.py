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

Over a training mesh (the model's ``launch.mesh.TrainMesh``) each rank
runs the loss on its data shard of the batch and its model shard of the
parameters.  After the backward pass (and the microbatches) the gradients
of the model's ``partial_leaves`` (the qk-norm gains: replicated leaves
used inside a split region; those read by slice come whole out of
``split_group``'s backward, those every rank reads whole inside a split
block out of ``enter_group``'s) are summed over the model group, and then
every gradient is averaged over the data group: the rank-ordered sum in
float32 divided by D (``ProcessMesh.sum_``, in buckets), written back in
the gradient's dtype (a bf16 gradient rounds to nearest once).  Over a
pod axis D is P x D and the mean runs over the data axes a leaf is
replicated on (``Model.mean_axes``: under ``ep_pod`` the experts' over
the data group of their pod).  An FSDP leaf's gradient is that mean
already: the backward pass reduce-scatters each whole leaf gradient to
the rank's shard as soon as it is done (``Model.fsdp_grad``, the same
fold: the shard gets the bits the sum would have given it), once a
microbatch, and the microbatches accumulate shards (rounded to the
gradient's dtype once a microbatch, so with microbatches their bits are
not the run without FSDP's).  Every replica then makes the same update,
bit for bit.  The reported loss, xent
and aux are the same mean over the data group.  The reference's
``compression`` is a separate collective (``train.compression``): its
``train_step.py`` names it in a docstring and wires it nowhere, and
neither does the port.
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model, Parallelism
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update


def _layout(model: Model, par, mesh):
  """The model's mesh.  ``par`` / ``mesh`` are the reference's arguments
  and only assert: they must restate the model's own layout, which its
  parameters were laid out by when it was built."""
  if mesh is not None and mesh is not model.mesh:
    raise ValueError("mesh= differs from the model's: build the Model with "
                     "the mesh it trains over")
  if par is not None and par != model.par:
    raise ValueError(f"par={par} differs from the model's {model.par}")
  return model.mesh


def _data_mean(mesh, metrics: dict) -> dict:
  """The metrics' mean over the data group (one gather), or as they are
  without a data axis."""
  if mesh is None or mesh.dp_size == 1:
    return metrics
  names = list(metrics)
  mean = mesh.dp.sum(torch.stack([metrics[n].float() for n in names]),
                     div=mesh.dp_size)
  return {n: mean[i] for i, n in enumerate(names)}


def _data_reduce(model: Model, mesh, grads: dict) -> None:
  """Every gradient's mean over the data ranks (the rank-ordered float32
  sum / P x D), over the data axes each leaf is replicated on
  (``model.mean_axes``), summed in place in buckets
  (``ProcessMesh.sum_``); an FSDP leaf's shard is that mean already."""
  div = mesh.dp_size
  if div == 1:
    return
  buckets: dict = {}
  for n, g in grads.items():
    if n not in model.fsdp:
      buckets.setdefault(model.mean_axes[n], []).append(g)
  for axes, gs in buckets.items():
    mesh.group(axes).sum_(gs, div=div)


def make_train_step(model: Model, opt_cfg: OptConfig,
                    par: Parallelism | None = None, *, mesh=None,
                    microbatches: int = 1):
  """Returns ``step(opt_state, batch) -> metrics``: {"loss", "xent", "aux",
  "grad_norm", "lr"} as float32 tensors on the device (the loss the mean
  over microbatches, xent and aux the last microbatch's; over a data axis
  each the mean over the data group).  ``par`` and ``mesh`` only assert
  that they are the model's layout (``_layout``); ``batch`` is this rank's
  data shard."""
  mesh = _layout(model, par, mesh)
  params = dict(model.named_parameters())

  def grads_of(batch):
    for p in params.values():
      p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)

  def step(opt_state: OptState, batch: dict) -> dict:
    if microbatches == 1:
      loss, metrics, grads = grads_of(batch)
    else:
      grads, loss = None, None
      for i in range(microbatches):
        l, metrics, g = grads_of({k: v[i] for k, v in batch.items()})
        if grads is None:
          grads = {n: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for n, t in g.items()}
          loss = torch.zeros((), dtype=torch.float32, device=l.device)
        for n, t in g.items():
          grads[n].add_(t.float() / microbatches)
        del g
        loss = loss + l / microbatches
    if mesh is not None:
      partial = [grads[n] for n in model.partial_leaves
                 if n not in model.fsdp]   # (FSDP's are summed already)
      if partial:
        mesh.tp.sum_(partial)
      _data_reduce(model, mesh, grads)
      metrics = _data_mean(mesh, dict(metrics, loss=loss))
      loss = metrics.pop("loss")
    om = adamw_update(opt_cfg, params, grads, opt_state, mesh=mesh,
                      axes=None if mesh is None else model.norm_axes)
    del grads
    for p in params.values():
      p.grad = None
    return dict(metrics, loss=loss, **om)

  return step


def make_eval_step(model: Model, par: Parallelism | None = None, *,
                   mesh=None):
  """Returns ``step(batch) -> {"loss", "xent", "aux"}`` under
  ``torch.no_grad()`` (over a data axis, each the mean over the data
  group); ``par`` and ``mesh`` only assert, as in ``make_train_step``."""
  mesh = _layout(model, par, mesh)

  @torch.no_grad()
  def step(batch: dict) -> dict:
    loss, metrics = model.loss_fn(batch)
    return _data_mean(mesh, dict(metrics, loss=loss))

  return step
