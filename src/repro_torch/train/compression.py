"""Gradient compression for a bandwidth-bound all-reduce (the port of
``src/repro/train/compression.py``).

An int8 block-quantized mean with stochastic rounding and per-worker
error feedback: the quantization residual is added back into the next
step's gradient, so the compressed trajectory tracks the exact one.  The
wire is really int8: each rank's codes (1 byte an element) and per-block
float32 scales are gathered over the group (``ProcessMesh.gather_parts``),
and every rank dequantizes each rank's contribution and takes the mean in
rank order.

The rounding noise is an explicit argument, ``uniform - 0.5`` of the flat
padded shape (a multiple of ``BLOCK``): the tests pass the reference's
``jax.random`` draw; ``draw_noise`` draws it from a ``torch.Generator`` for
the port's own runs.  As in the reference, nothing in the train step or
the launcher calls it.
"""
from __future__ import annotations

from typing import Mapping

import torch

BLOCK = 256  # quantization block (per-block scales)
CHUNK = 1 << 24  # elements of the flat gradient a rank sends at once


def quantize(x: torch.Tensor, noise: torch.Tensor):
  """x float32 (n,), n a multiple of BLOCK; noise (n,) uniform - 0.5 ->
  (int8 codes (n,), float32 scales (n / BLOCK,)): scale = max|x| / 127
  floored at 1e-12 a block, codes round(x / scale + noise) clipped to
  +-127."""
  xb = x.reshape(-1, BLOCK)
  # a tensor divisor: CUDA divides by a Python scalar through its
  # reciprocal, which is not the reference's float32 division
  top = xb.abs().amax(dim=1)
  scale = (top / top.new_full((), 127.0)).clamp_min(1e-12)
  y = xb / scale[:, None] + noise.reshape(-1, BLOCK)
  q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
  return q.reshape(-1), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  return (q.reshape(-1, BLOCK).to(torch.float32) * scale[:, None]).reshape(-1)


def padded_size(tree) -> int:
  """The flat length of a tree's leaves padded to a multiple of BLOCK (the
  noise's length)."""
  n = sum(t.numel() for t in _leaves(tree))
  return n + (-n) % BLOCK


def draw_noise(n: int, generator: torch.Generator, device=None):
  """Rounding noise for ``compressed_psum``: (n,) float32 uniform - 0.5
  from ``generator``."""
  return torch.rand((n,), generator=generator, device=device) - 0.5


def _leaves(tree):
  return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def _flatten(tree) -> torch.Tensor:
  """The leaves as one float32 vector padded to a multiple of BLOCK (a
  view of a lone float32 leaf of such a length)."""
  leaves = _leaves(tree)
  if (len(leaves) == 1 and leaves[0].dtype == torch.float32
      and leaves[0].is_contiguous() and leaves[0].numel() % BLOCK == 0):
    return leaves[0].reshape(-1)
  flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
  return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))


def _unflatten(flat: torch.Tensor, like):
  out, off = [], 0
  for t in _leaves(like):
    out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
    off += t.numel()
  if isinstance(like, Mapping):
    return dict(zip(like.keys(), out))
  return out


def compressed_psum(grads, error, noise: torch.Tensor, group):
  """The int8-quantized mean of ``grads`` over ``group`` (a
  ``launch.mesh.ProcessMesh``; every rank calls it) with error feedback.

  grads: this rank's gradients (a name -> tensor mapping or a list);
  error: the residual from the previous step (same structure) or None;
  noise: (padded_size(grads),) uniform - 0.5.  Returns (the mean, the new
  residual), each shaped like ``grads``.  The flat gradient goes over in
  slices of ``CHUNK`` elements (a multiple of BLOCK; blocks are
  independent, so the slicing changes no bit), which bounds the gathered
  codes and the temporaries.
  """
  flat = _flatten(grads)
  if noise.shape != flat.shape:
    raise ValueError(f"noise of shape {tuple(noise.shape)}, the padded "
                     f"gradient has {tuple(flat.shape)}")
  eflat = None if error is None else _flatten(error)
  mean, new_error = torch.empty_like(flat), torch.empty_like(flat)
  for s in range(0, flat.numel(), CHUNK):
    part = slice(s, s + CHUNK)
    corrected = flat[part] if eflat is None else flat[part] + eflat[part]
    q, scale = quantize(corrected, noise[part])
    # the error feedback residual
    torch.sub(corrected, dequantize(q, scale), out=new_error[part])
    codes, scales = group.gather_parts(q), group.gather_parts(scale)
    acc = dequantize(codes[0], scales[0])
    for c, sc in zip(codes[1:], scales[1:]):
      acc.add_(dequantize(c, sc))           # rank order
    torch.div(acc, acc.new_full((), group.world), out=mean[part])
  return _unflatten(mean, grads), _unflatten(new_error, grads)


def make_compressed_allreduce(mesh, axis_names, grad_specs):
  """``fn(grads, error, noise) -> (mean, new_error)`` over the group of
  ``axis_names`` (the data axis) of ``mesh`` (a ``launch.mesh.TrainMesh``),
  each rank on its model shard's slice: ``grads`` are laid out by
  ``grad_specs`` (the model's ``param_specs``), which may split a leaf over
  the other axes only."""
  group = mesh.group(axis_names)
  axes = set(axis_names)
  for name, spec in grad_specs.items():
    for entry in spec:
      if set(entry if isinstance(entry, (tuple, list)) else (entry,)) & axes:
        raise ValueError(f"{name} is split over {spec}: the mean over "
                         f"{tuple(axis_names)} needs leaves replicated "
                         "across it")

  def fn(grads, error, noise):
    if set(grads) != set(grad_specs):
      raise ValueError("the gradients' names differ from grad_specs'")
    return compressed_psum(grads, error, noise, group)

  return fn
