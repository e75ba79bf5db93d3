"""PyTorch/CUDA port of the GreeDi coreset-selection system in ``src/repro``.

The JAX package ``repro`` is the reference; this package runs the same
protocol on one NVIDIA H100 with hand-written CUDA kernels for the
similarity blocks and the greedy steps of its objectives (facility
location, saturated coverage, information gain, graph cut;
``repro_torch.kernels``), and the LM substrate's serving path
(``repro_torch.models``, ``repro_torch.serve``) with a flash-attention
kernel.  It imports ``torch`` and never ``jax`` or ``repro``: what it needs
from the reference it keeps as its own copy.

Functions run where their tensors lie.  Entry points that create tensors
(``data.pipeline.EmbeddedCorpus``, ``launch.select``, ``models.Model``)
default to ``cuda`` and raise when CUDA is missing unless the caller asks
for ``cpu``, which runs the kernels' plain PyTorch versions (that is how the
tests run).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
  """The device an entry point should create tensors on.

  Raises when CUDA is asked for and missing: there is no quiet retreat to
  the CPU, which would hide the card from a measurement.
  """
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                       "the plain PyTorch versions of the kernels")
  return dev


def no_tf32() -> None:
  """Keep float32 products in full float32 (the kernels use FP32 FFMA, and
  the plain versions they are held against must not round to TF32)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
