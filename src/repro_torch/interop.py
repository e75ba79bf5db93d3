"""Carrying data across between the JAX reference and the port.

The system has no weights; what crosses over is data: the ground set's
features, the partition permutation the reference drew (``random_partition``
returns it as an (m, ceil(n/m)) int32 array with -1 padding), and global
document ids.  These helpers take the reference's numpy arrays to tensors
on a given device, and a port result back to numpy with the reference's
dtypes (int32 ids), so one test can run both sides on the same data and
the same partition.  Nothing here imports JAX: callers pass
``np.asarray(jax_array)``.
"""
from __future__ import annotations

import numpy as np
import torch


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
