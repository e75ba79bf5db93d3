"""Fault-tolerant checkpointing: atomic, keep-last-K, path-keyed (the port
of ``src/repro/train/checkpoint.py``).

  * atomic publish -- a checkpoint is written to ``<dir>/tmp.<step>`` and
    ``os.replace``d into ``step_<n>`` only when complete, so a mid-write
    failure never leaves a half checkpoint that a restart would load (a
    leftover ``tmp.*`` is never read);
  * keep-last-K pruning bounds disk;
  * path-keyed storage -- the leaves of a tree of dicts, NamedTuples,
    lists and tensors (a model's ``state_dict()`` and an ``OptState``
    among them) are stored in ``arrays.npz`` under their path, so a
    restore validates structure (a missing leaf raises ``KeyError``, a
    shape mismatch ``ValueError``) and tolerates reordering; bfloat16 is
    widened to float32 (lossless) and cast back on restore; metadata goes
    in ``meta.json``;
  * ``restore_latest_or_none`` is the restart protocol: the newest
    complete checkpoint, or None.

The reference's elastic reshard onto another mesh waits for the
``torch.distributed`` backend (ROADMAP.md); ``restore`` places every leaf
on one ``device``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Mapping

import numpy as np
import torch

STEP_RE = re.compile(r"step_(\d+)$")


def _items(tree):
  """(key, child) pairs of a dict, NamedTuple, list or tuple node."""
  if isinstance(tree, Mapping):
    return [(str(k), v) for k, v in tree.items()]
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return list(zip(tree._fields, tree))
  if isinstance(tree, (list, tuple)):
    return [(str(i), v) for i, v in enumerate(tree)]
  return None


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
  items = _items(tree)
  if items is None:
    arr = torch.as_tensor(tree).detach().cpu()
    if arr.dtype == torch.bfloat16:
      arr = arr.float()  # npz cannot hold bfloat16; restore casts back
    return {prefix.rstrip("/"): arr.numpy()}
  out = {}
  for key, child in items:
    out.update(_flatten(child, f"{prefix}{key}/"))
  return out


def _unflatten(like, data: dict[str, np.ndarray], device, prefix: str = ""):
  items = _items(like)
  if items is None:
    key = prefix.rstrip("/")
    if key not in data:
      raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = data[key]
    leaf = torch.as_tensor(like)
    if tuple(arr.shape) != tuple(leaf.shape):
      raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                       f"{tuple(leaf.shape)}")
    return torch.from_numpy(arr).to(
        dtype=leaf.dtype, device=leaf.device if device is None else device)
  kids = [_unflatten(child, data, device, f"{prefix}{key}/")
          for key, child in items]
  if isinstance(like, Mapping):
    return dict(zip(like.keys(), kids))
  if hasattr(like, "_fields"):
    return type(like)(*kids)
  return type(like)(kids)


class CheckpointManager:
  def __init__(self, directory: str, keep_last: int = 3):
    self.dir = directory
    self.keep_last = keep_last
    os.makedirs(directory, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self.dir, f"step_{step:08d}")

  # ------------------------------------------------------------------ save
  def save(self, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` (atomically), with ``extra``
    merged into its metadata; prune to ``keep_last``.  Returns its path."""
    tmp = os.path.join(self.dir, f"tmp.{step}")
    final = self._path(step)
    if os.path.exists(tmp):
      shutil.rmtree(tmp)
    os.makedirs(tmp)
    data = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **data)
    meta = {"step": int(step), "num_leaves": len(data)}
    if extra:
      meta.update(extra)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
      json.dump(meta, f)
    if os.path.exists(final):
      shutil.rmtree(final)
    os.replace(tmp, final)                # atomic publish
    self._prune()
    return final

  def _prune(self):
    steps = self.all_steps()
    for s in steps[: -self.keep_last] if self.keep_last else []:
      shutil.rmtree(self._path(s), ignore_errors=True)

  # --------------------------------------------------------------- restore
  def all_steps(self) -> list[int]:
    """Steps of the complete checkpoints (a ``meta.json`` present),
    ascending."""
    out = []
    for name in os.listdir(self.dir):
      m = STEP_RE.match(name)
      if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
        out.append(int(m.group(1)))
    return sorted(out)

  def latest_step(self) -> int | None:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def restore(self, like, step: int | None = None,
              device=None) -> tuple[Any, dict]:
    """Returns (tree, meta).  ``like`` gives the structure, shapes and
    dtypes; every leaf lands on ``device`` (default: the matching leaf of
    ``like``'s)."""
    if step is None:
      step = self.latest_step()
    if step is None:
      raise FileNotFoundError(f"no checkpoints in {self.dir}")
    path = self._path(step)
    with open(os.path.join(path, "meta.json")) as f:
      meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
      data = {k: z[k] for k in z.files}
    return _unflatten(like, data, device), meta

  def restore_latest_or_none(self, like, device=None):
    """The restart protocol: (tree, meta) of the newest complete
    checkpoint, or (None, None) when there is none."""
    if self.latest_step() is None:
      return None, None
    return self.restore(like, device=device)
