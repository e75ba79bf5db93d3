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

Elastic reshard (the reference's ``shardings=``): ``save`` and
``restore`` take a ``launch.mesh.TrainMesh`` and the leaves' specs
(``specs``: leaf path -> spec, a tuple of one entry a dim, FSDP's data
axes and the pod among them; ``tree_specs`` builds them for ``{"params",
"opt"}`` from a model's ``param_specs``, the moments following their
parameter).  A save under a mesh writes whole
leaves, each gathered over every axis its spec splits it on; one rank (rank
0) writes, and every rank waits for the atomic publish, so a mesh
checkpoint and a one-device checkpoint are the same files.  A restore
under a mesh maps each stored leaf into memory and each rank reads and
keeps its own slice of every leaf, so a checkpoint saved on any layout
(one device, D x M) restores onto any other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import zipfile
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


def _flatten(tree) -> dict[str, np.ndarray]:
  return {k: _to_numpy(v) for k, v in _flatten_tensors(tree).items()}


def _unflatten(like, data, device, prefix: str = "", mesh=None, specs=None):
  items = _items(like)
  if items is None:
    key = prefix.rstrip("/")
    if key not in data:
      raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = data[key]
    leaf = torch.as_tensor(like)
    spec = None if mesh is None else (specs or {}).get(key)
    shape = tuple(arr.shape if spec is None else
                  mesh.local_shape(arr.shape, spec))
    if shape != tuple(leaf.shape):
      raise ValueError(f"shape mismatch for {key}: {arr.shape} (a rank's "
                       f"{shape}) vs {tuple(leaf.shape)}")
    full = torch.from_numpy(arr)
    if spec is not None:
      full = mesh.local(full, spec)
    return full.to(dtype=leaf.dtype, device=leaf.device if device is None
                   else device, copy=True).contiguous()
  kids = [_unflatten(child, data, device, f"{prefix}{key}/", mesh, specs)
          for key, child in items]
  if isinstance(like, Mapping):
    return dict(zip(like.keys(), kids))
  if hasattr(like, "_fields"):
    return type(like)(*kids)
  return type(like)(kids)


def tree_specs(param_specs: Mapping[str, tuple]) -> dict:
  """Specs of a ``{"params": state_dict, "opt": OptState}`` tree by leaf
  path: each parameter's, its moments the same, the step replicated."""
  out = {}
  for name, spec in param_specs.items():
    for prefix in ("params/", "opt/mu/", "opt/nu/"):
      out[prefix + name] = tuple(spec)
  return out


def _whole(tree, mesh, specs) -> dict:
  """``_flatten(tree)`` on rank 0, each leaf whole: gathered over the axis
  its spec splits it on (every rank takes part in its groups' gathers, one
  leaf at a time; only rank 0 keeps them)."""
  out = {}
  for key, arr in _flatten_tensors(tree).items():
    spec = specs.get(key)
    if spec is not None:
      arr = mesh.whole(arr, spec)
    if mesh.rank == 0:
      out[key] = _to_numpy(arr)
  return out


def _flatten_tensors(tree, prefix: str = "") -> dict:
  items = _items(tree)
  if items is None:
    return {prefix.rstrip("/"): torch.as_tensor(tree).detach()}
  out = {}
  for key, child in items:
    out.update(_flatten_tensors(child, f"{prefix}{key}/"))
  return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
  t = t.detach().cpu()
  if t.dtype == torch.bfloat16:
    t = t.float()  # npz cannot hold bfloat16; restore casts back
  return t.numpy()


class _Leaves(Mapping):
  """The leaves of an ``arrays.npz`` by key, each a copy-on-write memory
  map of its stored member (``np.savez`` stores without compression), so a
  restore reads only the parts of a leaf it keeps."""

  def __init__(self, path: str):
    self.path = path
    with zipfile.ZipFile(path) as zf:
      self.info = {i.filename[:-len(".npy")]: i for i in zf.infolist()
                   if i.filename.endswith(".npy")}

  def __getitem__(self, key):
    info = self.info[key]
    if info.compress_type != zipfile.ZIP_STORED:
      raise ValueError(f"{self.path}: member {info.filename} is compressed; "
                       "a checkpoint stores its leaves uncompressed "
                       "(np.savez)")
    with open(self.path, "rb") as f:
      f.seek(info.header_offset)
      local = f.read(30)  # the member's local header; then name and extra
      name, extra = struct.unpack("<HH", local[26:30])
      f.seek(info.header_offset + 30 + name + extra)
      version = np.lib.format.read_magic(f)
      shape, fortran, dtype = (
          np.lib.format.read_array_header_1_0(f) if version == (1, 0)
          else np.lib.format.read_array_header_2_0(f))
      offset = f.tell()
      if not shape:  # a scalar leaf
        return np.fromfile(f, dtype=dtype, count=1).reshape(())
    if 0 in shape:
      return np.zeros(shape, dtype)
    return np.memmap(self.path, dtype=dtype, mode="c", offset=offset,
                     shape=shape, order="F" if fortran else "C")

  def __iter__(self):
    return iter(self.info)

  def __len__(self):
    return len(self.info)

  def __contains__(self, key):
    return key in self.info


class CheckpointManager:
  def __init__(self, directory: str, keep_last: int = 3):
    self.dir = directory
    self.keep_last = keep_last
    os.makedirs(directory, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self.dir, f"step_{step:08d}")

  # ------------------------------------------------------------------ save
  def save(self, step: int, tree, extra: dict | None = None, *, mesh=None,
           specs: Mapping[str, tuple] | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` (atomically), with ``extra``
    merged into its metadata; prune to ``keep_last``.  Returns its path.
    Under ``mesh`` every rank calls it: the leaves ``specs`` split are
    gathered whole, rank 0 writes, and every rank returns once it is
    published (raising if rank 0 failed)."""
    final = self._path(step)
    if mesh is None:
      return self._write(step, _flatten(tree), extra)
    data = _whole(tree, mesh, specs or {})
    if mesh.rank != 0:
      if not self._published(mesh, True):
        raise RuntimeError(f"checkpoint step {step}: rank 0 failed to "
                           "write it")
      return final
    ok = False
    try:
      self._write(step, data, extra)
      ok = True
    finally:
      del data
      self._published(mesh, ok)
    return final

  @staticmethod
  def _published(mesh, ok: bool) -> bool:
    """Every rank's flag gathered (the barrier after the publish); True
    when rank 0's save succeeded."""
    flags = mesh.world.all_gather(torch.tensor([ok], device=mesh.device))
    return bool(flags[0])

  def _write(self, step: int, data: dict, extra: dict | None) -> str:
    tmp = os.path.join(self.dir, f"tmp.{step}")
    final = self._path(step)
    if os.path.exists(tmp):
      shutil.rmtree(tmp)
    os.makedirs(tmp)
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

  def restore(self, like, step: int | None = None, device=None, *,
              mesh=None, specs: Mapping[str, tuple] | None = None
              ) -> tuple[Any, dict]:
    """Returns (tree, meta).  ``like`` gives the structure, shapes and
    dtypes; every leaf lands on ``device`` (default: the matching leaf of
    ``like``'s).  Under ``mesh`` (the elastic reshard) ``like`` holds this
    rank's slices and each leaf ``specs`` names is cut to the rank's slice
    of the saved whole leaf."""
    if step is None:
      step = self.latest_step()
    if step is None:
      raise FileNotFoundError(f"no checkpoints in {self.dir}")
    path = self._path(step)
    with open(os.path.join(path, "meta.json")) as f:
      meta = json.load(f)
    leaves = _Leaves(os.path.join(path, "arrays.npz"))
    return _unflatten(like, leaves, device, mesh=mesh, specs=specs), meta

  def restore_latest_or_none(self, like, device=None, *, mesh=None,
                             specs=None):
    """The restart protocol: (tree, meta) of the newest complete
    checkpoint, or (None, None) when there is none."""
    if self.latest_step() is None:
      return None, None
    return self.restore(like, device=device, mesh=mesh, specs=specs)
