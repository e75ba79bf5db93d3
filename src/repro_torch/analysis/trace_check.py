"""Dispatch-trace hazard analysis (rules T1, T3, T4, T6, and T2 / T7 over
ranks) over registered entry points: the port's counterpart of
``src/repro/analysis/jaxpr_check.py``.

PyTorch runs eagerly, so there is no program to walk: the analyzer RUNS
one call of an entry (``kernels/dispatch.py`` entry-point registry) on
concrete operands under a ``TorchDispatchMode`` -- as ``launch/dryrun.py``
``Cost`` does -- and reads every aten op as it passes.  It keeps a
mask-taint bit per storage, as ``jaxpr_check`` keeps one per variable: the
bit is seeded from the entry's declared mask inputs (gid-validity columns
of pad-and-mask blocks), joined from an op's inputs into its outputs, and
joined into the storage an in-place or ``out=`` op writes (views share
their base's storage, so a write through a view taints the base).  Each
entry runs twice: a warm-up call, then the call that is read.

T1  host syncs in one call above the entry's declared ``sync_budget``.
    Counted are ``aten._local_scalar_dense`` (``.item()``, ``int(t)``,
    ``bool(t)``, ``if t.any():``), ``nonzero``, ``masked_select``,
    ``unique*``, ``index`` / ``index_put`` with a bool index, a blocking
    device-to-host copy, and -- patched for the call, since they never
    reach the dispatcher on a CPU tensor -- ``Tensor.tolist``, ``.numpy``
    (unless of a tensor just read back) and ``.cpu``, and
    ``torch.cuda.synchronize``.  On the card an op counts only when its
    tensor is on the card, and the call is counted a second way through
    ``torch.cuda.set_sync_debug_mode("warn")``; T1 fires when either count
    passes the budget.  (The counterpart of the reference's R6 and of the
    service's stated sync contract.)

T3  mask discipline: a reduction (``sum``, ``mean``, ``amax`` / ``amin``,
    ``max`` / ``min``, ``argmax`` / ``argmin``, ``prod``, ``any`` /
    ``all``, ``logsumexp``, ``topk``) over an axis whose size is one of the
    entry's pad-and-mask row sizes, of an input that never consumed a
    declared mask.  Padded rows are zeroed *by* the mask; a reduction that
    never saw it reads garbage rows (R3).  It runs where the plain
    versions run (the CPU): on the card the CUDA routes write their outputs
    through raw pointers the dispatcher never sees, so the taint would stop
    at every kernel.

T4  a kernel build, library load or ``torch.compile`` in the warm call:
    the second call of an entry must add 0 ``build.build`` calls, 0
    ``ctypes.CDLL`` loads and 0 compiles (R4's runtime side).

T6  a float32 ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``linear`` that
    runs while ``torch.backends.cuda.matmul.allow_tf32`` is on or
    ``torch.get_float32_matmul_precision()`` is not "highest".

T2  (ranks) the ranks' sequences of ``ProcessMesh`` collectives differ: a
    rank that issues a collective the others do not deadlocks the group
    (R2 (b), a collective under one branch of a cond).  Each rank logs
    (method, shapes, dtype, group) of every outermost ``ProcessMesh``
    collective; the launcher compares the logs at the end, or after the
    group's timeout ends a stuck rank.  ``exchange`` / ``fetch_rows``
    carry rows of sizes that differ by rank, so only their trailing shapes
    are compared.

T7  (ranks) ``ProcessMesh.sum`` / ``sum_`` (with ``div == 1``) or ``max``
    of an operand that is bit-identical on every rank: the sum counts the
    one value ``world`` times (R7, double counting; a max of it does
    nothing).  The operand's bytes go to the launcher in a digest the T2
    comparison leaves out.

Each finding's location is the innermost frame of the repo (outside this
package) on the Python stack when the op ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .findings import Finding

__all__ = ["check_entry", "run_entry", "check_ranked", "EntryRun",
           "DEFAULT_RULES"]

_ANALYSIS_DIR = Path(__file__).resolve().parent
_BUILD_FILE = _ANALYSIS_DIR.parent / "kernels" / "build.py"

_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::unique_dim_consecutive",
})
_INDEX_OPS = frozenset({"aten::index", "aten::index_put", "aten::index_put_",
                        "aten::_index_put_impl_"})
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_"})
_MATMUL_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm",
                         "aten::baddbmm", "aten::linear"})
_REDUCE_OPS = frozenset({
    "aten::sum", "aten::nansum", "aten::mean", "aten::amax", "aten::amin",
    "aten::argmax", "aten::argmin", "aten::prod", "aten::any", "aten::all",
    "aten::logsumexp", "aten::topk", "aten::max", "aten::min",
})
# max / min overloads that reduce (the others are elementwise)
_MAXMIN_REDUCING = frozenset({"default", "dim", "dim_max", "dim_min",
                              "unary_out"})

# a collective that waits longer ends its rank (T2's divergent sequences)
GROUP_TIMEOUT_S = 60

# rules each device can read (T3 needs the plain routes: see the docstring)
DEFAULT_RULES = {"cpu": frozenset({"T1", "T3", "T4", "T6"}),
                 "cuda": frozenset({"T1", "T4", "T6"})}


@dataclasses.dataclass
class EntryRun:
  """What one entry's read call showed: its findings, its host syncs
  (``syncs`` by the dispatch count, ``debug_syncs`` by the sync debug mode
  on the card, None elsewhere), the sites of those syncs (the debug mode's
  by the frame it names), the builds it made, its budget and the wall
  seconds of both calls."""
  entry: str
  findings: list
  syncs: int
  debug_syncs: int | None
  sync_sites: dict
  builds: int
  budget: int
  seconds: float


def _tf32_on() -> bool:
  return (torch.backends.cuda.matmul.allow_tf32
          or torch.get_float32_matmul_precision() != "highest")


class _Locator:
  """Innermost repo frame (outside this package) of the Python stack."""

  def __init__(self, repo_root: Path, entry: str):
    self.root = repo_root
    self.entry = entry
    self._rel: dict[str, str | None] = {}

  def _relpath(self, filename: str, skip_build: bool) -> str | None:
    if filename not in self._rel:
      rel = None
      try:
        p = Path(filename).resolve()
        if _ANALYSIS_DIR not in p.parents:
          rel = str(p.relative_to(self.root))
      except ValueError:
        pass
      self._rel[filename] = rel
    rel = self._rel[filename]
    if rel is not None and skip_build and filename.endswith("build.py") \
        and Path(filename).resolve() == _BUILD_FILE:
      return None
    return rel

  def relpath(self, filename: str) -> str | None:
    return self._relpath(filename, False)

  def __call__(self, skip_build: bool = False) -> tuple[str, int]:
    f = sys._getframe(1)
    while f is not None:
      rel = self._relpath(f.f_code.co_filename, skip_build)
      if rel is not None:
        return rel, f.f_lineno
      f = f.f_back
    return f"<entry:{self.entry}>", 0


def _storage_key(t: torch.Tensor):
  try:
    return t.untyped_storage()._cdata
  except (RuntimeError, NotImplementedError):
    return None


def _arg_values(func, args, kwargs) -> dict:
  vals = {}
  for i, a in enumerate(func._schema.arguments):
    if i < len(args):
      vals[a.name] = args[i]
    elif a.name in kwargs:
      vals[a.name] = kwargs[a.name]
    elif a.has_default_value():
      vals[a.name] = a.default_value
  return vals


def _reduced_dims(func, args, kwargs, ndim: int) -> list[int]:
  vals = _arg_values(func, args, kwargs)
  dim = vals.get("dim")
  if dim is None:
    return list(range(ndim))
  dims = [dim] if isinstance(dim, int) else list(dim)
  if not dims:
    return list(range(ndim))
  return [d % ndim for d in dims] if ndim else []


class _Tracer(TorchDispatchMode):
  """The dispatch mode of one read call (see the module docstring)."""

  def __init__(self, *, entry: str, rules, row_sizes, on_card: bool,
               locate: _Locator):
    super().__init__()
    self.entry = entry
    self.rules = rules
    self.row_sizes = frozenset(row_sizes)
    self.on_card = on_card
    self.locate = locate
    self.taint: dict = {}
    self.syncs = 0
    self.sync_sites: dict[str, int] = {}
    self.first_past: tuple | None = None
    self.budget = 0
    self.paused = 0
    self.readback = 0   # inside a patched read-back: its copy is counted
    self.findings: list[Finding] = []
    self._seen: set = set()

  # -- bookkeeping -------------------------------------------------------
  def seed(self, tensors) -> None:
    for t in tensors:
      k = _storage_key(t)
      if k is not None:
        self.taint[k] = True

  def add(self, rule: str, msg: str, hint: str, loc=None) -> None:
    file, line = loc or self.locate()
    key = (rule, file, line, msg)
    if key not in self._seen:
      self._seen.add(key)
      self.findings.append(Finding(rule=rule, file=file, line=line, msg=msg,
                                   hint=hint, entry=self.entry))

  def sync(self, what: str, t: torch.Tensor | None = None) -> None:
    """Count one host sync (on the card only of a tensor on the card)."""
    if self.paused or "T1" not in self.rules:
      return
    if self.on_card and t is not None and not t.is_cuda:
      return
    self.syncs += 1
    file, line = self.locate()
    site = f"{file}:{line} {what}"
    self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
    if self.syncs == self.budget + 1:
      self.first_past = (file, line, what)

  # -- the dispatch hook -------------------------------------------------
  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if self.paused:
      return func(*args, **kwargs)
    name = func._overloadpacket._qualified_op_name
    flat, _ = tree_flatten((args, kwargs))
    tensors = [t for t in flat if isinstance(t, torch.Tensor)]
    keys = [_storage_key(t) for t in tensors]
    tainted = any(self.taint.get(k, False) for k in keys if k is not None)

    if name in _SYNC_OPS:
      self.sync(name, tensors[0] if tensors else None)
    elif name in _INDEX_OPS and any(
        isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
        for i in _arg_values(func, args, kwargs).get("indices") or ()):
      self.sync(f"{name} with a bool index", tensors[0])
    elif name in _COPY_OPS and self.on_card and not self.readback:
      self._check_d2h(func, name, args, kwargs)

    if "T6" in self.rules and name in _MATMUL_OPS and _tf32_on() and any(
        t.dtype == torch.float32 for t in tensors):
      self.add("T6", f"float32 {name} ran with TF32 / reduced matmul "
               "precision on", "turn TF32 off (repro_torch.no_tf32) before "
               "a parity path runs")

    if ("T3" in self.rules and self.row_sizes and name in _REDUCE_OPS
        and tensors and (name not in ("aten::max", "aten::min")
                         or func._overloadname in _MAXMIN_REDUCING)):
      x = args[0]
      if isinstance(x, torch.Tensor) and not self.taint.get(keys[0], False):
        dims = _reduced_dims(func, args, kwargs, x.dim())
        hit = sorted({x.shape[d] for d in dims} & self.row_sizes)
        if hit:
          self.add("T3", f"{name} over pad-and-mask row axis (size {hit}) "
                   "without consuming a validity mask",
                   "mask the operand with the gid-validity vector "
                   "(gids >= 0) before reducing")

    out = func(*args, **kwargs)
    self._propagate(func, args, kwargs, out, keys, tainted)
    return out

  def _check_d2h(self, func, name, args, kwargs) -> None:
    vals = _arg_values(func, args, kwargs)
    if vals.get("non_blocking"):
      return
    if name == "aten::_to_copy":
      src, dev = vals.get("self"), vals.get("device")
      if isinstance(src, torch.Tensor) and src.is_cuda and dev is not None \
          and torch.device(dev).type == "cpu":
        self.sync("device-to-host copy", src)
    else:
      dst, src = vals.get("self"), vals.get("src")
      if isinstance(src, torch.Tensor) and src.is_cuda and isinstance(
          dst, torch.Tensor) and not dst.is_cuda:
        self.sync("device-to-host copy", src)

  def _propagate(self, func, args, kwargs, out, in_keys, tainted) -> None:
    if "T3" not in self.rules:
      return
    written = []
    for i, a in enumerate(func._schema.arguments):
      if a.alias_info is not None and a.alias_info.is_write:
        v = args[i] if i < len(args) else kwargs.get(a.name)
        written.extend(x for x in tree_flatten(v)[0]
                       if isinstance(x, torch.Tensor))
    for t in written:
      k = _storage_key(t)
      if k is not None:
        self.taint[k] = self.taint.get(k, False) or tainted
    in_set = {k for k in in_keys if k is not None}
    for t in tree_flatten(out)[0]:
      if isinstance(t, torch.Tensor):
        k = _storage_key(t)
        if k is None:
          continue
        if k in in_set:   # a view or an in-place result: join
          self.taint[k] = self.taint.get(k, False) or tainted
        else:             # a fresh storage (its address may be reused)
          self.taint[k] = tainted


@contextlib.contextmanager
def _patched(tracer: _Tracer, count_builds: list):
  """Count what never reaches the dispatcher: the read-back methods,
  ``torch.cuda.synchronize``, and the build / load / compile calls."""
  from repro_torch.kernels import build as B
  saved = {"tolist": torch.Tensor.tolist, "numpy": torch.Tensor.numpy,
           "cpu": torch.Tensor.cpu}
  read: set = set()  # storages .cpu() handed back (their .numpy() is free)
  orig_sync, orig_build, orig_cdll = (torch.cuda.synchronize, B.build,
                                      ctypes.CDLL)
  orig_compile = torch.compile

  def readback(meth):
    orig = saved[meth]

    def wrapped(t, *a, **k):
      # .numpy() takes a host tensor only: on the card it is never a sync,
      # on the CPU it is one unless .cpu() just counted this storage; on
      # the card .cpu() / .tolist() of a host tensor are free
      free = (_storage_key(t) in read if meth == "numpy" and not
              tracer.on_card else tracer.on_card and (meth == "numpy"
                                                      or not t.is_cuda))
      if free:
        return orig(t, *a, **k)
      tracer.sync(f"Tensor.{meth}()", t)
      tracer.readback += 1
      try:
        out = orig(t, *a, **k)
      finally:
        tracer.readback -= 1
      if meth == "cpu":
        read.add(_storage_key(out))
      return out

    return wrapped

  def counted(orig, what):
    def wrapped(*a, **k):
      if not tracer.paused:
        count_builds.append((what, tracer.locate(skip_build=True)))
      return orig(*a, **k)
    return wrapped

  def sync(*a, **k):
    tracer.sync("torch.cuda.synchronize()")
    return orig_sync(*a, **k)

  for meth in saved:
    setattr(torch.Tensor, meth, readback(meth))
  torch.cuda.synchronize = sync
  B.build = counted(orig_build, "build.build")
  ctypes.CDLL = counted(orig_cdll, "ctypes.CDLL")
  torch.compile = counted(orig_compile, "torch.compile")
  try:
    yield
  finally:
    for meth, orig in saved.items():
      setattr(torch.Tensor, meth, orig)
    torch.cuda.synchronize = orig_sync
    B.build = orig_build
    ctypes.CDLL = orig_cdll
    torch.compile = orig_compile


@contextlib.contextmanager
def _debug_syncs(on_card: bool, out: list):
  """The card's own count: ``set_sync_debug_mode("warn")`` warnings."""
  if not on_card:
    yield
    return
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("warn")
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      yield
  finally:
    torch.cuda.set_sync_debug_mode("default")
  out.append([(w.filename, w.lineno) for w in caught
              if "synchroniz" in str(w.message)])


def _mask_tensors(args, positions) -> list:
  out = []
  for i in positions:
    out.extend(t for t in tree_flatten(args[i])[0]
               if isinstance(t, torch.Tensor))
  return out


def _device_of(args) -> torch.device:
  for t in tree_flatten(args)[0]:
    if isinstance(t, torch.Tensor):
      return t.device
  return torch.device("cpu")


def _read_call(spec, tracer, builds: list, debug: list,
               debug_mode: bool) -> None:
  with contextlib.ExitStack() as stack:
    stack.enter_context(_debug_syncs(debug_mode, debug))
    stack.enter_context(_patched(tracer, builds))
    stack.enter_context(tracer)
    spec.fn(*spec.args)


def run_spec(spec, *, entry: str, repo_root: Path | None = None,
             collectives=None) -> EntryRun:
  """Run ``spec.fn(*spec.args)`` once to warm up, then once under the
  tracer, reading the device's rules (``DEFAULT_RULES``); returns what the
  second call showed.  ``collectives`` is a ``_Collectives`` log to patch
  into ``ProcessMesh`` for both calls (the ranked runs)."""
  repo_root = (repo_root or Path.cwd()).resolve()
  dev = _device_of(spec.args)
  on_card = dev.type == "cuda"
  rules = DEFAULT_RULES[dev.type]
  locate = _Locator(repo_root, entry)
  tracer = _Tracer(entry=entry, rules=rules, row_sizes=spec.row_sizes,
                   on_card=on_card, locate=locate)
  tracer.budget = spec.sync_budget
  builds: list = []
  debug: list = []
  t0 = time.perf_counter()
  with contextlib.ExitStack() as stack:
    if collectives is not None:
      # the warm-up's collectives are logged too: ranks that diverge there
      # break the group before the read call
      collectives.bind(tracer)
      stack.enter_context(collectives.patched())
    spec.fn(*spec.args)
    tracer.seed(_mask_tensors(spec.args, spec.mask_args))
    _read_call(spec, tracer, builds, debug, on_card and "T1" in rules)
  if on_card:
    torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  debug_syncs = len(debug[0]) if debug else None
  for filename, line in debug[0] if debug else ():
    # a read-back the patch counted names the patch's own frame
    rel = locate.relpath(filename)
    site = (f"{rel}:{line} sync debug mode" if rel else
            "a patched read-back, by the sync debug mode")
    tracer.sync_sites[site] = tracer.sync_sites.get(site, 0) + 1
  counts = [tracer.syncs] + ([debug_syncs] if debug_syncs is not None else [])
  if "T1" in rules and max(counts) > spec.sync_budget:
    file, line, what = tracer.first_past or (f"<entry:{entry}>", 0,
                                             "sync debug mode")
    by = ("" if debug_syncs is None else
          f", {debug_syncs} by the card's sync debug mode")
    tracer.add("T1", f"{max(counts)} host sync(s) in one call of entry "
               f"{entry}, budget {spec.sync_budget} ({tracer.syncs} by "
               f"dispatch{by}; first past the budget: {what})",
               "keep the value on the device, batch the read-backs, or "
               "state the new contract in the entry's sync_budget",
               loc=(file, line))
  if "T4" in rules:
    for what, loc in builds:
      tracer.add("T4", f"{what} called in a warm call of entry {entry} (a "
                 "kernel build or library load per call)",
                 "build once: kernels/build.entry caches every library",
                 loc=loc)
  return EntryRun(entry, tracer.findings, tracer.syncs, debug_syncs,
                  dict(tracer.sync_sites), len(builds), spec.sync_budget,
                  seconds)


def check_entry(fn: Callable, args: tuple, *, entry: str,
                mask_positions: tuple[int, ...] = (),
                row_sizes: tuple[int, ...] = (), sync_budget: int = 0,
                repo_root: Path | None = None) -> list[Finding]:
  """Run ``fn(*args)`` (concrete tensors, on the device the findings are
  for) under the tracer; returns its findings (module docstring)."""
  from repro_torch.kernels.dispatch import TraceSpec
  spec = TraceSpec(fn, tuple(args), tuple(mask_positions), tuple(row_sizes),
                   sync_budget)
  return run_spec(spec, entry=entry, repo_root=repo_root).findings


def run_entry(ep, device, *, repo_root: Path | None = None, mesh=None,
              collectives=None) -> EntryRun:
  """Build a registered entry on ``device`` (with ``mesh`` when it needs
  ranks) and run it (``run_spec``)."""
  spec = ep.build(device) if mesh is None else ep.build(device, mesh)
  return run_spec(spec, entry=ep.name, repo_root=repo_root,
                  collectives=collectives)


# ---------------------------------------------------------------------------
# ranks: T2 and T7
# ---------------------------------------------------------------------------

_MESH_METHODS = ("gather_parts", "all_gather", "sum", "sum_", "max",
                 "reduce_scatter", "all_to_all", "exchange", "fetch_rows")


def _shape_sig(name: str, args, kwargs) -> list:
  x = args[0] if args else next(iter(kwargs.values()))
  if name == "sum_":
    return [[list(t.shape), str(t.dtype)] for t in x]
  if name == "exchange":
    return [len(x), [list(x[0].shape[1:]), str(x[0].dtype)] if x else None,
            (args[1] if len(args) > 1 else kwargs.get("sizes")) is None]
  if name == "fetch_rows":
    return [[list(t.shape[1:]), str(t.dtype)] for t in x]
  return [list(x.shape), str(x.dtype)]


def _digest(x) -> str:
  h = hashlib.sha1()
  for t in (x if isinstance(x, (list, tuple)) else [x]):
    t = t.detach()
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    h.update(str(t.dtype).encode())
    h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
             .tobytes())
  return h.hexdigest()


@contextlib.contextmanager
def _transport():
  """The sync debug mode off inside a collective: gloo stages CUDA tensors
  through the host, and those syncs are the transport's, not the
  program's (the dispatch count never sees them either)."""
  mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0
  if mode:
    torch.cuda.set_sync_debug_mode("default")
  try:
    yield
  finally:
    if mode:
      torch.cuda.set_sync_debug_mode(mode)


class _Collectives:
  """Log of one rank's outermost ``ProcessMesh`` collectives, each record
  appended to ``path`` (JSON lines) as it is issued: a rank the launcher
  ends while it waits still leaves its log."""

  def __init__(self, path: Path):
    self.path = path
    self.tracer: _Tracer | None = None
    self._depth = 0

  def bind(self, tracer: _Tracer) -> None:
    self.tracer = tracer

  @contextlib.contextmanager
  def _paused(self):
    tr = self.tracer
    tr.paused += 1
    mode = None
    if torch.cuda.is_available():
      mode = torch.cuda.get_sync_debug_mode()
      torch.cuda.set_sync_debug_mode("default")
    try:
      with torch.utils._python_dispatch._disable_current_modes():
        yield
    finally:
      if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
      tr.paused -= 1

  def _wrap(self, name: str, orig):
    def wrapped(mesh, *args, **kwargs):
      if self._depth or mesh.world == 1:
        return orig(mesh, *args, **kwargs)
      file, line = self.tracer.locate()
      rec = {"method": name, "sig": _shape_sig(name, args, kwargs),
             "world": mesh.world, "file": file, "line": line, "digest": None}
      div = args[1] if len(args) > 1 else kwargs.get("div", 1)
      if name == "max" or (name in ("sum", "sum_") and div == 1):
        with self._paused():
          rec["digest"] = _digest(args[0] if args else kwargs["x"])
      with open(self.path, "a") as f:  # before the call: a stuck call
        f.write(json.dumps(rec) + "\n")  # is logged too
      self._depth += 1
      try:
        with _transport():
          return orig(mesh, *args, **kwargs)
      finally:
        self._depth -= 1
    wrapped.__name__ = name
    return wrapped

  @contextlib.contextmanager
  def patched(self):
    from repro_torch.launch.mesh import ProcessMesh
    saved = {m: ProcessMesh.__dict__[m] for m in _MESH_METHODS}
    for m, orig in saved.items():
      setattr(ProcessMesh, m, self._wrap(m, orig))
    try:
      yield
    finally:
      for m, orig in saved.items():
        setattr(ProcessMesh, m, orig)


def compare_ranks(entry: str, logs: list[list[dict]]) -> list[Finding]:
  """T2 and T7 from every rank's collective log of one entry."""
  out: list[Finding] = []

  def key(rec):
    return None if rec is None else (rec["method"], json.dumps(rec["sig"]),
                                     rec["world"])

  n = max((len(lg) for lg in logs), default=0)
  for i in range(n):
    recs = [lg[i] if i < len(lg) else None for lg in logs]
    if len({key(r) for r in recs}) > 1:
      # the location: the first rank whose collective departs from rank
      # 0's (rank 0's own when it issued one the others did not)
      at = next((r for r in recs[1:] if r is not None
                 and key(r) != key(recs[0])), recs[0])
      desc = "; ".join(
          f"rank {r}: " + ("none" if rec is None else
                           f"{rec['method']} {json.dumps(rec['sig'])}")
          for r, rec in enumerate(recs))
      out.append(Finding(
          rule="T2", file=at["file"], line=at["line"],
          msg=f"ranks issue different ProcessMesh collectives at collective "
              f"{i} ({desc}): a divergent sequence deadlocks the group",
          hint="issue the collective on every rank (hoist it out of the "
               "rank-dependent branch)", entry=entry))
      break
    digests = {r["digest"] for r in recs}
    if len(digests) == 1 and None not in digests:
      rec = recs[0]
      what = ("the sum counts it once per rank (double counting)"
              if rec["method"] != "max" else "the max does nothing")
      out.append(Finding(
          rule="T7", file=rec["file"], line=rec["line"],
          msg=f"ProcessMesh.{rec['method']} of an operand that is "
              f"bit-identical on all {rec['world']} ranks: {what}",
          hint="reduce only rank-varying partial values; for a replicated "
               "operand drop the collective or pass div=world",
          entry=entry))
  return out


def _read_log(path: Path) -> list[dict]:
  """A rank's collective log; a line cut short by the rank's end is
  dropped (the collective it would name never ran)."""
  out = []
  for ln in path.read_text().splitlines():
    try:
      out.append(json.loads(ln))
    except json.JSONDecodeError:
      break
  return out


def _rank_main(out_dir: str) -> int:
  """One rank of ``check_ranked``: run the job's entries over a gloo
  process group and write ``rank<r>.json`` after each entry."""
  import datetime
  import importlib

  import torch.distributed as dist

  job = json.loads((Path(out_dir) / "job.json").read_text())
  repo_root = Path(job["repo_root"])
  sys.path.insert(0, str(repo_root))
  for mod in ("repro_torch.analysis.entries", *job["imports"]):
    importlib.import_module(mod)  # registers their entries
  from repro_torch import resolve_device
  from repro_torch.kernels import dispatch
  from repro_torch.launch.mesh import ProcessMesh
  rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
  dev = resolve_device(job["device"])
  if dev.type == "cuda":
    dev = torch.device("cuda", torch.cuda.current_device())
  dist.init_process_group(
      "gloo", rank=rank, world_size=world,
      timeout=datetime.timedelta(seconds=job["timeout"]))
  base = ProcessMesh.from_env(world, "gloo", dev)
  eps = {ep.name: ep for ep in dispatch.entry_points()}
  res: dict = {}
  path = Path(out_dir) / f"rank{rank}.json"
  ok = True
  for i, name in enumerate(job["entries"]):
    log = _Collectives(Path(out_dir) / f"rank{rank}.{i}.jsonl")
    rec = res[name] = {"findings": [], "error": None}
    try:
      run = run_entry(eps[name], dev, repo_root=repo_root, mesh=base,
                      collectives=log)
      rec.update(findings=[dataclasses.asdict(f) for f in run.findings],
                 syncs=run.syncs, debug_syncs=run.debug_syncs,
                 budget=run.budget, sync_sites=run.sync_sites,
                 seconds=run.seconds)
    except Exception as e:  # reported by the launcher, with the logs
      rec["error"] = f"{type(e).__name__}: {e}"
      rec["traceback"] = traceback.format_exc()
      ok = False
    tmp = path.with_suffix(".tmp")   # whole files only: the launcher
    tmp.write_text(json.dumps(res))  # may end this rank at any point
    os.replace(tmp, path)
    if not ok:   # the group may be broken: run nothing more on it
      break
  if ok:
    base.close()
  return 0 if ok else 1


def check_ranked(names, world: int, *, device="cpu",
                 repo_root: Path | None = None, imports=()):
  """Run the entries ``names`` over ``world`` gloo ranks (one
  ``torch.distributed.run`` launch on this host) and compare the ranks'
  collective logs (T2, T7).  Returns (findings, per-entry records of rank
  0 with the per-rank ``errors``).  ``imports`` are modules each rank
  imports first (to register entries defined outside the package)."""
  timeout = GROUP_TIMEOUT_S
  import repro_torch
  repo_root = (repo_root or Path.cwd()).resolve()
  src = str(Path(repro_torch.__file__).resolve().parents[1])
  with tempfile.TemporaryDirectory() as tmp:
    (Path(tmp) / "job.json").write_text(json.dumps(dict(
        entries=list(names), device=str(device), repo_root=str(repo_root),
        imports=list(imports), timeout=timeout)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m",
         "repro_torch.analysis.trace_check", tmp],
        env=env, capture_output=True, text=True,
        timeout=timeout * (len(names) + 2) + 300)
    ranks, logs = [], {}
    for r in range(world):
      p = Path(tmp) / f"rank{r}.json"
      ranks.append(json.loads(p.read_text()) if p.exists() else {})
      for i, name in enumerate(names):
        lp = Path(tmp) / f"rank{r}.{i}.jsonl"
        logs.setdefault(name, []).append(
            _read_log(lp) if lp.exists() else [])
  findings: list[Finding] = []
  records = {}
  for name in names:
    per = [rk.get(name) for rk in ranks]
    errors = {r: (rec or {}).get("error") or ("did not run" if rec is None
                                              else None)
              for r, rec in enumerate(per)}
    errors = {r: e for r, e in errors.items() if e}
    cmp = compare_ranks(name, logs[name])
    findings.extend(cmp)
    for rec in per:
      for f in (rec or {}).get("findings", []):
        findings.append(Finding(**f))
    rec0 = dict(per[0] or {})
    rec0["errors"] = errors
    rec0["diverged"] = any(f.rule == "T2" for f in cmp)
    records[name] = rec0
  if proc.returncode != 0 and not any(r["errors"] for r in records.values()):
    raise RuntimeError(f"ranked run failed:\n{proc.stdout}\n{proc.stderr}")
  return findings, records


if __name__ == "__main__":
  sys.exit(_rank_main(sys.argv[1]))
