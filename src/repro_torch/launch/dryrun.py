"""Multi-pod dry run (the port of ``src/repro/launch/dryrun.py``): every
(arch x shape x mesh) cell of the reference's sweep, counted on the
``meta`` device.

The reference lowers and compiles each cell ahead of time on 512
placeholder CPU devices and reads XLA's analyses.  The port has no HLO:
a cell runs rank 0's own code with shapes alone.

  * The mesh is the production mesh (16 x 16 over ("data", "model"), or
    2 x 16 x 16 over ("pod", "data", "model")) as ``launch.mesh.
    make_production_mesh`` lays it out, its groups ``CountingGroup``s: they
    stand in for the 256 or 512 ranks, hand back meta tensors of the
    shapes the real collectives give, and record each collective's kind
    and the bytes this rank receives (``collective_bytes_per_device``).
    The port's sums are a gather then a rank-ordered fold, so they count
    as "all-gather"; its reduce-scatter and all-to-all are all-to-alls of
    equal chunks, counted as "reduce-scatter" and "all-to-all".
  * The model is ``Model(cfg, device="meta", mesh=, par=parallelism_for
    (...))``: rank-local shapes from ``param_specs``, nothing allocated.
    The step is the real ``make_train_step`` (the reference's 8
    microbatches, remat "full"), ``prefill`` or ``decode_step``, at the
    cell's global batch divided by the data ranks; a batch of one row
    keeps its cache split by length over them (``transformer.KVSplit``).
  * ``flops_per_device`` is ``torch.utils.flop_counter.FlopCounterMode``'s
    count of the step, the kernels by their meta routes' formulas
    (``kernels.meta``); Python runs every loop, so it is the whole step's
    count (the reference's rolled count is not), and ``flops_global_exact``
    is it times the chips (rank 0 stands for every rank).
  * ``bytes_per_device`` counts every op's inputs and outputs once: an
    unfused count, not XLA's fused ``bytes accessed``.
  * ``mem``: ``argument_gb`` the rank's parameters, optimizer state,
    batch and caches; ``temp_gb`` the peak of the live meta storages the
    step makes (a dispatch-mode tracker); ``output_gb`` what the step
    returns beside its arguments (the port writes parameters, optimizer
    state and caches in place, so they are not outputs); ``alias_gb`` 0
    (no donation in PyTorch: said so, not measured).
  * The select cells run the port's sharded engines on meta over a
    counting ``ProcessMesh`` with the reference's ``axis_names`` choices:
    ``greedi_sharded`` over the data axis, ``greedi_hierarchical`` over
    pods x data, ``greedi_sharded_fast`` over every device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import meta  # noqa: F401  (the formulas, before
# any FlopCounterMode copies the registry)
from repro_torch.launch.mesh import (ProcessMesh, dp_axes_of, dp_size_of,
                                     make_production_mesh, production_shape,
                                     virtual_mesh)
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Model, Parallelism
from repro_torch.models.transformer import KVSplit
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

META = torch.device("meta")

SHAPES: dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the paper's own technique as a dry-run cell: sharded GreeDi selection
SELECT_SHAPES = {
    "select_1m": dict(kind="select", n=1 << 20, d=256, kappa=64, k=64),
    "select_1m_fast": dict(kind="select", n=1 << 20, d=256, kappa=64, k=64,
                           fast=True),
}


# ``--reduced``: the reduced configs on a 2 x 2 (or 2 x 2 x 2) mesh, each
# sequence 1/64 of the cell's (1/16 in training) and a corpus of 2^14 x 16
REDUCED_MESH = {False: (2, 2), True: (2, 2, 2)}
REDUCED_SELECT = dict(n=1 << 14, d=16, kappa=8, k=8)


def cell_shape(shape: str, small: bool = False) -> dict:
  """A cell's shape: the reference's, or (``small``) the reduced one."""
  if shape in SELECT_SHAPES:
    sh = dict(SELECT_SHAPES[shape])
    return {**sh, **REDUCED_SELECT} if small else sh
  sh = dict(SHAPES[shape])
  if small:   # a training rank keeps whole MoE groups (grok's 1024 tokens)
    sh["seq"] //= 16 if sh["kind"] == "train" else 64
  return sh


def mesh_shape(multi_pod: bool, small: bool = False) -> tuple:
  return (REDUCED_MESH[multi_pod] if small
          else production_shape(multi_pod=multi_pod)[0])


def applicable(cfg: ModelConfig, shape: str) -> bool:
  if shape == "long_500k":
    return cfg.subquadratic          # sub-quadratic archs only
  return True


def parallelism_for(cfg: ModelConfig, mesh, kind: str = "train"
                    ) -> Parallelism:
  """The reference's rule: FSDP always in training, in serving only where
  the bf16 weights per model rank pass 12 GB; ``ep`` where the experts
  divide the model axis, else ``ep_pod`` where they divide the pod axis;
  ``seq_shard`` always."""
  dp = dp_axes_of(mesh)
  msz = mesh.shape["model"]
  fsdp = True
  if kind != "train":
    fsdp = cfg.param_count() * 2.0 / msz > 12e9
  ep = bool(cfg.moe.num_experts) and cfg.moe.num_experts % msz == 0
  psz = mesh.shape.get("pod", 1)
  ep_pod = (bool(cfg.moe.num_experts) and not ep and psz > 1
            and cfg.moe.num_experts % psz == 0)
  return Parallelism(
      dp_axes=dp, model_axis="model", ep=ep, ep_pod=ep_pod,
      fsdp=fsdp, dp_size=dp_size_of(mesh), model_size=msz, seq_shard=True,
      dp_axis_sizes=tuple(mesh.shape[a] for a in dp))


def all_cells() -> list[tuple[str, str]]:
  cells = [(a, s) for a in ARCHS for s in SHAPES
           if applicable(get_config(a), s)]
  cells += [("greedi-select", s) for s in SELECT_SHAPES]
  return cells


# ---------------------------------------------------------------------------
# the counting mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CountingGroup(ProcessMesh):
  """A group of ``world`` ranks seen from one of them, with no process
  behind it: every collective hands back meta tensors of the shapes the
  real one gives and adds the bytes this rank would receive to ``log``
  under its kind (shared by the groups of one mesh)."""
  log: dict = dataclasses.field(default_factory=dict)

  def _count(self, kind: str, nbytes: int) -> None:
    self.log[kind] = self.log.get(kind, 0.0) + float(nbytes)

  def gather_parts(self, x: torch.Tensor) -> list:
    if self.world == 1:
      return [x]
    self._gathered(x)
    return [x] + [torch.empty_like(x) for _ in range(self.world - 1)]

  def _gathered(self, x: torch.Tensor) -> None:
    got = (self.world - 1) * x.numel() * x.element_size()
    self.gathers += 1
    self.gather_bytes += got
    self._count("all-gather", got)

  def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    if self.world == 1:
      return x
    self._gathered(x)
    shape = list(x.shape)
    shape[dim] *= self.world
    return x.new_empty(shape)

  def sum(self, x: torch.Tensor, div: int = 1) -> torch.Tensor:
    """The gather of a sum; its fold is not run (meta holds no values)."""
    if self.world > 1:
      self._gathered(x)
    return torch.empty_like(x)

  def _all_to_all(self, out, src, out_sizes, in_sizes) -> None:
    if out_sizes is not None:
      raise NotImplementedError("the dry run's exchanges are equal splits")
    got = (out.numel() - out.numel() // self.world) * out.element_size()
    self.exchanges += 1
    self.exchange_bytes += got
    self._count("all-to-all", got)

  def _exchanged(self, x: torch.Tensor, kind: str, dim: int) -> list:
    if x.shape[dim] % self.world:
      raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                       f"{self.world} ranks")
    got = (x.numel() - x.numel() // self.world) * x.element_size()
    self.exchanges += 1
    self.exchange_bytes += got
    self._count(kind, got)

  def reduce_scatter(self, x, dim: int = 0, div: int = 1):
    if self.world == 1:
      return x
    self._exchanged(x, "reduce-scatter", dim)
    shape = list(x.shape)
    shape[dim] //= self.world
    return x.new_empty(shape)

  def all_to_all(self, x, dim: int = 0):
    if self.world == 1:
      return x
    self._exchanged(x, "all-to-all", dim)
    return torch.empty_like(x)


def counting_mesh(shape, log: dict):
  """Rank 0's view of a mesh of ``shape``, its groups counting into
  ``log``: the production mesh (``make_production_mesh``) where ``shape``
  is one of its two."""
  def group(world, rank, axes):
    return CountingGroup(world, rank, world, META, "counting", log=log)
  for multi_pod in (False, True):
    if tuple(shape) == production_shape(multi_pod=multi_pod)[0]:
      return make_production_mesh(multi_pod=multi_pod, group_factory=group)
  return virtual_mesh(shape, group)


# ---------------------------------------------------------------------------
# the cost of a step on meta
# ---------------------------------------------------------------------------


_BOOL = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
         "logical_not", "logical_xor", "isnan", "isinf", "isfinite",
         "signbit"}
_FLOAT = {"exp", "log", "log1p", "expm1", "sqrt", "rsqrt", "sigmoid", "tanh",
          "sin", "cos", "reciprocal", "erf", "exp2", "log2", "silu",
          "gelu"}
_KINDS: dict = {}   # op -> how _pointwise takes it (None: it does not)


def _kind(func):
  kind = _KINDS.get(func, 0)
  if kind != 0:
    return kind
  schema = func._schema
  name = func._overloadpacket.__name__
  if (torch.Tag.pointwise not in func.tags or schema.is_mutable
      or len(schema.returns) != 1):
    kind = None
  elif name in _BOOL:
    kind = "bool"
  elif name in ("masked_fill", "where"):
    kind = name
  elif name in _FLOAT or (name == "div" and "mode" not in
                          func._overloadname):
    kind = "float"
  else:
    kind = "promote"
  _KINDS[func] = kind
  return kind


def _broadcast(shapes) -> tuple:
  first = shapes[0]
  if all(s == first for s in shapes):
    return tuple(first)
  return tuple(torch.broadcast_shapes(*shapes))


def _pointwise(func, args, kwargs):
  """The meta output of an out-of-place pointwise op from its operands'
  shapes and dtypes alone (the broadcast shape, the promoted dtype), or
  None for any other op.  Meta elementwise ops otherwise run Python
  reference implementations, some 0.1-2 ms a call: this gives the same
  shape and dtype (``Cost(check=True)`` holds it to the real meta kernel)
  for a few microseconds."""
  if kwargs:
    return None
  kind = _kind(func)
  if kind is None:
    return None
  tensors = [a for a in args if isinstance(a, torch.Tensor)]
  if not tensors or not all(t.is_meta for t in tensors):
    return None
  shape = _broadcast([t.shape for t in tensors])
  if kind == "bool":
    dtype = torch.bool
  elif kind == "masked_fill":
    dtype = args[0].dtype
  elif kind == "where":
    dtype = torch.result_type(args[1], args[2])
  else:
    operands = [a for a in args
                if isinstance(a, (torch.Tensor, int, float, bool))]
    if len(operands) == 1:
      dtype = operands[0].dtype
    elif len(operands) == 2:
      dtype = torch.result_type(*operands)
    else:
      return None
    if kind == "float" and not dtype.is_floating_point:
      dtype = torch.get_default_dtype()
  return torch.empty(shape, dtype=dtype, device=META)


class Cost(TorchDispatchMode):
  """One dispatch mode for a step on meta: its FLOPs through a
  ``FlopCounterMode``'s counter (the registry's formulas, the kernels'
  meta routes among them), every op's input and output bytes, and the
  peak of the live storages the ops make (freed when their last tensor
  goes: a weakref finalizer on each storage).  Pointwise ops on meta take
  ``_pointwise``."""

  def __init__(self, check: bool = False):
    super().__init__()
    self.counter = FlopCounterMode(display=False)
    self.bytes = 0
    self.live = 0
    self.peak = 0
    self._sizes = {}
    self.check = check

  @property
  def flops(self) -> int:
    return self.counter.get_total_flops()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = _pointwise(func, args, kwargs)
    if out is None:
      out = func(*args, **(kwargs or {}))
      self.counter._count_flops(func._overloadpacket, out, args,
                                kwargs or {})
    elif self.check:
      ref = func(*args, **(kwargs or {}))
      if ref.shape != out.shape or ref.dtype != out.dtype:
        raise AssertionError(f"{func}: {out.shape} {out.dtype} vs "
                             f"{ref.shape} {ref.dtype}")
    flat = [*args, *(kwargs or {}).values()]
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
      if isinstance(t, torch.Tensor):
        self._new(t)
      flat.append(t)
    for t in flat:
      if isinstance(t, torch.Tensor):
        self.bytes += t.numel() * t.element_size()
      elif isinstance(t, (tuple, list)):
        for x in t:
          if isinstance(x, torch.Tensor):
            self.bytes += x.numel() * x.element_size()
    return out

  def _new(self, t: torch.Tensor) -> None:
    st = t.untyped_storage()
    key = st._cdata
    if key in self._sizes:
      return
    self._sizes[key] = st.nbytes()
    self.live += st.nbytes()
    self.peak = max(self.peak, self.live)
    weakref.finalize(st, self._free, key)

  def _free(self, key) -> None:
    self.live -= self._sizes.pop(key, 0)


def _nbytes(tree) -> int:
  if isinstance(tree, torch.Tensor):
    return tree.numel() * tree.element_size()
  if isinstance(tree, dict):
    return sum(_nbytes(v) for v in tree.values())
  if isinstance(tree, (list, tuple)):
    return sum(_nbytes(v) for v in tree)
  return 0


def _batch(cfg: ModelConfig, rows: int, seq: int, lead=()) -> dict:
  dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
  shape = (*lead, rows, seq)
  out = {"tokens": torch.zeros(shape, dtype=torch.int64, device=META),
         "labels": torch.zeros(shape, dtype=torch.int64, device=META),
         "mask": torch.ones(shape, dtype=torch.float32, device=META)}
  if cfg.family == "encdec":
    out["frames"] = torch.zeros((*lead, rows, cfg.encoder.n_frames,
                                 cfg.d_model), dtype=dt, device=META)
  if cfg.family == "vlm":
    out["img_embeds"] = torch.zeros((*lead, rows, cfg.n_img_tokens,
                                     cfg.d_model), dtype=dt, device=META)
  return out


def _model_cell(cfg: ModelConfig, sh: dict, mesh, par: Parallelism,
                periods: int):
  """(args bytes, the step as a thunk) of one model cell on rank 0."""
  dp = mesh.dp_size
  b, s = sh["batch"], sh["seq"]
  kw = dict(device="meta", mesh=mesh, par=par, periods=periods)
  if sh["kind"] == "train":
    micro = sh.get("microbatches", 8)
    model = Model(cfg, remat="full", **kw)
    opt = init_opt_state(model)
    rows = b // micro // dp
    if rows < 1:
      raise ValueError(f"{cfg.name} {sh}: {b} rows in {micro} "
                       f"microbatches do not cover {dp} data ranks")
    batch = _batch(cfg, rows, s, lead=(micro,))
    step = make_train_step(model, OptConfig(), microbatches=micro)
    args = _nbytes(list(model.parameters())) + _nbytes(opt) + _nbytes(batch)
    return args, lambda: step(opt, batch)
  model = Model(cfg, remat=None, **kw)
  shardable = b > 1
  rows = b // dp if shardable else 1
  batch = _batch(cfg, rows, s)
  for k in ("labels", "mask"):
    del batch[k]
  memory = None
  if cfg.family == "vlm":
    memory = batch["img_embeds"]
  elif cfg.family == "encdec":
    memory = torch.zeros((rows, cfg.encoder.n_frames, cfg.d_model),
                         dtype=model.dtype, device=META)
  caches = model.init_cache(rows, s, memory=memory,
                            kv_split=None if shardable else KVSplit(mesh.dp))
  args = _nbytes(list(model.parameters())) + _nbytes(caches)
  if sh["kind"] == "prefill":
    return args + _nbytes(batch), lambda: model.prefill(batch, caches)
  token = torch.zeros((rows, 1), dtype=torch.int64, device=META)
  return args + _nbytes(token), lambda: model.decode_step(token, s - 1,
                                                          caches)


def _measure(args: int, fn, log: dict) -> dict:
  """Run ``fn`` under ``Cost``: its counts as flat numbers."""
  log.clear()   # the model's layout made no collective; the step's count
  cost = Cost()
  with cost:
    out = fn()
    out_bytes = _nbytes(out if not isinstance(out, tuple) else out[0])
    del out
  return {"flops": float(cost.flops), "bytes": float(cost.bytes),
          "args": float(args), "out": float(out_bytes),
          "temp": float(cost.peak),
          **{f"coll/{k}": v for k, v in log.items()}}


def _depths(cfg: ModelConfig) -> list:
  """The depths a cell runs at: the whole model where it has at most two
  periods, else one and two periods (each with the remainder layers)."""
  if cfg.n_periods <= 2:
    return [cfg]
  per = len(cfg.pattern)
  return [dataclasses.replace(cfg, n_layers=k * per + cfg.n_remainder)
          for k in (1, 2)]


def model_counts(cfg: ModelConfig, sh: dict, shape: tuple) -> dict:
  """A model cell's counts.  Its layers' periods are alike in every shape
  and collective, so each count is linear in the periods: the step runs
  on the model cut to one and to two periods (laid out as the whole
  model, ``Model(periods=)``), and the whole model's count is the first
  plus (periods - 1) times their difference (exact for FLOPs, bytes and
  collectives; the peak to the extent it grows by a period's saved
  activations)."""
  log: dict = {}
  mesh = counting_mesh(shape, log)
  par = parallelism_for(cfg, mesh, kind=sh["kind"])
  runs = [_measure(*_model_cell(c, sh, mesh, par, cfg.n_periods), log)
          for c in _depths(cfg)]
  if len(runs) == 1:
    return runs[0]
  one, two = runs
  keys = set(one) | set(two)
  return {k: one.get(k, 0.0) + (cfg.n_periods - 1) * (two.get(k, 0.0)
                                                      - one.get(k, 0.0))
          for k in keys}


def _select_cell(sh: dict, shape: tuple, log: dict):
  """(args bytes, the engine call as a thunk) of one select cell on rank
  0: the reference's axis_names, each a ProcessMesh of counting ranks
  (the model axis's ranks hold the data axis's rows over again)."""
  from repro_torch.core import objectives as O
  from repro_torch.core.greedi import (greedi_hierarchical, greedi_sharded,
                                       greedi_sharded_fast)
  n, d = sh["n"], sh["d"]
  multi = len(shape) == 3
  pods, data, model = shape if multi else (1, *shape)
  if sh.get("fast"):
    m = pods * data * model
  else:
    m = pods * data
  mesh = CountingGroup(m, 0, m, META, "counting", log=log)
  feats = torch.zeros((n // m, d), dtype=torch.float32, device=META)
  kw = dict(kappa=sh["kappa"], k_final=sh["k"], mesh=mesh)
  if sh.get("fast"):
    def fn():
      return greedi_sharded_fast(feats, m=m, kernel="linear", **kw)
  elif multi:
    def fn():
      return greedi_hierarchical(feats, pods=pods, per_pod=data,
                                 objective=O.FacilityLocation(
                                     kernel="linear"), **kw)
  else:
    def fn():
      return greedi_sharded(feats, m=m, objective=O.FacilityLocation(
          kernel="linear"), **kw)
  return _nbytes(feats), fn


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             verbose: bool = True, small: bool = False) -> dict:
  """One cell's record, the reference's fields (see the module
  docstring); ``small``: the reduced config, shape and mesh."""
  t0 = time.time()
  sh, dims = cell_shape(shape, small), mesh_shape(multi_pod, small)
  if arch == "greedi-select":
    log: dict = {}
    c = _measure(*_select_cell(sh, dims, log), log)
  else:
    cfg = get_config(arch)
    c = model_counts(reduced(cfg) if small else cfg, sh, dims)
  chips = 1
  for n in dims:
    chips *= n
  coll = {k[len("coll/"):]: v for k, v in sorted(c.items())
          if k.startswith("coll/")}
  rec = {
      "arch": arch, "shape": shape,
      "mesh": "x".join(map(str, dims)),
      "chips": chips,
      "compile_s": round(time.time() - t0, 1),
      "flops_per_device": c["flops"],
      "bytes_per_device": c["bytes"],
      "flops_global_exact": c["flops"] * chips,
      "bytes_global_exact": c["bytes"] * chips,
      "cost_pass_error": None,
      "collective_bytes_per_device": coll,
      "mem": {
          "argument_gb": c["args"] / 1e9,
          "output_gb": c["out"] / 1e9,
          "temp_gb": c["temp"] / 1e9,
          "alias_gb": 0.0,
      },
  }
  if verbose:
    peak = rec["mem"]["argument_gb"] + rec["mem"]["temp_gb"]
    shown = {k: f"{v / 1e6:.1f}MB" for k, v in coll.items()}
    print(f"[dryrun] {arch:22s} {shape:12s} {rec['mesh']:8s} "
          f"wall={rec['compile_s']:6.1f}s "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"mem(arg+temp)={peak:6.2f}GB coll={shown}", flush=True)
  return rec


def _job(job):
  """(record, None) or (None, the error) of one cell."""
  arch, shape, multi, small = job
  try:
    return run_cell(arch, shape, multi_pod=multi, small=small), None
  except Exception as e:
    return None, repr(e)[:300]


def main(argv=None) -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None)
  ap.add_argument("--mesh", choices=["single", "multi", "both"],
                  default="both")
  ap.add_argument("--out", default=None, help="append JSONL records here")
  ap.add_argument("--reduced", action="store_true",
                  help="the reduced configs, shapes and meshes (a quick "
                       "rehearsal on the CPU)")
  ap.add_argument("--jobs", type=int, default=1,
                  help="cells run side by side in this many processes")
  args = ap.parse_args(argv)

  cells = all_cells()
  if args.arch:
    cells = [(a, s) for a, s in cells if a == args.arch]
  if args.shape:
    cells = [(a, s) for a, s in cells if s == args.shape]
  meshes = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]

  t0 = time.time()
  jobs = [(arch, shape, multi, args.reduced) for arch, shape in cells
          for multi in meshes]
  if args.jobs > 1:
    import multiprocessing
    # the train cells (nearly all of the work) first, so the long ones do
    # not start last; the records keep the cells' order
    order = sorted(range(len(jobs)), key=lambda i: jobs[i][1] != "train_4k")
    with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
      done = pool.map(_job, [jobs[i] for i in order], chunksize=1)
    results = [None] * len(jobs)
    for i, r in zip(order, done):
      results[i] = r
  else:
    results = [_job(j) for j in jobs]
  failures = []
  for (arch, shape, multi, _), (rec, err) in zip(jobs, results):
    if err is not None:   # a dry-run failure is a bug in the system
      failures.append((arch, shape, multi, err))
      print(f"[dryrun] FAIL {arch} {shape} multi={multi}: {err}",
            flush=True)
    elif args.out:
      with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
  if failures:
    print(f"[dryrun] {len(failures)} FAILURES")
    sys.exit(1)
  print(f"[dryrun] all {len(jobs)} records OK in "
        f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
  main()
