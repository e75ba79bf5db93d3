"""One-off timings of the pairwise and facility kernels on the card, kept
out of the smoke: CUDA-event means of the kernels as shipped, beside
variants of ``csrc/pairwise.cu`` built with ``nvcc`` and beside the
package of another checkout.

  python -m repro_torch.kernels.diagnose split [--d D]
      the kernel at s11's shape (16 shards, d D, linear, f32) beside two
      variants built from the same source: one whose TMA stores never run
      (the tile still goes through the staging buffer), one that keeps every
      shared-memory load but does a quarter of the FFMAs.  Their differences
      split the time into the global stores, the FFMAs and the rest (at a
      streamed width, the rest holds the band's reloads from L2).
  python -m repro_torch.kernels.diagnose widths [--parent DIR] [--d ...]
      ``ops.pairwise`` at s11's shape for several widths d (16 shards of
      16384 rows; 4096 from d = 3072, the Tiny Images width, n = 65536),
      linear f32, its padded copy timed alone beside it, the resident
      widths also with the streamed ring forced, ``torch.matmul`` beside.
  python -m repro_torch.kernels.diagnose facility [--parent DIR] [--d ...]
      the four facility / coverage entries of ``ops`` at GreeDi's full-size
      shapes (linear, f32; bf16 too for round 1): the round-1 selects (16 x
      16384 x 16384; 16 x 4096 x 4096 from d = 3072), the round-2 selects
      and gains (262144 eval rows against 1024 candidates) and the lazy
      rescans (16 x 16384 x 256), at each width d.  Each call is timed with
      its operands as they are (``ms``: any padded copy made in the call)
      and pitched once beforehand as a selection holds them
      (``pitched_ms``); ``copy_ms`` is the padded copies alone and
      ``copy_share`` their share of the pitched call.
  python -m repro_torch.kernels.diagnose e2e --parent DIR [--d D]
      the coreset main path at n = 262144, d D (default 768), k = kappa =
      64, m = 16: the reference protocol's fused select path and the fast
      engine through the CLI: wall time, peak memory, launches and the
      selections.
  python -m repro_torch.kernels.diagnose colsum
      ``ops.relu_colsum`` at the round-2 shape (16 x 16384 x 1024) on two
      operand sets, the smoke's (a ``pairwise`` block) and a block of unit
      rows of width 1024: CUDA-event means over 5 and over 50 calls, the
      host's time a call and the device's (the profiler's kernel time).
  python -m repro_torch.kernels.diagnose profiler --first colsum|cut
      torch.profiler's kernel records and launch calls in each of 5
      windows of 3 calls, for the three calls whose kernels a call the
      smoke counts by profiler (``relu_colsum``, ``graph_cut_gain`` at 16 x
      36692, ``graph_cut_select`` unbatched at 36692 and at the paper's 10
      x 1899), profiled in
      the order ``--first`` starts; ``--gap-s`` waits that
      long after the first call's windows, profiling one window of it
      every 15 s, and prints each window's lag from the first launch call
      to its kernel's record (the host and device clocks' agreement).

With ``--parent DIR`` the same readings are taken through the package of
the checkout at DIR (its ``src``, its kernels built from its own sources)
in a process of its own, in the order parent, this, this, parent; the
helpers below run there from their source text, so they use only what
every checkout's package offers (``ops``, ``build.build``).  ``widths``
compares the outputs by a checksum of their bits, ``facility`` the
selections and the gains, ``e2e`` the selections.  Prints one JSON line per
reading, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build, ops, ring

M, NL = 16, 16384  # s11: 16 shards of 16384 rows


def shard_rows(d: int) -> int:
  """Rows a shard at width d: 16384 (n = 262144), 4096 from d = 3072 (n =
  65536, the size of the paper's Tiny Images experiment)."""
  return 4096 if d >= 3072 else NL


# ---------------------------------------------------------------------------
# readings through the public entry points; their source text also runs in
# another checkout's process (``_in_checkout``), so each imports what it uses
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 3) -> float:
  """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def unit_rows(seed: int, *shape, dtype=None):
  """Rows of unit norm on the card, drawn from ``seed``."""
  import torch
  g = torch.Generator(device="cuda").manual_seed(seed)
  x = torch.randn(*shape, generator=g, device="cuda")
  x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
  return x if dtype is None else x.to(dtype)


def checksum(out) -> list:
  """A fingerprint of a (B, n, n) float32 block's bits: per batch entry the
  sums of the int32 bit patterns weighted by row and by column index."""
  import torch
  n = out.shape[-1]
  w = torch.arange(1, n + 1, device=out.device, dtype=torch.int64)
  sums = []
  for b in range(out.shape[0]):
    v = out[b].view(torch.int32)
    sums.append([int((v.sum(dim=1, dtype=torch.int64) * w).sum()),
                 int((v.sum(dim=0, dtype=torch.int64) * w).sum())])
  return sums


def pairwise_reading(d: int, n: int) -> dict:
  """``ops.pairwise`` linear f32 on (16, n, d) x itself: time and the
  output's checksum."""
  import torch

  from repro_torch.kernels import ops
  x = unit_rows(0, 16, n, d)
  out = ops.pairwise(x, x, kernel="linear")
  row = {"shape": [16, n, n, d], "ms": time_ms(
      lambda: ops.pairwise(x, x, kernel="linear")), "sum": checksum(out)}
  del out, x
  torch.cuda.empty_cache()
  return row


def facility_inputs(call: str, n_part, ne: int, nc: int, d: int,
                    dtype: str) -> tuple:
  """The arguments of ``ops.<call>`` at these shapes: unit rows (their
  absolute values for coverage), a coverage state with some rows
  saturated, a mask with 5 % dead rows, 2 % infeasible candidates."""
  import torch
  g = torch.Generator(device="cuda").manual_seed(1)
  lead = () if n_part is None else (n_part,)
  td = getattr(torch, dtype)
  ev = unit_rows(2, *lead, ne, d)
  cd = unit_rows(3, *lead, nc, d)

  def rand(*shape):
    return torch.rand(*shape, generator=g, device="cuda")
  if call.startswith("coverage"):
    ev, cd = ev.abs(), cd.abs()
    cap = 0.25 * 0.64 * ne * (0.8 + 0.4 * rand(*lead, ne))
    vecs = (cap * 1.2 * rand(*lead, ne), cap)
  else:
    vecs = (0.1 * rand(*lead, ne),)
  mask = (rand(*lead, ne) > 0.05).float()
  ok = (rand(*lead, nc) > 0.02,) if call.endswith("select") else ()
  return (ev.to(td), cd.to(td), *vecs, mask, *ok)


def facility_reading(call: str, n_part, ne: int, nc: int, d: int,
                     dtype: str) -> dict:
  """``ops.<call>`` at these shapes: time and result."""
  import torch

  from repro_torch.kernels import ops
  args = facility_inputs(call, n_part, ne, nc, d, dtype)
  fn = getattr(ops, call)
  r = fn(*args)
  row = {"ms": time_ms(lambda: fn(*args))}
  if call.endswith("select"):
    row["best"] = r[0].reshape(-1).tolist()
    row["idx"] = r[1].reshape(-1).tolist()
  else:
    row["gains"] = r.reshape(-1).tolist()
  del args, r
  torch.cuda.empty_cache()
  return row


def e2e_reading(n: int, d: int, k: int, m: int, tmp: str) -> dict:
  """The coreset path at full size, the reference protocol and the fast
  engine through the CLI: wall, peak, launches, selection and f(S)."""
  import time

  import numpy as np
  import torch

  from repro_torch import no_tf32
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.kernels import ops
  from repro_torch.launch import select as cli
  no_tf32()
  feats = EmbeddedCorpus(n_docs=n, feat_dim=d, seed=0).features()

  def value(sel):
    obj = O.FacilityLocation()
    sf = feats[torch.as_tensor(sel, device=feats.device)]
    st = GD.set_value_feats(obj, obj.init(feats), sf, torch.ones(
        sf.shape[:1], dtype=torch.bool, device=feats.device))
    return float(obj.value(st))
  out = {}
  for name in ("reference", "fast"):
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name == "reference":
      sel = greedi_select_indices(torch.Generator().manual_seed(0), feats,
                                  m=m, kappa=k, k_final=k)
    else:
      path = f"{tmp}/sel.npy"
      cli.main(["--n", str(n), "--d", str(d), "--k", str(k), "--mesh",
                str(m), "--no-coverage", "--out", path])
      sel = np.load(path)
    torch.cuda.synchronize()
    out[name] = dict(wall_s=time.perf_counter() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     launches={kk: v for kk, v in ops.launch_counts().items()
                               if v}, sel=[int(i) for i in sel],
                     value=value(sel))
  return out


_HELPERS = (time_ms, unit_rows, checksum, pairwise_reading, facility_inputs,
            facility_reading, e2e_reading)


def _in_checkout(root: Path, reading, calls: list) -> list:
  """``reading(*args)`` for each ``args`` of ``calls`` in a process whose
  ``repro_torch`` is the one under ``root/src``; their results."""
  torch.cuda.empty_cache()  # leave the card to the other process
  script = "\n\n".join(["import json, sys", "from repro_torch.kernels import "
                        "build", "build.build()",
                        *(inspect.getsource(f) for f in _HELPERS),
                        f"for a in json.loads(sys.argv[1]):\n  print('ROW ' + "
                        f"json.dumps({reading.__name__}(*a)), flush=True)"])
  env = dict(os.environ, PYTHONPATH=str(root / "src"))
  proc = subprocess.run([sys.executable, "-c", script, json.dumps(calls)],
                        env=env, capture_output=True, text=True, check=False)
  rows = [json.loads(ln[4:]) for ln in proc.stdout.splitlines()
          if ln.startswith("ROW ")]
  if proc.returncode != 0 or len(rows) != len(calls):
    raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
  return rows


def _rounds(parent: Path | None, reading, calls: list) -> dict:
  """The readings in this process (twice) and, with a parent, in its
  checkout's process before and after: {"this": [...], "parent": [...]},
  each a list of rounds of one result per call."""
  runs = {"this": [], "parent": []}
  for who in (["parent"] if parent else []) + ["this", "this"] + (
      ["parent"] if parent else []):
    runs[who].append(_in_checkout(parent, reading, calls) if who == "parent"
                     else [reading(*a) for a in calls])
  return runs


# ---------------------------------------------------------------------------
# this checkout's own variants
# ---------------------------------------------------------------------------


def _compile_variant(name: str, edits: dict[str, str]):
  """``csrc/pairwise.cu`` with this checkout's headers (any file named in
  ``edits`` replaced by its text there), built into
  build/kernels/diagnose/<name>; its ``sm90_pairwise``."""
  import ctypes
  out = build.BUILD_ROOT / "diagnose" / name
  out.mkdir(parents=True, exist_ok=True)
  for f in [*build.CSRC.glob("*.cuh"), build.CSRC / "pairwise.cu"]:
    (out / f.name).write_text(edits.get(f.name, f.read_text()))
  proc = subprocess.run(
      [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "pairwise.so"),
       str(out / "pairwise.cu")], stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True, check=False)
  (out / "pairwise.log").write_text(proc.stdout)
  if proc.returncode != 0:
    raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}")
  fn = ctypes.CDLL(str(out / "pairwise.so")).sm90_pairwise
  fn.argtypes = build.ENTRIES["sm90_pairwise"][1]
  fn.restype = ctypes.c_int
  return fn


def _launcher(x, out, streamed: bool | None = None, fn=None):
  """``sm90_pairwise`` (this package's, or ``fn``) on (x, x) linear into
  ``out``; ``streamed`` forces the ring mode (None: ``ring.plan``'s)."""
  fn = fn or build.entry("sm90_pairwise")
  b, n, d = x.shape
  if streamed is None:
    streamed = ring.plan("pairwise", d, x.element_size()).streamed
  f = ring.features("pairwise", x)  # padded where TMA needs it
  args = (f.t.data_ptr(), f.t.data_ptr(), out.data_ptr(), b, n, n, d, f.ld,
          f.ld, f.bs, f.bs, 0, 0, 1.0, int(streamed), build.stream_of(x))

  def run():
    err = fn(*args)
    if err != 0:
      raise RuntimeError(f"pairwise launch error {err}")
  return run


def split(d: int = 64) -> None:
  src = (build.CSRC / "pairwise.cu").read_text()
  loop = (build.CSRC / "ring.cuh").read_text()  # box_fma, the FFMA loop
  store = "tma_store3(&omap,"
  fma = ("#pragma unroll\n        for (int j = 0; j < 8; ++j) acc[i][j] = "
         "fmaf(a[e], b[j][e], acc[i][j]);")
  if src.count(store) != 1 or loop.count(fma) != 1:
    raise RuntimeError("the variant edits no longer match csrc/pairwise.cu "
                       "and csrc/ring.cuh")
  variants = {
      "no_stores": {"pairwise.cu": src.replace(store, "if (bx < 0) " + store)},
      "quarter_ffma": {"ring.cuh": loop.replace(
          fma, "acc[i][e] = fmaf(a[e], b[e][e] + b[e + 4][e], acc[i][e]);")},
  }
  fns = {k: _compile_variant(k, v) for k, v in variants.items()}
  n = shard_rows(d)
  x = unit_rows(0, M, n, d)
  out = torch.empty((M, n, n), device="cuda")
  ms = {"full": time_ms(lambda: ops.pairwise(x, x, kernel="linear"))}
  for k, fn in fns.items():
    ms[k] = time_ms(_launcher(x, out, fn=fn))
  ms["full_again"] = time_ms(lambda: ops.pairwise(x, x, kernel="linear"))
  print(json.dumps({"split": [M, n, n, d],
                    "mode": ring.plan("pairwise", d, 4).mode, "ms": ms,
                    "stores_ms": ms["full"] - ms["no_stores"],
                    "ffma_three_quarters_ms": ms["full"] - ms["quarter_ffma"],
                    "ffma_bound_ms": 2 * M * n * n * d / 67e12 * 1e3}),
        flush=True)


def widths(parent: Path | None, ds: list[int]) -> None:
  calls = [[d, shard_rows(d)] for d in ds]
  runs = _rounds(parent, pairwise_reading, calls)
  for i, (d, n) in enumerate(calls):
    this = [r[i] for r in runs["this"]]
    rp = ring.plan("pairwise", d, 4)
    row = {"shape": [M, n, n, d], "kernel": "linear", "dtype": "f32",
           "mode": rp.mode, "ms": [r["ms"] for r in this],
           "repeat_identical": this[0]["sum"] == this[1]["sum"]}
    if parent:
      old = [r[i] for r in runs["parent"]]
      row["parent_ms"] = [r["ms"] for r in old]
      row["equal_to_parent"] = this[0]["sum"] == old[0]["sum"]
    x = unit_rows(0, M, n, d)
    if rp.pitch != d:  # the wrapper's padded copy, timed alone
      row["copy_ms"] = time_ms(lambda: ring.features("pairwise", x))
    a = torch.empty((M, n, n), device="cuda")
    if not rp.streamed:  # the streamed ring at a resident width
      row["forced_streamed_ms"] = time_ms(_launcher(x, a, True))
      row["forced_streamed_equal"] = checksum(a) == this[0]["sum"]
    row["library_ms"] = time_ms(lambda: torch.matmul(x, x.mT, out=a))
    row["ffma_bound_ms"] = 2 * M * n * n * d / 67e12 * 1e3
    print(json.dumps(row), flush=True)
    del a, x
    torch.cuda.empty_cache()


# GreeDi's full-size facility / coverage calls (n = 262144, m = 16):
# (label, entry, partitions (None: unbatched), eval rows, candidates)
FACILITY_SHAPES = (
    ("round1", "facility_select", 16, NL, NL),
    ("round1", "coverage_select", 16, NL, NL),
    ("round2", "facility_select", 1, 262144, 1024),
    ("round2", "facility_gain", 1, 262144, 1024),
    ("round2", "coverage_select", None, 262144, 1024),
    ("lazy rescan", "facility_gain", 16, NL, 256),
    ("lazy rescan", "coverage_gain", 16, NL, 256),
)


def _pitched_reading(call, n_part, ne, nc, d, dtype) -> dict:
  """The call with its features pitched once beforehand (what a selection
  hands every step), the padded copies of one call alone, and which
  operands they are."""
  args = facility_inputs(call, n_part, ne, nc, d, dtype)
  name = "diagnose " + call
  copies = [k for k, t in zip(("ev", "cd"), args[:2])
            if ring.features(name, t).copied]
  fn = getattr(ops, call)
  held = (ring.pitched(args[0]), ring.pitched(args[1]), *args[2:])
  row = {"copies": copies, "pitched_ms": time_ms(lambda: fn(*held))}
  if copies:
    row["copy_ms"] = time_ms(lambda: [ring.features(name, t)
                                      for t in args[:2]])
    row["copy_share"] = row["copy_ms"] / row["pitched_ms"]
  del args, held
  torch.cuda.empty_cache()
  return row


def facility(parent: Path | None, ds: list[int]) -> None:
  calls, labels = [], []
  for d in ds:
    for label, call, n_part, ne, nc in FACILITY_SHAPES:
      if d >= 3072:  # the Tiny Images size: round 1 of 16 x 4096
        if label != "round1":
          continue
        ne = nc = shard_rows(d)
      for dtype in (("float32", "bfloat16") if label == "round1"
                    else ("float32",)):
        calls.append([call, n_part, ne, nc, d, dtype])
        labels.append(label)
  runs = _rounds(parent, facility_reading, calls)
  for i, (call, n_part, ne, nc, d, dtype) in enumerate(calls):
    a, b = runs["this"][0][i], runs["this"][1][i]
    rp = ring.plan("facility", d, 4 if dtype == "float32" else 2,
                   3 if call.startswith("coverage") else 2)
    np_ = 1 if n_part is None else n_part
    row = {"shape": [n_part, ne, nc, d], "call": call, "label": labels[i],
           "kernel": "linear", "dtype": dtype, "path": rp.mode,
           "ms": [a["ms"], b["ms"]],
           **_pitched_reading(call, n_part, ne, nc, d, dtype),
           "repeat_identical": {k: v for k, v in a.items() if k != "ms"} ==
           {k: v for k, v in b.items() if k != "ms"},
           "ffma_bound_ms": (2 * d + (5 if call.startswith("coverage")
                                      else 3)) * np_ * ne * nc / 67e12 * 1e3}
    if parent:
      p = runs["parent"][0][i]
      row["parent_ms"] = [r[i]["ms"] for r in runs["parent"]]
      if "idx" in a:
        row["idx_equal_to_parent"] = sum(
            x == y for x, y in zip(a["idx"], p["idx"]))
        row["best_max_rel_diff"] = max(
            abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a["best"],
                                                            p["best"]))
      else:
        row["gains_max_rel_diff"] = max(
            abs(x - y) for x, y in zip(a["gains"], p["gains"])) / max(
                max(abs(y) for y in p["gains"]), 1e-30)
    print(json.dumps(row), flush=True)


def e2e(parent: Path, d: int, n: int = 262144, k: int = 64,
        m: int = 16) -> None:
  root = build.CSRC.parents[3]
  build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
    calls = [[n, d, k, m, tmp]]
    runs = {"this": [], "parent": []}
    for who in ("parent", "this", "this", "parent"):  # a process each
      runs[who].append(_in_checkout(parent if who == "parent" else root,
                                    e2e_reading, calls)[0])
  this, par = runs["this"][0], runs["parent"][0]
  row = {"e2e": [n, d, k, m]}
  for path in ("reference", "fast"):
    row[path] = {
        "wall_s": [r[path]["wall_s"] for r in runs["this"]],
        "parent_wall_s": [r[path]["wall_s"] for r in runs["parent"]],
        "peak_gib": this[path]["peak_gib"],
        "parent_peak_gib": par[path]["peak_gib"],
        "launches": this[path]["launches"],
        "parent_launches": par[path]["launches"],
        "value": this[path]["value"], "parent_value": par[path]["value"],
        "same_selection_as_parent": this[path]["sel"] == par[path]["sel"],
        "repeat_identical": runs["this"][1][path]["sel"] == this[path]["sel"]}
  row["reference_vs_fast_equal"] = (this["reference"]["sel"] ==
                                    this["fast"]["sel"])
  print(json.dumps(row), flush=True)


def colsum_round2() -> None:
  """``ops.relu_colsum`` at the round-2 shape on the smoke's operands and
  on unit rows of width 1024, each read four ways (the module's doc)."""
  import time

  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  local = unit_rows(1, M, NL, 64)
  s2 = ops.pairwise(local, unit_rows(2, 1024, 64), kernel="linear")
  del local
  blocks = {"pairwise block": s2, "unit rows 1024": unit_rows(3, M, NL,
                                                               1024)}
  for name, s in blocks.items():
    cov = s[:, :, :8].amax(dim=2).clamp_min(0.0)
    def call():
      return ops.relu_colsum(s, cov)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
      call()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(10):
        call()
      torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    print(json.dumps({
        "colsum round2": name, "shape": list(s.shape), "pitch": s.stride(1),
        "event_ms_5": [time_ms(call, reps=5) for _ in range(3)],
        "event_ms_50": [time_ms(call, reps=50) for _ in range(3)],
        "host_ms": host_ms,
        "device_ms": sum(e.self_device_time_total for e in kern) / 1e4,
        "kernel_records": sum(e.count for e in kern)}), flush=True)


def profiler_windows(first: str, gap_s: float) -> None:
  """Kernel records and launch calls a profiled window of 3 calls sees
  (the module's doc), with each record's start in µs from the trace's."""
  import time

  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from repro_torch.data.graphs import chung_lu_graph, social_graph
  g = torch.Generator(device="cuda").manual_seed(15)

  def cut_operands(w, P):
    n = w.shape[0]
    x = (torch.rand(P, n, generator=g, device="cuda") < 0.002).float()
    part = torch.randint(0, P, (n,), generator=g, device="cuda")
    ind = (part == torch.arange(P, device="cuda")[:, None]).float()
    x = x * ind
    ok = (torch.rand(P, n, generator=g, device="cuda") < 0.98) & (x == 0)
    return x, ind, ok
  s = unit_rows(2, M, NL, 1024)
  cov = s[:, :, :8].amax(dim=2).clamp_min(0.0)
  w = chung_lu_graph(36692, 183831, seed=0, device="cuda")
  x, ind, _ = cut_operands(w, 16)
  wp = torch.as_tensor(social_graph(1899, seed=0), device="cuda")
  xp, indp, okp = cut_operands(wp, 10)
  x1 = (torch.rand(w.shape[0], generator=g, device="cuda") < 0.002).float()
  ok1 = x1 == 0
  calls = {"relu_colsum": lambda: ops.relu_colsum(s, cov),
           "graph_cut_gain": lambda: ops.graph_cut_gain(w, x, ind),
           "graph_cut_select unbatched": lambda: ops.graph_cut_select(
               w, x1, ok1),
           "graph_cut_select paper": lambda: ops.graph_cut_select(
               wp, xp, okp, indp)}
  order = list(calls)
  if first == "cut":
    order = order[1:] + order[:1]
  t_first = time.perf_counter()

  def window(name, label):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
      for _ in range(3):
        calls[name]()
      torch.cuda.synchronize()
    evs = prof.events()
    kern = [e for e in evs if e.device_type == DeviceType.CUDA]
    launch = [e for e in evs if e.device_type == DeviceType.CPU
              and e.name.startswith(("cudaLaunch", "cuLaunch"))]
    row = {"profiler": name, "first": first,
           "window": label, "kernel_records": len(kern),
           "launch_calls": len(launch),
           "kernel_start_us": [round(e.time_range.start, 1) for e in kern],
           "launch_start_us": [round(e.time_range.start, 1) for e in launch],
           "kernels": sorted({e.name[:40] for e in kern}),
           "launch_names": sorted({e.name for e in launch}),
           "since_first_s": round(time.perf_counter() - t_first, 1)}
    if kern and launch:
      row["first_lag_us"] = round(min(e.time_range.start for e in kern) -
                                  min(e.time_range.start for e in launch), 1)
    print(json.dumps(row), flush=True)
  for i, name in enumerate(order):
    calls[name]()
    torch.cuda.synchronize()
    for w_ in range(5):
      window(name, w_)
    if i == 0 and gap_s:
      for k in range(int(gap_s // 15)):
        time.sleep(15)
        window(name, f"gap {k}")


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  sub = ap.add_subparsers(dest="cmd", required=True)
  s = sub.add_parser("split")
  s.add_argument("--d", type=int, default=64)
  w = sub.add_parser("widths")
  w.add_argument("--parent", type=Path, default=None)
  w.add_argument("--d", type=int, nargs="+",
                 default=[22, 64, 128, 768, 3072])
  f = sub.add_parser("facility")
  f.add_argument("--parent", type=Path, default=None)
  f.add_argument("--d", type=int, nargs="+", default=[64])
  e = sub.add_parser("e2e")
  e.add_argument("--parent", type=Path, required=True)
  e.add_argument("--d", type=int, default=768)
  sub.add_parser("colsum")
  pr = sub.add_parser("profiler")
  pr.add_argument("--first", choices=("colsum", "cut"), default="colsum")
  pr.add_argument("--gap-s", type=float, default=0.0)
  args = ap.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=False).stdout.strip(), flush=True)
  if args.cmd == "split":
    split(args.d)
  elif args.cmd == "widths":
    widths(args.parent, args.d)
  elif args.cmd == "facility":
    facility(args.parent, args.d)
  elif args.cmd == "colsum":
    colsum_round2()
  elif args.cmd == "profiler":
    profiler_windows(args.first, args.gap_s)
  else:
    e2e(args.parent, args.d)


if __name__ == "__main__":
  main()
