#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, with nothing built: it builds the CUDA kernels
from ``src/repro_torch/kernels/csrc``; checks their edge cases (ragged
sizes, nothing feasible, exact ties) against the plain PyTorch versions;
drives the coreset path end to end through the entry points a user calls
(``repro_torch.data.selection`` and the ``repro_torch.launch.select`` CLI)
at the CLI's default size and at full size (n = 262144 embeddings of width
64, k = kappa = 64, m = 16 stacked shards), counting each kernel's
launches and checking the selections; holds every kernel against its plain
version at the shapes that path launches; and profiles the path.

Output: one line per phase; the card's name and power limit
(``nvidia-smi``); a ``{"kernels": [...]}`` JSON line with each kernel's
launches on the full-size main path, its error against the plain version,
its time, the plain version's time, the least time the card could take
(``bound_ms``), and the time of one PyTorch library call computing the same
function where there is one; and, last, ``{"ok": true, "device": {...}}``.
Any failed check, build or launch ends the run with a non-zero exit and no
result line.  It refuses to run without CUDA, and outside a checkout.
Timing: CUDA events around repeated launches after a warm-up; whole-path
wall times end in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its bytes over the memory rate and its operations
# over the peak rate for its input type.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"f32": 67e12, "bf16": 989e12}
TOL = {"f32": 2e-5, "bf16": 3e-2}
TOL_LONG_SUM = 1e-4   # f32 gain sums over more than 16k eval rows

REPLACES = {
    "pairwise": "src/repro/kernels/pairwise.py:33",
    "facility_select": "src/repro/kernels/select_top1.py:105",
    "facility_gain": "src/repro/kernels/facility_gain.py:55",
}
SOURCES = {
    "pairwise": "src/repro_torch/kernels/csrc/pairwise.cu",
    "facility_select": "src/repro_torch/kernels/csrc/facility.cu",
    "facility_gain": "src/repro_torch/kernels/csrc/facility.cu",
}


@dataclasses.dataclass(frozen=True)
class Sizes:
  n: int = 262144        # full-size ground set
  d: int = 64
  k: int = 64            # k_final = kappa
  m: int = 16            # stacked logical shards / partitions
  n_cli: int = 65536     # the CLI's default size
  m_cli: int = 8
  plain_chunk: int = 4   # partitions per plain-version call at full size


class SmokeFailure(Exception):
  pass


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
  print(f"[smoke] {phase} " + json.dumps(fields, sort_keys=False),
        flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def sync():
  import torch
  torch.cuda.synchronize()


def time_ms(fn, reps: int = 3) -> float:
  """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
  import torch
  fn()
  sync()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  sync()
  return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, flops: float, dtype: str):
  t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
  t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def errors(got, want):
  """(max abs error, max error relative to the largest |want|)."""
  diff = float((got.float() - want.float()).abs().max())
  scale = float(want.float().abs().max())
  return diff, diff / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phase 1: every kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------


def unit_rows(g, *shape, dtype=None):
  import torch
  x = torch.randn(*shape, generator=g, device=DEVICE)
  x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
  return x if dtype is None else x.to(dtype)


def pairwise_phase(label, x, y, kernel, dtype, chunk, launches):
  """Kernel vs plain on (B, nx, d) x (ny, d) or (B, ny, d); the plain
  version runs ``chunk`` batch entries at a time where the full block
  would not fit beside the kernel's output.  ``launches`` is the kernel's
  count on the full-size main path, reported beside the phase."""
  import torch

  from repro_torch.kernels import ops, ref
  out = ops.pairwise(x, y, kernel=kernel)
  sync()
  b = x.shape[0]
  y_at = (lambda s: y) if y.dim() == 2 else (lambda s: y[s])
  worst_abs = worst_rel = 0.0
  for c0 in range(0, b, chunk):
    s = slice(c0, c0 + chunk)
    want = ref.pairwise_ref(x[s], y_at(s), kernel=kernel)
    ea, er = errors(out[s], want)
    worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
    del want
  del out
  tol = TOL[dtype]
  check(worst_rel <= tol, f"pairwise {label} {kernel} {dtype}: relative "
        f"error {worst_rel:.3e} > {tol:.0e}")
  k_ms = time_ms(lambda: ops.pairwise(x, y, kernel=kernel))

  def plain():
    for c0 in range(0, b, chunk):
      s = slice(c0, c0 + chunk)
      ref.pairwise_ref(x[s], y_at(s), kernel=kernel)

  p_ms = time_ms(plain, reps=1)
  lib_ms = None
  if kernel == "linear" and dtype == "f32":  # bf16 matmul returns bf16
    lib_ms = time_ms(lambda: torch.matmul(x, y.mT))
  nx, d = x.shape[1:]
  ny = y.shape[-2]
  esz = x.element_size()
  moved = (x.numel() + y.numel()) * esz + b * nx * ny * 4
  flops = 2.0 * b * nx * ny * d
  if kernel == "rbf":  # norms, then x2 - 2 dot + y2, clamp, divide, exp
    flops += 2.0 * (b * nx + y.shape[0] * ny) * d + 6.0 * b * nx * ny
  bms, by = bound_ms(moved, flops, dtype)
  row = dict(shape=[b, nx, ny, d], kernel=kernel, dtype=dtype,
             max_abs_err=worst_abs, max_rel_err=worst_rel, tol=tol,
             kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
             bound_ms=bms, bound_by=by, launches=launches)
  emit(f"kernel pairwise {label}", **row)
  return row


def fl_state(g, n_part, ne, nc, d, dtype):
  """A greedy-like facility state: eval rows, candidates, a cov between 0
  and the similarity scale, a mask with some dead rows, ok with some
  selected candidates."""
  import torch
  lead = (n_part,)
  ev = unit_rows(g, *lead, ne, d, dtype=dtype)
  cd = unit_rows(g, *lead, nc, d, dtype=dtype)
  cov = 0.1 * torch.rand(*lead, ne, generator=g, device=DEVICE)
  mask = (torch.rand(*lead, ne, generator=g, device=DEVICE) > 0.05).float()
  ok = torch.rand(*lead, nc, generator=g, device=DEVICE) > 0.02
  return ev, cd, cov, mask, ok


def facility_phase(label, ev, cd, cov, mask, ok, kernel, dtype, chunk,
                   counts):
  """facility_gain and facility_select vs the plain version; the plain
  side runs ``chunk`` partitions at a time.  ``counts`` are the kernels'
  launches on the full-size main path."""
  from repro_torch.kernels import ops, ref
  gains = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
  best, idx = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
  sync()
  n_part, nc = gains.shape
  ne = cov.shape[-1]

  def plain_chunks():
    for c0 in range(0, n_part, chunk):
      s = slice(c0, c0 + chunk)
      yield s, ref.facility_gain_ref(ev[s], cd[s], cov[s], mask[s],
                                     kernel=kernel)

  tol = TOL[dtype] if ne <= 16384 or dtype != "f32" else TOL_LONG_SUM
  g_abs = g_rel = b_abs = b_rel = 0.0
  idx_equal = near_ties = 0
  for s, want in plain_chunks():
    ea, er = errors(gains[s], want)
    g_abs, g_rel = max(g_abs, ea), max(g_rel, er)
    wb, wi = ref.masked_top1(want, ok[s])
    same = idx[s] == wi
    idx_equal += int(same.sum())
    # a different index is a near-tie only if its plain gain is within the
    # tolerance of the plain best
    picked = want.gather(1, idx[s].unsqueeze(1)).squeeze(1)
    gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
    tie = (~same) & (gap <= tol) & ok[s].gather(1, idx[s].unsqueeze(1))[:, 0]
    near_ties += int(tie.sum())
    check(bool((same | tie).all()), f"facility_select {label} {kernel} "
          f"{dtype}: index differs beyond a near-tie")
    ea, er = errors(best[s], wb)
    b_abs, b_rel = max(b_abs, ea), max(b_rel, er)
    check(er <= tol, f"facility_select {label}: best error {er:.3e}")
  check(g_rel <= tol, f"facility_gain {label} {kernel} {dtype}: relative "
        f"error {g_rel:.3e} > {tol:.0e}")
  gain_ms = time_ms(lambda: ops.facility_gain(ev, cd, cov, mask,
                                              kernel=kernel))
  sel_ms = time_ms(lambda: ops.facility_select(ev, cd, cov, mask, ok,
                                               kernel=kernel))

  def plain_gain():
    for _ in plain_chunks():
      pass

  def plain_select():
    for s, want in plain_chunks():
      ref.masked_top1(want, ok[s])

  pg_ms = time_ms(plain_gain, reps=1)
  ps_ms = time_ms(plain_select, reps=1)
  d = cd.shape[-1]
  esz = cd.element_size()
  read = (ev.numel() + cd.numel()) * esz + (cov.numel() + mask.numel()) * 4
  flops = (2.0 * d + 3.0) * n_part * ne * nc
  if kernel == "rbf":
    flops += 6.0 * n_part * ne * nc + 2.0 * n_part * (ne + nc) * d
  peak = dtype
  g_bound = bound_ms(read + n_part * nc * 4, flops, peak)
  s_bound = bound_ms(read + ok.numel() + n_part * 8, flops, peak)
  from repro_torch.kernels import build
  from repro_torch.kernels.facility_gain import eval_chunks
  chunks = eval_chunks(-(-nc // build.TILE) * n_part, ne, ev.device)
  common = dict(shape=[n_part, ne, nc, d], kernel=kernel, dtype=dtype,
                tol=tol, eval_chunks=chunks)
  g_row = dict(common, max_abs_err=g_abs, max_rel_err=g_rel,
               kernel_ms=gain_ms, plain_ms=pg_ms, library_ms=None,
               bound_ms=g_bound[0], bound_by=g_bound[1],
               launches=counts["facility_gain"])
  s_row = dict(common, max_abs_err=b_abs, max_rel_err=b_rel,
               idx_equal=idx_equal, idx_total=n_part, near_ties=near_ties,
               kernel_ms=sel_ms, plain_ms=ps_ms, library_ms=None,
               bound_ms=s_bound[0], bound_by=s_bound[1],
               launches=counts["facility_select"])
  emit(f"kernel facility_gain {label}", **g_row)
  emit(f"kernel facility_select {label}", **s_row)
  return g_row, s_row


def edge_phase():
  """Ragged sizes, an all-infeasible ok, and exact ties from duplicated
  candidate rows, on the card."""
  import torch

  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(11)
  for kernel in ("linear", "rbf"):
    ev, cd, cov, mask, ok = fl_state(g, 3, 1000, 1037, 40, None)
    gains = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
    best, idx = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
    want = ref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel)
    wb, wi = ref.masked_top1(want, ok)
    sync()
    _, er = errors(gains, want)
    check(er <= TOL["f32"] and torch.equal(idx, wi),
          f"ragged {kernel}: err {er:.3e}, idx {idx.tolist()} vs "
          f"{wi.tolist()}")
    s = ops.pairwise(ev, cd[0], kernel=kernel)
    _, es = errors(s, ref.pairwise_ref(ev, cd[0], kernel=kernel))
    check(es <= TOL["f32"], f"ragged pairwise {kernel}: err {es:.3e}")
    none = torch.zeros_like(ok)
    best, idx = ops.facility_select(ev, cd, cov, mask, none, kernel=kernel)
    sync()
    check(bool((best == ref.NEG).all()) and bool((idx == 0).all()),
          f"all-infeasible {kernel}: {best.tolist()} {idx.tolist()}")
    # exact ties: +-10 sign rows make every similarity and gain exact
    signs = torch.where(torch.rand(2, 300, 8, generator=g, device=DEVICE)
                        > 0.5, 10.0, -10.0)
    e_t = signs[:, torch.randint(0, 300, (700,), generator=g,
                                 device=DEVICE)]
    cand = signs.clone()
    want = ref.facility_gain_ref(e_t, cand, torch.zeros(2, 700,
                                                        device=DEVICE),
                                 torch.ones(2, 700, device=DEVICE),
                                 kernel=kernel)
    top = want.argmax(dim=1)
    for p in range(2):  # the best row again at a higher and a lower index
      j = int(top[p])
      cand[p, (j + 211) % 300] = cand[p, j]
      cand[p, (j + 97) % 300] = cand[p, j]
    zeros = torch.zeros(2, 700, device=DEVICE)
    ones = torch.ones(2, 700, device=DEVICE)
    allok = torch.ones(2, 300, dtype=torch.bool, device=DEVICE)
    best, idx = ops.facility_select(e_t, cand, zeros, ones, allok,
                                    kernel=kernel)
    want = ref.facility_gain_ref(e_t, cand, zeros, ones, kernel=kernel)
    wb, wi = ref.masked_top1(want, allok)
    sync()
    check(torch.equal(idx, wi) and torch.equal(best, wb),
          f"ties {kernel}: {idx.tolist()} vs {wi.tolist()}")
  emit("kernel edges", ragged=[3, 1000, 1037, 40], all_infeasible="(NEG, 0)",
       ties="lowest index", result="pass")


def kernel_phases(sz: Sizes, counts: dict):
  import torch
  g = torch.Generator(device=DEVICE).manual_seed(0)
  nl = sz.n // sz.m
  rows = {}
  for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    local = unit_rows(g, sz.m, nl, sz.d, dtype=td)
    merged = unit_rows(g, sz.m * sz.k, sz.d, dtype=td)
    for kernel in ("linear", "rbf"):
      r = pairwise_phase("s11", local, local, kernel, dtype, sz.plain_chunk,
                         counts["pairwise"])
      rows[("pairwise", "s11", kernel, dtype)] = r
      torch.cuda.empty_cache()
      r = pairwise_phase("s2", local, merged, kernel, dtype, sz.m,
                         counts["pairwise"])
      rows[("pairwise", "s2", kernel, dtype)] = r
    del local, merged
    torch.cuda.empty_cache()
  for kernel in ("linear", "rbf"):
    for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      if kernel == "rbf" and dtype == "bf16":
        continue
      st = fl_state(g, sz.m, nl, nl, sz.d, td)
      gr, sr = facility_phase("round1", *st, kernel, dtype, sz.plain_chunk,
                              counts)
      rows[("facility_gain", "round1", kernel, dtype)] = gr
      rows[("facility_select", "round1", kernel, dtype)] = sr
      del st
    st = fl_state(g, 1, sz.n, sz.m * sz.k, sz.d, torch.float32)
    gr, sr = facility_phase("round2", *st, kernel, "f32", 1, counts)
    rows[("facility_gain", "round2", kernel, "f32")] = gr
    rows[("facility_select", "round2", kernel, "f32")] = sr
    del st
    torch.cuda.empty_cache()
  return rows


# ---------------------------------------------------------------------------
# phase 2: the coreset path end to end
# ---------------------------------------------------------------------------


def value_of(feats, sel):
  """f(S) of a selection under the full-set facility objective."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  obj = O.FacilityLocation()
  sf = feats[torch.as_tensor(sel, device=feats.device)]
  st = GD.set_value_feats(obj, obj.init(feats), sf,
                          torch.ones(sf.shape[:1], dtype=torch.bool,
                                     device=feats.device))
  return float(obj.value(st))


def agree(feats, a, b, what):
  """Equal selections, or the near-tie rule: at the first position where
  they differ both picks' marginal gains (after the common prefix, under
  the full-set objective) agree within the f32 tolerance, and the two f(S)
  agree within 1e-5 relative."""
  import numpy as np
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  if np.array_equal(a, b):
    return "equal"
  t = int(np.flatnonzero(a[:min(len(a), len(b))] !=
                         b[:min(len(a), len(b))])[0])
  obj = O.FacilityLocation()
  prefix = feats[torch.as_tensor(a[:t], device=feats.device)]
  st = GD.set_value_feats(obj, obj.init(feats), prefix,
                          torch.ones((t,), dtype=torch.bool,
                                     device=feats.device))
  pair = feats[torch.as_tensor([a[t], b[t]], device=feats.device)]
  g = obj.gains(st, pair)
  gap = float((g[0] - g[1]).abs() / g.abs().max())
  va, vb = value_of(feats, a), value_of(feats, b)
  rel = abs(va - vb) / max(abs(va), 1e-30)
  check(gap <= TOL_LONG_SUM and rel <= 1e-5,
        f"{what}: selections differ at step {t} (gain gap {gap:.3e}, "
        f"f(S) {va!r} vs {vb!r})")
  return f"near-tie at step {t} (gain gap {gap:.2e}, f rel {rel:.2e})"


def e2e_cli_size(sz: Sizes):
  """(a) the CLI's default size: reference and stacked fast path, each with
  backend "auto" (the kernels) and "ref" (the plain versions on the card),
  all four selections agreeing; the coverage ratio."""
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (coverage_ratio,
                                          greedi_select_indices,
                                          greedi_select_indices_sharded)
  feats = EmbeddedCorpus(n_docs=sz.n_cli, feat_dim=sz.d, seed=0).features()
  sels, walls, peaks = {}, {}, {}
  for path in ("reference", "fast"):
    for backend in ("auto", "ref"):
      rng = torch.Generator().manual_seed(0)
      torch.cuda.empty_cache()
      torch.cuda.reset_peak_memory_stats()
      sync()
      t0 = time.perf_counter()
      if path == "reference":
        sel = greedi_select_indices(rng, feats, m=sz.m_cli, kappa=sz.k,
                                    k_final=sz.k, backend=backend)
      else:
        sel = greedi_select_indices_sharded(rng, feats, m=sz.m_cli,
                                            kappa=sz.k, k_final=sz.k,
                                            backend=backend)
      sync()
      walls[(path, backend)] = time.perf_counter() - t0
      peaks[(path, backend)] = torch.cuda.max_memory_allocated() / 2**30
      check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k and
            sel.min() >= 0 and sel.max() < sz.n_cli,
            f"{path}/{backend}: not k unique in-range ids")
      sels[(path, backend)] = sel
  verdicts = {
      "reference auto vs ref": agree(feats, sels[("reference", "auto")],
                                     sels[("reference", "ref")], "ref a/r"),
      "fast auto vs ref": agree(feats, sels[("fast", "auto")],
                                sels[("fast", "ref")], "fast a/r"),
      "reference vs fast": agree(feats, sels[("reference", "auto")],
                                 sels[("fast", "auto")], "ref/fast"),
  }
  sync()
  t0 = time.perf_counter()
  cov = coverage_ratio(feats, sels[("fast", "auto")], sz.k)
  sync()
  t_cov = time.perf_counter() - t0
  check(0.5 < cov <= 1.0 + 1e-6, f"coverage ratio {cov} out of range")
  emit("e2e cli-size", n=sz.n_cli, d=sz.d, k=sz.k, m=sz.m_cli,
       wall_s={f"{p}/{b}": w for (p, b), w in walls.items()},
       peak_gib={f"{p}/{b}": v for (p, b), v in peaks.items()},
       agreement=verdicts, coverage=cov, coverage_wall_s=t_cov)


def e2e_full(sz: Sizes):
  """(b) the main path at full size, launch counts read around it: the
  reference protocol (fused select step, and the two-pass gains step) and
  the stacked fast engine through the CLI.  Returns the launch counts."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.kernels import ops
  from repro_torch.launch import select as cli
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  sync()
  torch.cuda.empty_cache()
  out = {}
  ops.reset_launch_counts()
  for name, use_select in (("reference", True), ("reference_two_pass",
                                                 False)):
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    sel = greedi_select_indices(torch.Generator().manual_seed(0), feats,
                                m=sz.m, kappa=sz.k, k_final=sz.k,
                                use_select=use_select)
    sync()
    out[name] = dict(sel=sel, wall_s=time.perf_counter() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  torch.cuda.reset_peak_memory_stats()
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    path = os.path.join(tmp, "sel.npy")
    sync()
    t0 = time.perf_counter()
    cli.main(["--n", str(sz.n), "--d", str(sz.d), "--k", str(sz.k),
              "--mesh", str(sz.m), "--no-coverage", "--out", path])
    sync()
    out["fast"] = dict(sel=np.load(path), wall_s=time.perf_counter() - t0,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  counts = ops.launch_counts()
  for name, r in out.items():
    sel = r["sel"]
    check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k and
          sel.min() >= 0 and sel.max() < sz.n, f"{name}: bad selection")
  for name, c in counts.items():
    check(c > 0, f"kernel {name} was not launched on the main path")
  value = value_of(feats, out["fast"]["sel"])
  check(0.0 < value < float("inf"), f"f(coreset) = {value!r}")
  verdicts = {
      "select vs two-pass": agree(feats, out["reference"]["sel"],
                                  out["reference_two_pass"]["sel"],
                                  "select/two-pass"),
      "reference vs fast": agree(feats, out["reference"]["sel"],
                                 out["fast"]["sel"], "ref/fast full"),
  }
  emit("e2e full-size", n=sz.n, d=sz.d, k=sz.k, m=sz.m,
       s11_gib=sz.m * (sz.n // sz.m) ** 2 * 4 / 2**30,
       wall_s={k: v["wall_s"] for k, v in out.items()},
       peak_gib={k: v["peak_gib"] for k, v in out.items()},
       launches=counts, agreement=verdicts, value=value)
  return counts


def profile_phase(sz: Sizes):
  """Where the full-size time goes: each path once under torch.profiler
  (CPU and CUDA activity); device time by kernel name, summed over the
  run, and the device busy share (kernel time over the profiled wall
  time, which the profiler itself lengthens, so the share is a lower
  bound).  Runs after the main path's launch counts were read."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (greedi_select_indices,
                                          greedi_select_indices_sharded)
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  paths = {
      "reference": lambda: greedi_select_indices(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k),
      "fast": lambda: greedi_select_indices_sharded(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k),
  }
  for name, run in paths.items():
    torch.cuda.empty_cache()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      run()
      sync()
      wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    emit(f"profile {name}", wall_s=wall,
         device_ms=busy_ms if kern else "not measured",
         busy_share=busy_ms / 1e3 / wall if kern else "not measured",
         top=[dict(kernel=e.key[:70], calls=e.count,
                   ms=e.self_device_time_total / 1e3) for e in top])


# ---------------------------------------------------------------------------


def gpu_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
  return out.stdout.strip().splitlines()[0]


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available; this check runs only on a GPU",
          file=sys.stderr)
    return 2
  if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
    print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
          "the root of a checkout", file=sys.stderr)
    return 2
  sys.path.insert(0, str(SRC))
  from repro_torch import no_tf32
  from repro_torch.kernels import build
  no_tf32()
  sz = Sizes()
  gpu = gpu_line()
  print(gpu, flush=True)
  emit("setup", torch=torch.__version__, cuda=torch.version.cuda,
       device=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), python=sys.version.split()[0])
  t0 = time.perf_counter()
  build.build()
  emit("build", seconds=time.perf_counter() - t0,
       nvcc_seconds=build.build_seconds)
  for line in build.ptxas_report().splitlines():
    print(f"[smoke] ptxas {line}", flush=True)

  edge_phase()
  e2e_cli_size(sz)
  torch.cuda.empty_cache()
  counts = e2e_full(sz)
  torch.cuda.empty_cache()
  rows = kernel_phases(sz, counts)
  torch.cuda.empty_cache()
  profile_phase(sz)

  main_shape = {"pairwise": ("pairwise", "s11", "linear", "f32"),
                "facility_select": ("facility_select", "round1", "linear",
                                    "f32"),
                "facility_gain": ("facility_gain", "round1", "linear",
                                  "f32")}
  kernels = []
  for name, key in main_shape.items():
    r = rows[key]
    kernels.append(dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=counts[name],
        max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=r["shape"]))
  print(gpu, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  try:
    code = main()
  except SmokeFailure as e:
    print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
    code = 1
  sys.exit(code)
