"""One-off timings of the pairwise and facility kernels on the card, kept
out of the smoke: builds variants of ``csrc/pairwise.cu`` (and the
``csrc/facility.cu`` of another checkout) with ``nvcc`` and times them with
CUDA events beside the kernels as shipped.

  python -m repro_torch.kernels.diagnose split
      the kernel at s11 (16 x 16384 x 16384, d 64, linear, f32) beside two
      variants built from the same source: one whose TMA stores never run
      (the tile still goes through the staging buffer), one that keeps every
      shared-memory load but does a quarter of the FFMAs.  Their differences
      split the time into the global stores, the FFMAs and the rest.
  python -m repro_torch.kernels.diagnose widths --parent DIR
      the kernel beside the one of another checkout at DIR (its
      ``src/repro_torch/kernels/csrc``, same C entry) at the s11 shape for
      several widths d, both load paths, with ``torch.matmul`` beside them;
      order parent, this, this, parent; the f32 outputs compared with
      ``torch.equal``.
  python -m repro_torch.kernels.diagnose facility --parent DIR
      the facility / coverage kernels beside those of another checkout at
      DIR (its ``csrc/facility.cu``, same C entries, its own eval-chunk
      plan) at GreeDi's full-size shapes (f32, linear, d 64): the round-1
      selects (16 x 16384 x 16384), the round-2 selects and gains (262144
      eval rows against 1024 candidates) and the lazy rescans
      (16 x 16384 x 256);
      order parent, this, this, parent; the selections compared, the gains
      within 1e-4 of the parent's relative to their largest magnitude.

Prints one JSON line per reading, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build, pairwise
from repro_torch.kernels import facility_gain as fg

M, NL = 16, 16384  # s11: 16 shards of 16384 rows


def _library(name: str, src_dir: Path, source: str = "pairwise.cu",
             edits: dict[str, str] | None = None) -> ctypes.CDLL:
  """``src_dir/source`` with the headers of ``src_dir`` (any file named in
  ``edits`` replaced by its text there), built into
  build/kernels/diagnose/<name>."""
  out = build.BUILD_ROOT / "diagnose" / name
  out.mkdir(parents=True, exist_ok=True)
  edits = edits or {}
  for f in [*src_dir.glob("*.cuh"), src_dir / source]:
    (out / f.name).write_text(edits.get(f.name, f.read_text()))
  lib = out / f"{Path(source).stem}.so"
  proc = subprocess.run(
      [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / source)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
      check=False)
  if proc.returncode != 0:
    raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}")
  return ctypes.CDLL(str(lib))


def _entry(lib: ctypes.CDLL, name: str):
  fn = getattr(lib, name)
  fn.argtypes = build.ENTRIES[name][1]
  fn.restype = ctypes.c_int
  return fn


def _compile(name: str, src_dir: Path, edits: dict[str, str] | None = None):
  """sm90_pairwise of ``src_dir/pairwise.cu`` (with ``edits``)."""
  return _entry(_library(name, src_dir, "pairwise.cu", edits),
                "sm90_pairwise")


def _launcher(fn, x, out):
  b, n, d = x.shape

  def run():
    err = fn(x.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, n, d, n * d,
             n * d, 0, 0, 1.0, build.stream_of(x))
    if err != 0:
      raise RuntimeError(f"pairwise launch error {err}")
  return run


def time_ms(fn, reps: int = 3) -> float:
  """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
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


def _rows(d: int, n: int = NL) -> torch.Tensor:
  g = torch.Generator(device="cuda").manual_seed(0)
  x = torch.randn(M, n, d, generator=g, device="cuda")
  return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def split() -> None:
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
  fns = {k: _compile(k, build.CSRC, v) for k, v in variants.items()}
  x = _rows(64)
  out = torch.empty((M, NL, NL), device="cuda")
  ms = {"full": time_ms(lambda: pairwise.pairwise(x, x, kernel="linear"))}
  for k, fn in fns.items():
    ms[k] = time_ms(_launcher(fn, x, out))
  ms["full_again"] = time_ms(lambda: pairwise.pairwise(x, x, kernel="linear"))
  print(json.dumps({"split": [M, NL, NL, 64], "ms": ms,
                    "stores_ms": ms["full"] - ms["no_stores"],
                    "ffma_three_quarters_ms": ms["full"] - ms["quarter_ffma"]}),
        flush=True)


def widths(parent: Path, ds: list[int]) -> None:
  # each checkout's pairwise.cu with its own headers (ring.cuh holds this
  # one's FFMA loop and TMA helpers)
  old = _compile("parent", parent / "src/repro_torch/kernels/csrc")
  new = _compile("this", build.CSRC)
  for d in ds:
    x = _rows(d)
    a = torch.empty((M, NL, NL), device="cuda")
    b = torch.empty((M, NL, NL), device="cuda")
    run_old, run_new = _launcher(old, x, a), _launcher(new, x, b)
    t_old = [time_ms(run_old)]
    t_new = [time_ms(run_new), time_ms(run_new)]
    t_old.append(time_ms(run_old))
    same = bool(torch.equal(a, b))
    del b
    lib = time_ms(lambda: torch.matmul(x, x.transpose(1, 2), out=a))
    print(json.dumps({"shape": [M, NL, NL, d], "kernel": "linear",
                      "dtype": "f32", "tma": pairwise.takes_tma(x, x),
                      "parent_ms": t_old, "ms": t_new, "library_ms": lib,
                      "ffma_bound_ms": 2 * M * NL * NL * d / 67e12 * 1e3,
                      "equal_to_parent": same}), flush=True)
    del a, x
    torch.cuda.empty_cache()


# GreeDi's full-size facility / coverage calls (n = 262144, m = 16, d 64):
# (label, C entry, partitions (None: unbatched), eval rows, candidates)
FACILITY_SHAPES = (
    ("round1", "facility_select", 16, 16384, 16384),
    ("round1", "coverage_select", 16, 16384, 16384),
    ("round2", "facility_select", 1, 262144, 1024),
    ("round2", "facility_gain", 1, 262144, 1024),
    ("round2", "coverage_select", None, 262144, 1024),
    ("lazy rescan", "facility_gain", 16, 16384, 256),
    ("lazy rescan", "coverage_gain", 16, 16384, 256),
)


def _first_port_chunks(n_part: int, ne: int, nc: int, n_sm: int) -> int:
  """The eval-chunk count the first port's wrapper gave its kernel: about
  four 128-candidate blocks an SM, at most one chunk per eval tile."""
  blocks = -(-nc // build.TILE) * n_part
  if blocks >= 4 * n_sm:
    return 1
  return max(1, min(-(-4 * n_sm // blocks), -(-ne // build.TILE)))


def facility(parent: Path | None, d: int = 64) -> None:
  libs = {"this": _library("facility_this", build.CSRC, "facility.cu")}
  if parent is not None:
    libs["parent"] = _library(
        "facility_parent", parent / "src/repro_torch/kernels/csrc",
        "facility.cu")
  takes_tma = _entry(libs["this"], "sm90_facility_tma")
  band_of = _entry(libs["this"], "sm90_facility_band")
  dev = torch.device("cuda")
  n_sm = fg.sm_count(dev)
  g = torch.Generator(device=dev).manual_seed(0)
  for label, call, P, ne, nc in FACILITY_SHAPES:
    coverage, select = call.startswith("coverage"), call.endswith("select")
    lead = () if P is None else (P,)
    n_part = 1 if P is None else P

    def rand(*shape):
      return torch.rand(*shape, generator=g, device=dev)
    ev = torch.nn.functional.normalize(
        torch.randn(*lead, ne, d, generator=g, device=dev), dim=-1)
    cd = torch.nn.functional.normalize(
        torch.randn(*lead, nc, d, generator=g, device=dev), dim=-1)
    cap = None
    if coverage:  # as chip_smoke.py's cov_state: some rows saturated
      ev, cd = ev.abs(), cd.abs()
      cap = 0.25 * 0.64 * ne * (0.8 + 0.4 * rand(*lead, ne))
      cov = cap * 1.2 * rand(*lead, ne)
    else:
      cov = 0.1 * rand(*lead, ne)
    mask = (rand(*lead, ne) > 0.05).float()
    ok = (rand(*lead, nc) > 0.02).float()
    vs = ne if P is not None else 0  # batch strides of the vectors
    tma = bool(takes_tma(ev.data_ptr(), cd.data_ptr(), cov.data_ptr(),
                         build.ptr(cap), mask.data_ptr(), n_part, ne, nc, d,
                         vs, vs if coverage else 0, vs, 0))
    chunks = {"this": fg.plan(n_part, ne, nc, band_of(int(tma)), n_sm,
                              1 if tma else 2).chunks,
              "parent": _first_port_chunks(n_part, ne, nc, n_sm)}
    tiles = -(-nc // build.TILE) * n_part
    part = torch.empty(max(chunks.values()) * n_part * nc, device=dev)
    tile_best = torch.empty(tiles, device=dev)
    tile_idx = torch.empty(tiles, dtype=torch.int32, device=dev)
    best = torch.empty(n_part, device=dev)
    idx = torch.empty(n_part, dtype=torch.int32, device=dev)
    gains = torch.empty(n_part, nc, device=dev)
    strides = (ev[0].numel() if P else 0, cd[0].numel() if P else 0)
    vecs = ((cov, cap) if coverage else (cov,)) + (mask,)
    bss = (vs, vs, vs) if coverage else (vs, vs)

    def runner(who):
      fn = _entry(libs[who], "sm90_" + call)
      ptrs = [ev.data_ptr(), cd.data_ptr(), *(v.data_ptr() for v in vecs)]
      if select:
        ptrs += [ok.data_ptr(), part.data_ptr(), tile_best.data_ptr(),
                 tile_idx.data_ptr(), best.data_ptr(), idx.data_ptr()]
      else:
        ptrs += [part.data_ptr(), gains.data_ptr()]
      args = (*ptrs, n_part, ne, nc, d, *strides, *bss,
              *((vs,) if select else ()), chunks[who], 0, 0, 1.0,
              build.stream_of(ev))

      def run():
        err = fn(*args)
        if err != 0:
          raise RuntimeError(f"{who} {call}: launch error {err}")
      return run

    def output():
      torch.cuda.synchronize()
      return ((best.clone(), idx.clone()) if select else gains.clone())

    order = (["parent"] if parent else []) + ["this", "this"] + (
        ["parent"] if parent else [])
    ms = {"this": [], "parent": []}
    outs = {"this": [], "parent": []}
    for who in order:
      ms[who].append(time_ms(runner(who)))
      outs[who].append(output())
    row = {"shape": [P, ne, nc, d], "call": call, "label": label,
           "kernel": "linear", "dtype": "f32",
           "path": "persistent" if tma else "tile", "chunks": chunks,
           "parent_ms": ms["parent"], "ms": ms["this"],
           "ffma_bound_ms": (2 * d + (5 if coverage else 3)) * n_part * ne *
                            nc / 67e12 * 1e3}
    a, b = outs["this"][0], outs["this"][1]
    row["repeat_identical"] = (torch.equal(a[0], b[0]) and
                               torch.equal(a[1], b[1])) if select else (
                                   torch.equal(a, b))
    if parent:
      p0 = outs["parent"][0]
      if select:
        row["idx_equal_to_parent"] = int((a[1] == p0[1]).sum())
        row["best_max_rel_diff"] = float(
            ((a[0] - p0[0]).abs() / p0[0].abs().clamp_min(1e-30)).max())
      else:
        row["gains_max_rel_diff"] = float(
            (a - p0).abs().max() / p0.abs().max().clamp_min(1e-30))
    print(json.dumps(row), flush=True)
    del ev, cd, cov, cap, mask, ok, part, gains
    torch.cuda.empty_cache()


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  sub = ap.add_subparsers(dest="cmd", required=True)
  sub.add_parser("split")
  w = sub.add_parser("widths")
  w.add_argument("--parent", type=Path, required=True)
  w.add_argument("--d", type=int, nargs="+", default=[22, 64, 128])
  f = sub.add_parser("facility")
  f.add_argument("--parent", type=Path, default=None)
  args = ap.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=False).stdout.strip(), flush=True)
  if args.cmd == "split":
    split()
  elif args.cmd == "widths":
    widths(args.parent, args.d)
  else:
    facility(args.parent)


if __name__ == "__main__":
  main()
