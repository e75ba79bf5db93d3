"""One-off timings of the pairwise kernel on the card, kept out of the
smoke: builds variants of ``csrc/pairwise.cu`` with ``nvcc`` and times them
with CUDA events beside the kernel as shipped.

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

M, NL = 16, 16384  # s11: 16 shards of 16384 rows


def _compile(name: str, src_dir: Path, text: str | None = None):
  """sm90_pairwise of ``src_dir/pairwise.cu`` (or of ``text`` beside the
  headers of ``src_dir``), built into build/kernels/diagnose/<name>."""
  out = build.BUILD_ROOT / "diagnose" / name
  out.mkdir(parents=True, exist_ok=True)
  for f in src_dir.glob("*.cuh"):
    (out / f.name).write_text(f.read_text())
  (out / "pairwise.cu").write_text(
      text if text is not None else (src_dir / "pairwise.cu").read_text())
  proc = subprocess.run(
      [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "pairwise.so"),
       str(out / "pairwise.cu")], stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True, check=False)
  if proc.returncode != 0:
    raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}")
  fn = ctypes.CDLL(str(out / "pairwise.so")).sm90_pairwise
  fn.argtypes = build.ENTRIES["sm90_pairwise"][1]
  fn.restype = ctypes.c_int
  return fn


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
  store = "tma_store3(&omap,"
  fma = ("#pragma unroll\n        for (int j = 0; j < 8; ++j) acc[i][j] = "
         "fmaf(a[e], b[j][e], acc[i][j]);")
  if src.count(store) != 1 or src.count(fma) != 1:
    raise RuntimeError("the variant edits no longer match csrc/pairwise.cu")
  variants = {
      "no_stores": src.replace(store, "if (bx < 0) " + store),
      "quarter_ffma": src.replace(fma, "acc[i][e] = fmaf(a[e], b[e][e] + "
                                       "b[e + 4][e], acc[i][e]);"),
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


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  sub = ap.add_subparsers(dest="cmd", required=True)
  sub.add_parser("split")
  w = sub.add_parser("widths")
  w.add_argument("--parent", type=Path, required=True)
  w.add_argument("--d", type=int, nargs="+", default=[22, 64, 128])
  args = ap.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=False).stdout.strip(), flush=True)
  if args.cmd == "split":
    split()
  else:
    widths(args.parent, args.d)


if __name__ == "__main__":
  main()
