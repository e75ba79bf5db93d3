"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) into ``build/kernels/<hash>/`` at the repository root, where
``<hash>`` covers every source and the compiler flags: a changed source
builds anew, an unchanged one is loaded from the directory.  The libraries
are loaded with ``ctypes``; nothing here includes PyTorch's headers, so a
build takes seconds.  Processes that load at once (the ranks of a
``torch.distributed`` run) take a file lock on the directory: one of them
compiles, the others wait for it and load what it built.

Nothing is compiled when this module is imported: the CPU tests import
every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

TILE = 128         # rows of the eval tile of csrc/facility.cu (fl::TM)
MAX_GRID = 65535   # CUDA's limit on gridDim.y and gridDim.z

P = ctypes.c_void_p
I64 = ctypes.c_int64
F32 = ctypes.c_float

# C entry points: name -> (library, argtypes).  Every entry returns the
# cudaGetLastError() of its launches as an int.
ENTRIES = {
    "sm90_pairwise": ("pairwise",
                      [P, P, P, I64, I64, I64, I64, I64, I64, I64, I64, I64,
                       I64, F32, I64, P]),
    "sm90_pairwise_smem": ("pairwise", [I64, I64]),
    "sm90_sim_mismatches": ("pairwise", [F32, P, I64, P]),
    "sm90_facility_gain": ("facility",
                           [P, P, P, P, P, P, I64, I64, I64, I64, I64, I64,
                            I64, I64, I64, I64, I64, I64, I64, F32, I64, P]),
    "sm90_facility_select": ("facility",
                             [P, P, P, P, P, P, P, P, P, P, I64, I64, I64,
                              I64, I64, I64, I64, I64, I64, I64, I64, I64,
                              I64, I64, F32, I64, P]),
    "sm90_coverage_gain": ("facility",
                           [P, P, P, P, P, P, P, I64, I64, I64, I64, I64,
                            I64, I64, I64, I64, I64, I64, I64, I64, I64, F32,
                            I64, P]),
    "sm90_facility_smem": ("facility", [I64, I64, I64]),
    "sm90_coverage_select": ("facility",
                             [P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64,
                              I64, I64, I64, I64, I64, I64, I64, I64, I64,
                              I64, I64, I64, F32, I64, P]),
    "sm90_info_plan": ("info_gain",
                       [I64, I64, I64, I64, I64, ctypes.POINTER(I64),
                        ctypes.POINTER(I64), ctypes.POINTER(I64)]),
    "sm90_info_gain_cond": ("info_gain",
                            [P, P, P, P, P, P, I64, I64, I64, I64, I64, I64,
                             I64, I64, I64, I64, F32, F32, P]),
    "sm90_info_select": ("info_gain",
                         [P, P, P, P, P, P, P, P, P, P, I64, I64, I64, I64,
                          I64, I64, I64, I64, I64, I64, I64, F32, F32, P]),
    "sm90_graph_cut_gain": ("graph_cut",
                            [P, P, I64, I64, I64, P, I64, I64, I64, P, P,
                             I64, I64, I64, I64, I64, P]),
    "sm90_graph_cut_tiles": ("graph_cut", [I64, I64]),
    "sm90_graph_cut_select": ("graph_cut",
                              [P, P, I64, I64, I64, P, I64, I64, I64, P, I64,
                               I64, P, P, P, P, P, P, I64, I64, I64, I64, I64,
                               P]),
    "sm90_relu_colsum": ("colsum",
                         [P, P, P, P, P, I64, I64, I64, I64, I64, I64, I64,
                          I64, P]),
    "sm90_sieve_scan": ("sieve",
                        [P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64,
                         I64, I64, P]),
    "sm90_flash_attention": ("flash_attention",
                             [P, P, P, P, I64, I64, I64, I64, I64, I64, I64,
                              I64, I64, I64, I64, I64, I64, I64, I64, F32,
                              P]),
    "sm90_flash_attention_tc": ("flash_attention_tc",
                                [P, P, P, P, I64, I64, I64, I64, I64, I64,
                                 I64, I64, I64, I64, I64, I64, I64, I64,
                                 I64, F32, P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
build_seconds: float | None = None  # wall time of this process's compile


def _nvcc() -> str:
  for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
    path = Path(cand) / "bin" / "nvcc"
    if cand and path.exists():
      return str(path)
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels are "
                       "built from csrc/ at first use")
  return found


def _digest() -> str:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in sorted(CSRC.iterdir()):
    h.update(src.name.encode())
    h.update(src.read_bytes())
  return h.hexdigest()[:16]


def build() -> dict[str, Path]:
  """Compile every source that has no library yet; returns name -> .so.

  Raises with the compiler's output when a source does not compile.
  """
  out_dir = BUILD_ROOT / _digest()
  out_dir.mkdir(parents=True, exist_ok=True)
  sources = sorted(CSRC.glob("*.cu"))
  libs = {src.stem: out_dir / f"{src.stem}.so" for src in sources}
  if all(lib.exists() for lib in libs.values()):
    return libs
  with open(out_dir / ".lock", "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
    _compile([src for src in sources if not libs[src.stem].exists()], libs,
             out_dir)
  return libs


def _compile(todo, libs: dict, out_dir: Path) -> None:
  """One ``nvcc`` per source of ``todo``, all started together."""
  global build_seconds
  if not todo:
    return
  t0 = time.perf_counter()
  nvcc = _nvcc()
  procs = []
  for src in todo:
    tmp = out_dir / f"{src.stem}.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    procs.append((src, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  failed = []
  for src, tmp, proc in procs:
    log, _ = proc.communicate()
    (out_dir / f"{src.stem}.log").write_text(log)
    if proc.returncode != 0:
      failed.append(f"{src.name}:\n{log}")
    else:
      os.replace(tmp, libs[src.stem])  # atomic: readers see whole files
  if failed:
    raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
  build_seconds = time.perf_counter() - t0


def ptxas_report(out_dir: Path | None = None) -> str:
  """The compiler's register / shared-memory / spill lines of the last
  build (``-Xptxas -v``; the logs in ``out_dir``, by default this build's
  directory), one line per kernel instantiation, each with the entry it
  belongs to (the mangled name, which spells out the template
  arguments)."""
  out_dir = BUILD_ROOT / _digest() if out_dir is None else out_dir
  lines = []
  for log in sorted(out_dir.glob("*.log")):
    entry, spill = "?", ""
    for line in log.read_text().splitlines():
      if "Compiling entry function" in line:
        entry = line.split("'")[1] if "'" in line else line.strip()
      elif "spill" in line:
        spill = line.strip()
      elif "registers" in line:
        regs = line.split(":", 1)[-1].strip()
        lines.append(f"{log.stem}: {entry}: {regs}; {spill}")
  return "\n".join(lines)


def entry(name: str):
  """The C function ``name``, building and loading its library on first
  use, with its ``argtypes``/``restype`` declared."""
  if name not in _FNS:
    lib_name, argtypes = ENTRIES[name]
    if lib_name not in _LIBS:
      _LIBS[lib_name] = ctypes.CDLL(str(build()[lib_name]))
    fn = getattr(_LIBS[lib_name], name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FNS[name] = fn
  return _FNS[name]


def check(err: int, name: str) -> None:
  """Raise when a C entry reports a CUDA error (a refused launch never runs,
  and a later synchronize would not report it)."""
  if err != 0:
    lib = _LIBS[ENTRIES[name][0]]
    lib.sm90_error_string.argtypes = [ctypes.c_int]
    lib.sm90_error_string.restype = ctypes.c_char_p
    msg = lib.sm90_error_string(err).decode()
    raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")


# ---------------------------------------------------------------------------
# shared wrapper checks
# ---------------------------------------------------------------------------


def check_kernel(name: str, kernel: str) -> None:
  if kernel not in ("linear", "rbf"):
    raise ValueError(f"{name}: kernel {kernel!r} not in ('linear', 'rbf')")


def check_width(name: str, kernel: str, h: float) -> None:
  """The rbf width the pairwise, facility / coverage and info-gain kernels
  take: h * h within [1e-20, 1e20], where their division-free quotient
  (csrc/sm90.cuh) is the IEEE one."""
  if kernel == "rbf" and not 1e-20 <= h * h <= 1e20:
    raise ValueError(f"{name}: rbf width h={h!r} outside the kernel's range "
                     "(h * h within [1e-20, 1e20])")


def check_feats(name: str, *feats, rows_only: bool = False) -> None:
  """Features a kernel takes: CUDA, float32 or bfloat16 (one dtype), 2-D
  (shared by the batch) or 3-D (batched), one device; contiguous, or with
  ``rows_only`` any layout whose rows are (stride 1 along d; the caller
  copies what TMA cannot read, ``ring.features``)."""
  dev = feats[0].device
  for t in feats:
    if t.device.type != "cuda" or t.device != dev:
      raise ValueError(f"{name}: all operands must be on one CUDA device, "
                       f"got {[str(f.device) for f in feats]}")
    if t.dtype not in (torch.float32, torch.bfloat16):
      raise TypeError(f"{name}: features must be float32 or bfloat16, "
                      f"got {t.dtype}")
    if t.dtype != feats[0].dtype:
      raise TypeError(f"{name}: feature dtypes differ: "
                      f"{[f.dtype for f in feats]}")
    rows = t.shape[-1] == 1 or t.stride(-1) == 1
    if t.dim() not in (2, 3) or not (t.is_contiguous() or
                                     (rows_only and rows)):
      raise ValueError(f"{name}: features must be contiguous (n, d) or "
                       f"(B, n, d){' rows' if rows_only else ''}, got shape "
                       f"{tuple(t.shape)} strides {t.stride()}")


def batch_of(name: str, *pairs) -> int | None:
  """The batch size shared by the batched operands, or None when none is
  batched.  ``pairs`` are (tensor, rank of one batch entry)."""
  sizes = {t.shape[0] for t, rank in pairs if t.dim() == rank + 1}
  if len(sizes) > 1:
    raise ValueError(f"{name}: batch sizes differ: {sorted(sizes)}")
  return sizes.pop() if sizes else None


def batch_stride(t, rank: int) -> int:
  """Elements between batch entries: 0 for an operand shared by the batch."""
  return t[0].numel() if t.dim() == rank + 1 else 0


def vec(name: str, t, n: int, device):
  """A per-row vector operand as contiguous float32 on the kernel's device;
  its last axis must have length n."""
  if t.device != device:
    raise ValueError(f"{name}: operand on {t.device}, features on {device}")
  if t.shape[-1] != n:
    raise ValueError(f"{name}: vector of length {t.shape[-1]}, expected {n}")
  return t.to(torch.float32).contiguous()


def ptr(t) -> int | None:
  """A tensor's device address, or NULL for a scratch a launch leaves
  unused."""
  return None if t is None else t.data_ptr()


def stream_of(t) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream
