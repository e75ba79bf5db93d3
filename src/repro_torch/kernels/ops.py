"""Public kernel entry points and their registration (the port of
``src/repro/kernels/ops.py``).

The reference's wrappers pad operands to tile multiples (``cov`` with +inf,
``ok`` with 0).  The CUDA kernels mask ragged edges themselves, so these
wrappers pass tensors through as they are.  Each kernel wrapper counts its
launches (``launch_counts``), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import functools

from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import facility_gain as _fg
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import select_top1 as _st

facility_gain = _fg.facility_gain
facility_select = _st.facility_select
pairwise = _pw.pairwise

_COUNTED = {"pairwise": _pw, "facility_gain": _fg, "facility_select": _st}


def launch_counts() -> dict[str, int]:
  """Kernel launches through each wrapper since the last reset."""
  return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
  for mod in _COUNTED.values():
    mod.launches = 0


def _cuda_only(fn):
  """The kernel wrapper, refusing CPU tensors instead of taking the plain
  version (the ``cuda`` backend never falls back)."""

  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    if not args[0].is_cuda:
      raise ValueError(f"{fn.__name__}: backend 'cuda' needs CUDA tensors, "
                       f"got {args[0].device}")
    return fn(*args, **kwargs)

  return wrapped


dispatch.register("facility_gain", cuda=_cuda_only(facility_gain),
                  ref=ref.facility_gain_ref, auto=facility_gain)
dispatch.register("pairwise", cuda=_cuda_only(pairwise),
                  ref=ref.pairwise_ref, auto=pairwise)
dispatch.register_select("facility_gain", cuda=_cuda_only(facility_select),
                         ref=ref.facility_select_ref, auto=facility_select)
