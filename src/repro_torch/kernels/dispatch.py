"""Kernel-dispatch registry: gain oracles -> backend implementations (the
port of ``src/repro/kernels/dispatch.py``).

Every hot-loop oracle is registered under the reference's stable name with
three implementations:

  * ``cuda`` -- the hand-written kernel; raises for tensors that are not on
    a CUDA device (it never falls back);
  * ``ref``  -- the plain PyTorch version from kernels/ref.py, on whatever
    device the tensors lie.  On CUDA tensors it exists so that the tests and
    ``chip_smoke.py`` can hold the kernels against it;
  * ``auto`` -- the kernel wrapper itself: the kernel for CUDA tensors, the
    plain version for CPU tensors.

Objectives carry a ``backend`` field ("cuda" | "ref" | "auto") and
``resolve``/``resolve_select`` map it to a callable, per call: PyTorch runs
eagerly, so there is no trace-time resolution to cache.  The similarity
kernels the fused oracles implement are listed in ``FUSED_SIMS``; the
objectives fall back to their generic path for anything else (e.g.
``neg_sq_dist``), as the reference does: a ``torch.matmul`` similarity
block in candidate chunks and, for facility location, the ``relu_colsum``
oracle over it (``core/objectives.py``).  The families are

  * gain oracles (``register``/``resolve``): the full (nc,) gains vector
    (``facility_gain``), the information-gain conditional variances
    (``info_gain_cond``), ``pairwise``, the materialized similarity
    blocks the fast GreeDi engine caches, and ``relu_colsum``, that
    engine's masked relu column sums over them;
  * select oracles (``register_select``/``resolve_select``): the fused
    top-1 reductions returning (best gain, index) directly, registered under
    the name of their gain counterpart;
  * query-batched select oracles (``register_select_batched``/
    ``resolve_select_batched``): the reference's ``*_select_batched``, B
    per-query states over one shared corpus-side operand in one launch
    (``facility_gain``, ``coverage_gain``: B covers, masks and oks over
    one feature block, the store's exact query tier; ``info_gain_cond``:
    B selections over one candidate block; ``graph_cut_gain``: B
    selection vectors over one W).

``sieve_update`` is the standing-sieve admission of the selection
service's append (two ``pairwise`` sweeps and the ``csrc/sieve.cu`` scan).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

BACKENDS = ("cuda", "ref", "auto")

# similarity kernels the fused oracles implement in-kernel
FUSED_SIMS = ("linear", "rbf")


class Oracle(NamedTuple):
  name: str
  cuda: Callable
  ref: Callable
  auto: Callable


_REGISTRY: dict[str, Oracle] = {}
_SELECT: dict[str, Oracle] = {}
_SELECT_BATCHED: dict[str, Oracle] = {}


def register(name: str, *, cuda: Callable, ref: Callable,
             auto: Callable) -> None:
  """Register (or replace) a gain oracle's backend implementations."""
  _REGISTRY[name] = Oracle(name, cuda, ref, auto)


def register_select(name: str, *, cuda: Callable, ref: Callable,
                    auto: Callable) -> None:
  """Register (or replace) a fused top-1 select oracle."""
  _SELECT[name] = Oracle(name, cuda, ref, auto)


def register_select_batched(name: str, *, cuda: Callable, ref: Callable,
                            auto: Callable) -> None:
  """Register (or replace) a query-batched fused top-1 select oracle."""
  _SELECT_BATCHED[name] = Oracle(name, cuda, ref, auto)


def _ensure_registered() -> None:
  # ops.py registers its wrappers at import time; import lazily so the
  # registry is populated on first use without an import cycle.
  if not _REGISTRY:
    from repro_torch.kernels import ops  # noqa: F401


def names() -> tuple[str, ...]:
  _ensure_registered()
  return tuple(sorted(_REGISTRY))


def select_names() -> tuple[str, ...]:
  _ensure_registered()
  return tuple(sorted(_SELECT))


def select_batched_names() -> tuple[str, ...]:
  _ensure_registered()
  return tuple(sorted(_SELECT_BATCHED))


def get(name: str) -> Oracle:
  _ensure_registered()
  if name not in _REGISTRY:
    raise KeyError(f"no oracle {name!r}; registered: {sorted(_REGISTRY)}")
  return _REGISTRY[name]


def get_select(name: str) -> Oracle:
  _ensure_registered()
  if name not in _SELECT:
    raise KeyError(f"no select oracle {name!r}; registered: {sorted(_SELECT)}")
  return _SELECT[name]


def get_select_batched(name: str) -> Oracle:
  _ensure_registered()
  if name not in _SELECT_BATCHED:
    raise KeyError(f"no batched select oracle {name!r}; registered: "
                   f"{sorted(_SELECT_BATCHED)}")
  return _SELECT_BATCHED[name]


def _pick(oracle: Oracle, backend: str) -> Callable:
  if backend not in BACKENDS:
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")
  return getattr(oracle, backend)


def resolve(name: str, backend: str = "auto") -> Callable:
  """Map (gain-oracle name, backend) to the implementation to call."""
  return _pick(get(name), backend)


def resolve_select(name: str, backend: str = "auto") -> Callable:
  """Map (select-oracle name, backend) to the implementation to call."""
  return _pick(get_select(name), backend)


def resolve_select_batched(name: str, backend: str = "auto") -> Callable:
  """Map (batched select-oracle name, backend) to the implementation."""
  return _pick(get_select_batched(name), backend)
