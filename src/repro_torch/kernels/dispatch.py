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


# ---------------------------------------------------------------------------
# Entry points the hazard analyzer runs (repro_torch.analysis)
# ---------------------------------------------------------------------------
#
# Every production surface -- each oracle family above at representative
# shapes, the GreeDi engines, the service's append / epoch / query calls --
# registers a builder here, so ``python -m repro_torch.analysis`` can list
# and run them without knowing their call conventions.  Builders run
# lazily (the operands are made only when the analyzer asks), so
# registration is free at import time.


class TraceSpec(NamedTuple):
  """One call the analyzer runs: ``fn(*args)`` plus its annotations.

  ``args``         concrete tensors (and host values), made from a numpy
                   seed on the device the analyzer asks for;
  ``mask_args``    positions of the gid-validity / mask inputs -- the taint
                   roots of the T3 mask-discipline rule (a position may
                   hold a tensor the call reads through an object, such as
                   a store's resident gid column: the taint follows the
                   storage);
  ``row_sizes``    padded row-axis sizes of the pad-and-mask blocks in play
                   (distinct from feature widths, so a size match really
                   means "a row axis");
  ``sync_budget``  host syncs one call may make (T1): 0 for every oracle and
                   append chunk, 1 a query tile, the measured and explained
                   count for the greedy engines (analysis/entries.py).
  """

  fn: Callable
  args: tuple
  mask_args: tuple[int, ...] = ()
  row_sizes: tuple[int, ...] = ()
  sync_budget: int = 0


class EntryPoint(NamedTuple):
  name: str
  # build(device) -> TraceSpec; build(device, mesh) when needs_ranks > 1
  build: Callable[..., TraceSpec]
  needs_ranks: int = 1  # processes of a ProcessMesh the call runs over
  roots: tuple[str, ...] = ()  # module roots of the code the call runs, for
                               # the analyzer's --diff reachability pruning


_ENTRY_POINTS: dict[str, EntryPoint] = {}


def register_entry_point(name: str, build: Callable[..., TraceSpec], *,
                         needs_ranks: int = 1,
                         roots: tuple[str, ...] | None = None) -> None:
  """Register (or replace) an entry point for the analyzer.

  ``build(device)`` returns the entry's ``TraceSpec`` with its operands on
  ``device``; an entry with ``needs_ranks > 1`` is built on every rank as
  ``build(device, mesh)`` with that rank's ``launch.mesh.ProcessMesh``.
  ``roots`` names the modules whose import closure covers the code the
  entry runs (``repro_torch.analysis.modgraph`` expands it); it defaults
  to the builder's own module, which is correct whenever the builder lives
  next to the code it runs.
  """
  if roots is None:
    roots = (getattr(build, "__module__", "") or "",)
  _ENTRY_POINTS[name] = EntryPoint(name, build, needs_ranks, tuple(roots))


def entry_points() -> tuple[EntryPoint, ...]:
  """All registered entry points (the oracle families register on ops
  import; the protocol and service entries on
  ``repro_torch.analysis.entries`` import)."""
  _ensure_registered()
  return tuple(sorted(_ENTRY_POINTS.values(), key=lambda e: e.name))
