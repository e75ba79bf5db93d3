"""Tile sizes the port picks from the shapes (the port of the ``floor_pow2``,
``lazy_tile`` and ``query_tile`` parts of ``src/repro/kernels/autotune.py``).

The reference keys a table on (backend, n, d) for the TPU and the CPU.  The
CUDA kernels here use fixed tiles (the facility kernel: 256-row candidate
bands against 128-row eval tiles, ``build.TILE``), so the only knob left
is the rescore tile of the tile-bound lazy greedy (core/greedy.py): the
number of bound-sorted candidates each shard refreshes per rescan, and the
query tile of the selection service's batched query path.
"""
from __future__ import annotations

from repro_torch.kernels import build

# Rescore tile on the H100: one 256-row candidate band of the facility /
# coverage kernels per shard.  A rescan of P stacked shards is one gains
# launch over P x 256 candidates, which the kernel's eval-axis split spreads
# over the card's SMs however small P is, so the tile trades the number of
# rescans (one launch and one host sync each) against the gains computed
# past the stopping bound: 256 keeps both small at the service's kappa = 64
# over 16k-row shards, and is a multiple of the kernel tile, so no rescan
# computes a ragged tile.
LAZY_TILE = 2 * build.TILE


def floor_pow2(n: int, cap: int = 256, floor: int = 8) -> int:
  """Largest power-of-two block <= cap that keeps padding overhead sane."""
  b = cap
  while b > floor and n < b:
    b //= 2
  return b


def lazy_tile(n: int, d: int) -> int:
  """Rescore-tile size for the tile-bound lazy greedy over n candidates of
  width d (the width does not change the card's choice)."""
  del d
  return floor_pow2(n, cap=LAZY_TILE)


# device type -> query-batch tile of the multi-tenant batched query path
# (service/store.py): the batch width B of one batched sieve merge or exact
# step.  Ragged request batches pad up to it and bigger ones chunk through
# it, so a drained batch of up to B requests reads back once.  The card's
# entry is the reference's default until it is measured.
_QUERY_TILE: dict[str, int] = {"cuda": 64, "cpu": 64}


def query_tile(device: str = "cuda") -> int:
  """Batch width of the batched query path on a device of type ``device``
  ("cuda" or "cpu")."""
  return _QUERY_TILE[str(device).split(":")[0]]
