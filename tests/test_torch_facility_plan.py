"""The facility / coverage wrappers' work plan (``facility_gain.plan``) as a
pure function of (partitions, eval rows, candidates, SM count): the eval
chunks tile the eval axis in order with no empty chunk in either ring mode
(``ring.plan``), the select's scratch follows the 256-row candidate band,
and GreeDi's full-size calls give an H100's 132 SMs work.  CPU only: no
kernel runs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ring  # noqa: E402
from repro_torch.kernels import facility_gain as fg  # noqa: E402
from repro_torch.kernels import select_top1  # noqa: E402

H100_SMS = 132
BAND = 256
# a width of each ring mode: d = 64 keeps the band resident, d = 768
# streams it box by box
WIDTHS = {"resident": 64, "streamed": 768}

# (P, ne, nc) of every facility-family call chip_smoke.py drives at full
# size (n = 262144, m = 16, k = kappa = 64, d = 64): round 1, GreeDi's
# round 2 (reference, service), the lazy rescans, the satcov total pass,
# the centralized greedy at the CLI size and the batched query form
SMOKE_SHAPES = [(16, 16384, 16384), (1, 262144, 1024), (16, 16384, 1024),
                (16, 16384, 256), (1, 262144, 16384), (1, 65536, 65536),
                (64, 8192, 8192)]
EDGE_SHAPES = [(1, 1, 1), (3, 1000, 1037), (1, 20000, 300), (2, 700, 300),
               (1, 129, 70), (7, 385, 5000), (1, 128 * 1000 + 1, 1)]


def _chunk_ranges(p):
  return [range(c * p.per_chunk, min(p.tiles, (c + 1) * p.per_chunk))
          for c in range(p.chunks)]


@pytest.mark.parametrize("n_sm", [8, 114, H100_SMS])
@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("shape", SMOKE_SHAPES + EDGE_SHAPES)
def test_every_eval_tile_in_exactly_one_chunk_in_order(shape, mode, n_sm):
  P, ne, nc = shape
  assert ring.plan("facility", WIDTHS[mode], 4).mode == mode
  p = fg.plan(P, ne, nc, n_sm)
  assert p.band == BAND
  assert p.tiles == -(-ne // build.TILE) and p.bands == -(-nc // BAND)
  ranges = _chunk_ranges(p)
  assert all(len(r) > 0 for r in ranges)  # stage 2 reads every chunk
  assert [t for r in ranges for t in r] == list(range(p.tiles))
  assert p.per_chunk == -(-p.tiles // p.chunks)  # the kernel's own split
  assert p.units == P * p.bands * p.chunks
  assert p == fg.plan(P, ne, nc, n_sm)  # a pure function
  # every SM gets a unit where the shape has enough (band, tile) pairs
  assert p.units >= min(n_sm, P * p.bands * p.tiles)


@pytest.mark.parametrize("bands", [1, 2])
@pytest.mark.parametrize("waves", [1, 3])
def test_no_eval_split_when_the_bands_fill_whole_waves(waves, bands):
  n_sm = 16
  P = waves * n_sm // bands  # the partitions' bands fill whole waves
  p = fg.plan(P, 16384, 200 * bands, n_sm)
  assert p.bands == bands
  assert (p.chunks, p.units) == (1, P * bands)


def _operands(P, ne, nc, mode, n_sm, d=None):
  d = WIDTHS[mode] if d is None else d
  ev = ring.features("t", torch.zeros(P, ne, d))
  cd = ring.features("t", torch.zeros(P, nc, d))
  vec = ring.vector(torch.zeros(P, ne))
  return fg.FLOperands(ev, cd, vec, vec, torch.ones(P, nc), P, P, ne, nc, d,
                       ring.plan("facility", d, 4), fg.plan(P, ne, nc, n_sm))


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("shape", [(16, 16384, 16384), (1, 262144, 1024),
                                   (3, 1000, 1037), (2, 700, 300)])
def test_select_scratch_follows_the_band_width(shape, mode):
  P, ne, nc = shape
  o = _operands(P, ne, nc, mode, H100_SMS)
  part, tile_best, tile_idx, best, idx = select_top1._top1_scratch(o)
  if o.plan.chunks == 1:
    assert part is None
    assert tile_best.shape == tile_idx.shape == (P, -(-nc // BAND))
    assert tile_idx.dtype == torch.int32
  else:
    assert tile_best is None and tile_idx is None
    assert part.shape == (o.plan.chunks, P, nc)
  assert best.shape == idx.shape == (P,)
  assert o.path == mode


@pytest.mark.parametrize("shape", SMOKE_SHAPES)
def test_plan_at_the_smoke_shapes_fills_an_h100(shape):
  P, ne, nc = shape
  p = fg.plan(P, ne, nc, H100_SMS)
  assert p.units >= H100_SMS
  # the persistent grid is min(units, SMs): every SM gets a unit, and the
  # last wave leaves at most a fifth of the card idle
  waves = -(-p.units // H100_SMS)
  assert p.units / (waves * H100_SMS) >= 0.8


def test_plan_round_shapes():
  """Round 1 needs no eval split; round 2 and the lazy rescans do."""
  r1 = fg.plan(16, 16384, 16384, H100_SMS)
  assert (r1.bands, r1.chunks, r1.units) == (64, 1, 1024)
  r2 = fg.plan(1, 262144, 1024, H100_SMS)
  assert r2.bands == 4 and r2.chunks > 1 and r2.tiles == 2048
  lazy = fg.plan(16, 16384, 256, H100_SMS)
  assert lazy.bands == 1 and lazy.chunks > 1
  # the wide path (d = 768, streamed) runs round 1 on the same plan and
  # 256-row bands: its top-1 scratch has 64 bands a partition
  o = _operands(16, 16384, 16384, "streamed", H100_SMS)
  assert o.path == "streamed" and o.plan == r1
  assert select_top1._top1_scratch(o)[1].shape == (16, 64)
