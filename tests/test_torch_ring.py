"""The ring rule of the persistent TMA kernels (``kernels/ring.py``), shared
by ``csrc/pairwise.cu`` and ``csrc/facility.cu``, as a pure function of the
width, and the operand preparation of their wrappers.

Every width from 1 to 4096, float32 and bfloat16, takes a mode (resident
within 2 boxes of 128 bytes, streamed past that), its shared memory stays
within the 227 KB a block may use, its streamed ring is as deep as fits,
and its padded pitch is d rounded up to 16 bytes.  Features and vectors go
to the kernel as they are where TMA reads them, and otherwise as a padded
copy holding the same values.  CPU only: no kernel runs (the card tests
hold the kernels' own shared-memory formulas to these).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ring  # noqa: E402

NV = {"pairwise": (2,), "facility": (2, 3)}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("kernel", ["pairwise", "facility"])
def test_every_width_takes_a_path_within_shared_memory(kernel, itemsize):
  per_box = ring.BOX // itemsize
  for nv in NV[kernel]:
    for d in range(1, 4097):
      r = ring.plan(kernel, d, itemsize, nv)
      assert r.boxes == -(-d // per_box)
      assert r.mode == ("resident" if r.boxes <= ring.MAX_RESIDENT_BOXES
                        else "streamed"), d
      assert r.smem <= ring.SMEM_MAX, (d, r)
      assert r.stages >= 2
      assert r.pitch >= d and (r.pitch * itemsize) % ring.ALIGN == 0
      assert (r.pitch - d) * itemsize < ring.ALIGN
      if r.streamed:  # as deep as fits
        smem = (ring.pairwise_smem(r.boxes, r.stages + 1, True)
                if kernel == "pairwise" else
                ring.facility_smem(r.boxes, r.stages + 1, True, nv))
        assert smem > ring.SMEM_MAX


def test_stage_counts_and_the_kernels_shared_memory():
  """The resident rings keep the kernels' fixed depths (pairwise 2, the
  facility kernel 3, as they ran at d = 64); the streamed rings are 3 and 4
  deep; the byte counts are the kernels' own formulas."""
  assert ring.plan("pairwise", 64, 4) == ring.Ring("resident", 2, 2, 202800,
                                                   64)
  assert ring.plan("facility", 64, 4, 2) == ring.Ring("resident", 2, 3,
                                                      169152, 64)
  assert ring.plan("facility", 64, 4, 3).smem == 170688
  assert ring.plan("pairwise", 768, 4) == ring.Ring("streamed", 24, 3,
                                                    219200, 768)
  assert ring.plan("facility", 3072, 2, 3) == ring.Ring("streamed", 48, 4,
                                                        205008, 3072)
  # the streamed ring holds one box of each operand a stage whatever d is
  assert len({ring.plan("facility", d, 4, 3).smem
              for d in range(65, 4097)}) == 1
  with pytest.raises(ValueError, match="unknown kernel"):
    ring.plan("graph_cut", 64, 4)


def _padded_holds(f, src):
  d = src.shape[-1]
  assert f.copied and f.ld * src.element_size() % ring.ALIGN == 0
  assert f.t.data_ptr() % ring.ALIGN == 0
  assert torch.equal(f.t[..., :d], src)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_features_as_they_are_or_as_a_padded_copy(dtype):
  esz = torch.tensor([], dtype=dtype).element_size()
  x = torch.randn(3, 50, 64).to(dtype)
  f = ring.features("t", x)  # contiguous, 16-byte rows: as it is
  assert not f.copied and f.t is x and (f.ld, f.bs) == (64, 50 * 64)
  # rows not a multiple of 16 bytes: a copy pitched to 16 bytes
  for d in (1, 6, 17, 22, 36, 130):
    y = torch.randn(3, 50, d).to(dtype)
    f = ring.features("t", y)
    if d * esz % ring.ALIGN == 0:
      assert not f.copied
      continue
    _padded_holds(f, y)
    assert f.ld == ring.plan("pairwise", d, esz).pitch
    assert f.bs == 50 * f.ld
  # a column slice: rows 128 apart (as it is), or a base one element off
  wide = torch.randn(3, 50, 128).to(dtype)
  f = ring.features("t", wide[..., :64])
  assert not f.copied and (f.ld, f.bs) == (128, 50 * 128)
  off = wide[..., 1:65]
  f = ring.features("t", off)
  _padded_holds(f, off)
  assert (f.ld, f.bs) == (64, 50 * 64)
  # a contiguous tensor whose base is one element past 16-byte alignment
  flat = torch.randn(2 * 40 * 64 + 1).to(dtype)
  shifted = flat[1:].view(2, 40, 64)
  _padded_holds(ring.features("t", shifted), shifted)
  # shared operands: 2-D, a batch of one, an expanded (stride-0) batch
  assert ring.features("t", x[0]).bs == 0
  assert ring.features("t", x[:1]).bs == 0
  f = ring.features("t", x[0].expand(3, 50, 64))
  assert not f.copied and f.bs == 0
  narrow = torch.randn(50, 22).to(dtype)
  f = ring.features("t", narrow.expand(3, 50, 22))
  _padded_holds(f, narrow)
  assert f.t.dim() == 2 and f.bs == 0  # one copy, shared by the batch
  # a single row takes the pitch of the width
  assert ring.features("t", torch.randn(1, 22).to(dtype)).ld == (
      ring.plan("pairwise", 22, esz).pitch)
  with pytest.raises(ValueError, match="contiguous"):
    ring.features("t", x.transpose(1, 2))


def test_vectors_as_they_are_or_as_a_padded_copy():
  v = torch.rand(4, 1000)
  assert ring.vector(v) == ring.Vec(v, 1000, False)
  assert ring.vector(v[0]).bs == 0 and not ring.vector(v[0]).copied
  assert ring.vector(v[:1]).bs == 0  # one partition: shared
  # batched rows not 16 bytes apart: rows padded to 4 floats
  odd = torch.rand(3, 1001)
  f = ring.vector(odd)
  assert f.copied and f.bs == 1004 and torch.equal(f.t[:, :1001], odd)
  # a base off 16 bytes: copied
  shifted = torch.rand(1001)[1:]
  f = ring.vector(shifted)
  assert f.copied and f.bs == 0 and torch.equal(f.t[:1000], shifted)
  assert f.t.data_ptr() % ring.ALIGN == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pitched_rows_are_read_in_place_and_gathered_in_their_pitch(dtype):
  """A pitched view (rows of d inside a 16-byte pitch, as ``pitched``
  makes on the card) goes to the kernel as it is, and ``gather_rows``
  keeps the pitch, so the rows a lazy rescan gathers need no copy either;
  everywhere else ``gather_rows`` is ``torch.gather``.  On the CPU
  ``pitched`` hands the tensor back."""
  x = torch.randn(3, 50, 22).to(dtype)
  assert ring.pitched(x) is x
  pitch = ring.plan("pairwise", 22, x.element_size()).pitch
  held = x.new_zeros(3, 50, pitch)[..., :22]
  held.copy_(x)
  f = ring.features("t", held)
  assert not f.copied and (f.ld, f.bs) == (pitch, 50 * pitch)
  ids = torch.tensor([[4, 0, 49], [7, 7, 1], [2, 30, 11]])
  want = torch.gather(x, -2, ids.unsqueeze(-1).expand(3, 3, 22))
  rows = ring.gather_rows(held, ids)
  assert torch.equal(rows, want) and rows.stride(-2) == pitch
  assert not ring.features("t", rows).copied
  assert torch.equal(ring.gather_rows(x, ids), want)
  # a shared (stride-0) pitched batch, and a column slice that ends at its
  # storage's last element (no room to read a wider row: a plain gather)
  shared = held[0].expand(3, 50, 22)
  assert torch.equal(ring.gather_rows(shared, ids),
                     torch.gather(x[0].expand(3, 50, 22), -2,
                                  ids.unsqueeze(-1).expand(3, 3, 22)))
  tail = torch.randn(50, 23).to(dtype)[:, 1:]
  assert torch.equal(ring.gather_rows(tail, ids[0]),
                     tail[ids[0]])


def test_lazy_greedy_on_pitched_candidates_selects_the_same():
  """The tile-bound lazy greedy gathers its rescan rows with
  ``gather_rows``: over candidates held in a wider pitch it selects what it
  selects over the same rows held contiguous."""
  from repro_torch.core import greedy as G
  from repro_torch.core import objectives as O
  g = torch.Generator().manual_seed(5)
  cands = torch.randn(4, 64, 22, generator=g)
  held = cands.new_zeros(4, 64, 24)[..., :22]
  held.copy_(cands)
  obj = O.FacilityLocation(backend="ref")
  st = obj.broadcast(obj.init(cands[0]), 4)
  plain = G.greedy(obj, st, cands, 6, mode="lazy", lazy_tile=16)
  again = G.greedy(obj, st, held, 6, mode="lazy", lazy_tile=16)
  assert torch.equal(plain.idx, again.idx)
  assert torch.equal(plain.gains, again.gains)
