"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip where there is none (the decision
is taken inside the fixture, never at import).  They import no JAX, so
they run on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 within 2e-5 relative to the largest magnitude (1e-4 for
gain sums over more than 16k eval rows, summed in another order), bf16
within 3e-2; top-1 indices equal.  The info-gain conds are held the same
way, the selection built from a real Cholesky factor (float64 on the CPU),
dense and with the selection counts (``live``, junk past the live
triangle), and so are the saturated-coverage gains; the pairwise and the
facility / coverage kernels are held at every width class (d = 6 to 3072,
both ring modes of ``ring.plan``, padded copies of rows TMA does not read
as they are, column slices, stride-0 shared operands) with two calls
giving the same bits and the kernels' shared memory equal to the rule's;
the pairwise kernel also at its edges (shared blocks, plain stores, a
batch past one wave); one small selection-service run holds a
warm-started epoch against a cold one on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (torch.float32, 2e-5), "bf16": (torch.bfloat16, 3e-2)}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels run only on the card")
  from repro_torch import no_tf32
  no_tf32()
  return torch.device("cuda")


def _close(got, want, tol):
  got = got.float().cpu().numpy()
  want = want.float().cpu().numpy()
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_kernels_match_plain(cuda_device, kernel, dtype):
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(6)
  for (P, ne, nc, d) in [(None, 100, 70, 17), (3, 300, 257, 64),
                         (1, 20000, 300, 64)]:
    lead = () if P is None else (P,)
    dev = cuda_device
    ev = torch.tensor(r.normal(size=(*lead, ne, d)), device=dev).to(td)
    cd = torch.tensor(r.normal(size=(*lead, nc, d)), device=dev).to(td)
    cov = torch.tensor(np.abs(r.normal(size=(*lead, ne))), device=dev).float()
    mask = torch.tensor(r.uniform(size=(*lead, ne)) > 0.1, device=dev).float()
    ok = torch.tensor(r.uniform(size=(*lead, nc)) > 0.3, device=dev)
    s = ops.pairwise(ev, cd, kernel=kernel)
    g = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
    b, i = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
    torch.cuda.synchronize()
    gw = ref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel)
    bw, iw = ref.masked_top1(gw, ok)
    long_tol = tol if ne <= 16384 else max(tol, 1e-4)
    _close(s, ref.pairwise_ref(ev, cd, kernel=kernel), tol)
    _close(g, gw, long_tol)
    assert torch.equal(i.cpu(), iw.cpu())
    _close(b, bw, long_tol)


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_check_operands(cuda_device):
  x = torch.randn(4, 50, 8, device=cuda_device)
  ops.reset_launch_counts()
  ops.pairwise(x, x[0], kernel="linear")
  ops.facility_gain(x, x, torch.zeros(4, 50, device=cuda_device),
                    torch.ones(50, device=cuda_device))
  sel, linv = x[:, :6].contiguous(), torch.zeros(4, 6, 6, device=cuda_device)
  ops.info_gain_cond(sel, linv, x[0])
  ops.info_select(sel, linv, x[0], torch.ones(50, dtype=torch.bool,
                                              device=cuda_device))
  cap = torch.ones(4, 50, device=cuda_device)
  ops.coverage_gain(x, x, torch.zeros(50, device=cuda_device), cap,
                    torch.ones(50, device=cuda_device))
  assert ops.launch_counts() == {"pairwise": 1, "facility_gain": 1,
                                 "facility_select": 0, "coverage_gain": 1,
                                 "coverage_select": 0, "info_gain_cond": 1,
                                 "info_select": 1, "graph_cut_gain": 0,
                                 "graph_cut_select": 0, "flash_attention": 0,
                                 "relu_colsum": 0, "sieve_admit": 0}
  from repro_torch.kernels import sieve as SV
  s_pre = torch.zeros(1, 50, 6, device=cuda_device)
  with pytest.raises(ValueError, match="sieve_scan: s_intra"):
    SV.sieve_scan(s_pre, torch.zeros(50, 49, device=cuda_device), None, None,
                  torch.ones(50, device=cuda_device),
                  torch.arange(50, device=cuda_device),
                  torch.ones(1, 50, dtype=torch.bool, device=cuda_device),
                  torch.ones(3, device=cuda_device),
                  torch.full((1, 3, 2), -1, device=cuda_device),
                  torch.zeros(1, 3, 2, device=cuda_device),
                  torch.zeros(1, 3, dtype=torch.int64, device=cuda_device))
  with pytest.raises(TypeError, match="linv must be float32"):
    ops.info_gain_cond(sel, linv.double(), x[0])
  with pytest.raises(ValueError, match="live of shape"):
    ops.info_gain_cond(sel, linv, x[0], live=torch.zeros(3, dtype=torch.int64,
                                                         device=cuda_device))
  with pytest.raises(TypeError, match="integer tensor"):
    ops.info_select(sel, linv, x[0], torch.ones(50, dtype=torch.bool,
                                                device=cuda_device),
                    live=torch.zeros(4, device=cuda_device))
  with pytest.raises(ValueError, match="rbf width"):
    ops.pairwise(x, x, kernel="rbf", h=1e-12)
  with pytest.raises(ValueError, match="0 partitions"):
    ops.info_gain_cond(torch.zeros(0, 4, 8, device=cuda_device),
                       torch.zeros(0, 4, 4, device=cuda_device),
                       torch.zeros(0, 50, 8, device=cuda_device))
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    ops.pairwise(x.half(), x.half())
  with pytest.raises(ValueError, match="contiguous"):
    ops.pairwise(x.transpose(1, 2), x)


def _ig_operands(r, P, k, count, nc, d, kernel, td, dev):
  """Selections, masked inverse Cholesky factors of K_SS + I and
  candidates; P = None for unbatched operands."""
  lead = () if P is None else (P,)
  sel = np.zeros((*lead, k, d))
  sel[..., :count, :] = r.normal(size=(*lead, count, d)) / np.sqrt(d)
  cand = r.normal(size=(*lead, nc, d)) / np.sqrt(d)
  s = torch.tensor(sel)
  if kernel == "rbf":
    d2 = (s * s).sum(-1, keepdim=True) - 2 * s @ s.mT + (s * s).sum(-1)[
        ..., None, :]
    kss = torch.exp(-d2.clamp_min(0) / 0.5625)
  else:
    kss = s @ s.mT
  live = torch.arange(k) < count
  kss = torch.where(live[:, None] & live[None, :], kss, 0.0) + torch.eye(k)
  linv = torch.where(live, torch.linalg.inv(torch.linalg.cholesky(kss)), 0.0)
  return (torch.tensor(sel, device=dev).to(td), linv.float().to(dev),
          torch.tensor(cand, device=dev).to(td))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_info_kernels_match_plain(cuda_device, kernel, dtype):
  """info_gain_cond and info_select against their plain versions: k_max of
  1, 80, 128 and one past the shared-memory cross tile (400), ragged nc,
  partial and full counts, a shared candidate block."""
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(7)
  for (P, k, count, nc, d, shared) in [(None, 1, 1, 70, 17, False),
                                       (3, 80, 40, 1037, 22, False),
                                       (2, 128, 128, 300, 6, True),
                                       (2, 400, 250, 150, 6, False)]:
    sel, linv, cand = _ig_operands(r, P, k, count, nc, d, kernel, td,
                                   cuda_device)
    if shared:
      cand = cand[0]
    ok = torch.tensor(r.uniform(size=(nc,) if P is None else (P, nc)) > 0.3,
                      device=cuda_device)
    got = ops.info_gain_cond(sel, linv, cand, kernel=kernel)
    best, idx = ops.info_select(sel, linv, cand, ok, kernel=kernel)
    torch.cuda.synchronize()
    want = ref.info_gain_cond_ref(sel, linv, cand, kernel=kernel)
    wb, wi = ref.masked_top1(want, ok, floor=0.0)
    _close(got, want, tol)
    assert torch.equal(idx.cpu(), wi.cpu()), (P, k, idx, wi)
    _close(best, wb, tol)


def _junk(linv, count, r):
  """linv with random values in its upper triangle and past ``count``
  (per partition when count is a sequence)."""
  k = linv.shape[-1]
  ar = torch.arange(k, device=linv.device)
  c = torch.as_tensor(count, device=linv.device)[..., None]
  on = ar < c
  keep = on[..., :, None] & on[..., None, :] & (ar[:, None] >= ar[None, :])
  noise = torch.tensor(r.normal(size=tuple(linv.shape)), device=linv.device)
  return torch.where(keep, linv, noise.float()).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_info_kernels_live_match_plain(cuda_device, kernel, dtype):
  """With the selection counts the kernels equal the plain versions under
  the same contract at counts 0, partial and k_max (k_max 7, 128 and 400,
  whose linv is read from L2), with junk past the live triangle; one launch
  over partitions of different counts; and the dense call on the masked
  factor."""
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(17)
  dev = cuda_device
  for (P, k, counts, nc, d) in [(2, 7, (0, 7), 300, 6),
                                (3, 128, (0, 64, 128), 1037, 6),
                                (3, 128, (1, 17, 100), 700, 22),
                                (2, 400, (200, 400), 257, 6)]:
    parts = [_ig_operands(r, None, k, c, nc, d, kernel, td, dev)
             for c in counts]
    sel = torch.stack([p_[0] for p_ in parts])
    clean = torch.stack([p_[1] for p_ in parts])
    cand = torch.stack([p_[2] for p_ in parts])
    live = torch.tensor(counts, device=dev)
    linv = _junk(clean, counts, r)
    ok = torch.tensor(r.uniform(size=(len(counts), nc)) > 0.3, device=dev)
    got = ops.info_gain_cond(sel, linv, cand, kernel=kernel, live=live)
    best, idx = ops.info_select(sel, linv, cand, ok, kernel=kernel, live=live)
    dense = ops.info_gain_cond(sel, clean, cand, kernel=kernel)
    torch.cuda.synchronize()
    want = ref.info_gain_cond_ref(sel, linv, cand, kernel=kernel, live=live)
    wb, wi = ref.masked_top1(want, ok, floor=0.0)
    _close(got, want, tol)
    _close(dense, want, tol)
    assert torch.equal(idx.cpu(), wi.cpu()), (k, counts, idx, wi)
    _close(best, wb, tol)
    for p, c in enumerate(counts):  # one partition alone, a scalar count
      one = ops.info_gain_cond(sel[p], linv[p], cand[p], kernel=kernel,
                               live=torch.tensor(c, device=dev))
      assert torch.equal(one, got[p])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("k,counts,nc,d", [(512, (300, 512), 700, 64),
                                           (64, (10, 64), 500, 768),
                                           (2100, (2100,), 300, 6),
                                           (5000, (4000, 5000), 200, 6)])
def test_cuda_info_kernels_past_shared_memory(cuda_device, k, counts, nc, d,
                                              kernel):
  """Shapes whose sel rows, cross tile or candidate stages do not fit the
  staged modes' shared memory (the GENERIC mode: d 64 at k 512, d 768 at
  k 64, k 2100 past 256 slots, and k 5000 with X in device scratch) against
  the plain versions, dense and with the selection counts (junk past the
  live triangle), f32 and, at the first two, bf16."""
  r = np.random.default_rng(19)
  dev = cuda_device
  for dtype in (("f32", "bf16") if k <= 512 else ("f32",)):
    td, tol = DTYPES[dtype]
    parts = [_ig_operands(r, None, k, c, nc, d, kernel, td, dev)
             for c in counts]
    sel = torch.stack([p_[0] for p_ in parts])
    clean = torch.stack([p_[1] for p_ in parts])
    cand = torch.stack([p_[2] for p_ in parts])
    live = torch.tensor(counts, device=dev)
    linv = _junk(clean, counts, r)
    ok = torch.tensor(r.uniform(size=(len(counts), nc)) > 0.3, device=dev)
    for lv, lf in ((None, clean), (live, linv)):
      got = ops.info_gain_cond(sel, lf, cand, kernel=kernel, live=lv)
      best, idx = ops.info_select(sel, lf, cand, ok, kernel=kernel, live=lv)
      torch.cuda.synchronize()
      want = ref.info_gain_cond_ref(sel, lf, cand, kernel=kernel, live=lv)
      wb, wi = ref.masked_top1(want, ok, floor=0.0)
      _close(got, want, tol)
      _close(best, wb, tol)
      assert torch.equal(idx.cpu(), wi.cpu()), (k, d, dtype, idx, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("hh", [1e-20, 1e-12, 1e-6, 0.01, 0.5625, 1.0, 2.0,
                                7.3, 1e6, 1e20])
def test_cuda_sim_rn_equals_sim_of_bitwise(cuda_device, hh):
  """The pairwise and info-gain kernels' division-free rbf value
  (csrc/sm90.cuh sim_rn) equals tile.cuh's sim_of in every bit at every
  non-negative finite squared distance, at widths across the range the
  wrappers take (h * h within [1e-20, 1e20])."""
  from repro_torch.kernels import pairwise as pw
  assert pw.sim_mismatches(hh, cuda_device) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_pairwise_edges(cuda_device, dtype):
  """The pairwise kernel against its plain version at ragged nx / ny, d of
  6, 17, 22, 36, 64, 128 and 130 (the resident ring to 2 boxes of 128
  bytes, the streamed ring past them; a padded copy where d * itemsize is
  not a multiple of 16 or a base is misaligned), a shared y and a shared x
  block, ny not a multiple of 4 (plain stores), a batch past one wave of
  persistent blocks; two launches give the same bytes."""
  from repro_torch.kernels import pairwise as pw
  td, tol = DTYPES[dtype]
  f32 = dtype == "f32"
  r = np.random.default_rng(14)
  # (x shape, y shape, ring mode, operands copied)
  cases = [((2, 1000, 64), (2, 1037, 64), "resident", ()),
           ((3, 200, 6), (3, 130, 6), "resident", ("x", "y")),
           ((2, 300, 22), (300, 22), "resident", ("x", "y")),
           ((2, 257, 130), (2, 129, 130), "streamed", ("x", "y")),
           ((1, 129, 36), (1, 131, 36), "resident",
            () if f32 else ("x", "y")),
           ((300, 130, 64), (300, 64, 64), "resident", ()),
           ((100, 64), (4, 77, 64), "resident", ()),
           ((5, 128, 64), (128, 64), "resident", ()),
           ((1, 4096, 64), (1, 1023, 64), "resident", ()),
           ((2, 300, 128), (2, 257, 128), "streamed" if f32 else "resident",
            ()),
           ((2, 131, 17), (2, 70, 17), "resident", ("x", "y")),
           ("offset", (2, 200, 64), (2, 90, 64), "resident", ("x", "y"))]
  for case in cases:
    xs, ys, mode, copies = case[-4:]
    x = torch.tensor(r.normal(size=xs), device=cuda_device).to(td)
    y = torch.tensor(r.normal(size=ys), device=cuda_device).to(td)
    if case[0] == "offset":  # bases one element past 16-byte alignment
      x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(xs)
      y = torch.cat([y.new_zeros(1), y.flatten()])[1:].view(ys)
    o = pw.operands(x, y)
    assert (o.ring.mode, o.copies) == (mode, copies), (xs, ys)
    for kernel in ("linear", "rbf"):
      got = ops.pairwise(x, y, kernel=kernel)
      again = ops.pairwise(x, y, kernel=kernel)
      torch.cuda.synchronize()
      _close(got, ref.pairwise_ref(x, y, kernel=kernel), tol)
      assert torch.equal(got, again)


WIDTHS = [6, 17, 22, 36, 64, 128, 130, 768, 3072]


def _sliced(r, shape, td, dev, offset, scale):
  """Normal rows of ``shape`` times ``scale`` as a column slice of a wider
  block, starting ``offset`` columns in (1: a base off 16 bytes and rows a
  pitch apart)."""
  *lead, n, d = shape
  wide = torch.tensor(r.normal(size=(*lead, n, d + 8)) * scale,
                      device=dev).to(td)
  return wide[..., offset:offset + d]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_every_width_matches_plain(cuda_device, dtype, d):
  """pairwise and the four facility / coverage entries at width d against
  their plain versions: ragged n, a column slice whose base is one element
  off 16 bytes (a padded copy), a stride-0 shared operand (an expanded
  block), the resident or the streamed ring as ``ring.plan`` names it (and
  the kernels' own shared-memory formulas equal to the rule's); two calls
  give the same bits."""
  from repro_torch.kernels import build, ring
  from repro_torch.kernels import facility_gain as fg
  from repro_torch.kernels import pairwise as pw
  td, tol = DTYPES[dtype]
  esz = 4 if dtype == "f32" else 2
  r = np.random.default_rng(d)
  dev = cuda_device
  rp = ring.plan("pairwise", d, esz)
  assert build.entry("sm90_pairwise_smem")(rp.boxes, int(rp.streamed)) == (
      rp.smem)
  for nv in (2, 3):
    rf = ring.plan("facility", d, esz, nv)
    assert build.entry("sm90_facility_smem")(rf.boxes, nv, int(
        rf.streamed)) == rf.smem
  scale = 1.0 / np.sqrt(d)  # unit-scale similarities: rbf at h = 0.75
  x = _sliced(r, (3, 301, d), td, dev, 1, scale)
  y = (torch.tensor(r.normal(size=(129, d)), device=dev).to(td) * scale
       ).expand(3, 129, d)
  o = pw.operands(x, y)
  assert o.ring == rp and o.x.copied and o.y.bs == 0
  assert o.y.copied == (d * esz % 16 != 0)
  for kernel in ("linear", "rbf"):
    got = ops.pairwise(x, y, kernel=kernel)
    again = ops.pairwise(x, y, kernel=kernel)
    torch.cuda.synchronize()
    _close(got, ref.pairwise_ref(x, y, kernel=kernel), tol)
    assert torch.equal(got, again)
  # facility / coverage: sliced eval rows, a shared (expanded) block of
  # candidates, ragged ne and nc
  ne, nc = 700, 300
  ev = _sliced(r, (3, ne, d), td, dev, 1, scale).abs_()
  cd = (torch.tensor(np.abs(r.normal(size=(nc, d))), device=dev).to(td) *
        scale).expand(3, nc, d)
  cov = torch.tensor(np.abs(r.normal(size=(3, ne))) * 0.2, device=dev).float()
  cap = torch.tensor(np.abs(r.normal(size=(3, ne))) * 4, device=dev).float()
  cover = cap * torch.tensor(r.uniform(0.0, 1.3, size=(3, ne)),
                             device=dev).float()
  mask = torch.tensor(r.uniform(size=(3, ne)) > 0.1, device=dev).float()
  ok = torch.tensor(r.uniform(size=(3, nc)) > 0.3, device=dev)
  for args, gain, sel, want, nv in (
      ((cov,), ops.facility_gain, ops.facility_select, ref.facility_gain_ref,
       2),
      ((cover, cap), ops.coverage_gain, ops.coverage_select,
       ref.coverage_gain_ref, 3)):
    o = fg.operands("t", ev, cd, args[0], mask, ok,
                    cap=args[1] if nv == 3 else None)
    assert o.ring == ring.plan("facility", d, esz, nv)
    assert o.path == o.ring.mode and o.ev.copied and o.cd.bs == 0
    for kernel in ("linear", "rbf"):
      g = gain(ev, cd, *args, mask, kernel=kernel)
      b, i = sel(ev, cd, *args, mask, ok, kernel=kernel)
      g2 = gain(ev, cd, *args, mask, kernel=kernel)
      b2, i2 = sel(ev, cd, *args, mask, ok, kernel=kernel)
      torch.cuda.synchronize()
      assert torch.equal(g, g2) and torch.equal(b, b2) and torch.equal(i, i2)
      gw = want(ev, cd, *args, mask, kernel=kernel)
      bw, iw = ref.masked_top1(gw, ok)
      _close(g, gw, tol)
      assert torch.equal(i.cpu(), iw.cpu())
      _close(b, bw, tol)


def _cov_operands(r, lead, ne, nc, d, td, dev):
  ev = torch.tensor(r.normal(size=(*lead, ne, d)), device=dev).to(td)
  cd = torch.tensor(r.normal(size=(*lead, nc, d)), device=dev).to(td)
  cap = np.abs(r.normal(size=(*lead, ne))) * d
  cover = cap * r.uniform(0.0, 1.3, size=cap.shape)  # some rows saturated
  mask = torch.tensor(r.uniform(size=(*lead, ne)) > 0.1, device=dev).float()
  ok = torch.tensor(r.uniform(size=(*lead, nc)) > 0.3, device=dev)
  return (ev, cd, torch.tensor(cover, device=dev).float(),
          torch.tensor(cap, device=dev).float(), mask, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_coverage_kernels_match_plain(cuda_device, kernel, dtype):
  """coverage_gain and coverage_select against their plain versions:
  ragged shapes, a partition axis, one long eval axis (the chunked stage
  2), a shared cap, the batched query form (per-query cover, mask and ok
  over one shared block), nothing feasible and exact ties."""
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(8)
  dev = cuda_device
  for (P, ne, nc, d) in [(None, 100, 70, 17), (3, 300, 257, 64),
                         (1, 20000, 300, 64)]:
    lead = () if P is None else (P,)
    ev, cd, cover, cap, mask, ok = _cov_operands(r, lead, ne, nc, d, td, dev)
    g = ops.coverage_gain(ev, cd, cover, cap, mask, kernel=kernel)
    b, i = ops.coverage_select(ev, cd, cover, cap, mask, ok, kernel=kernel)
    torch.cuda.synchronize()
    gw = ref.coverage_gain_ref(ev, cd, cover, cap, mask, kernel=kernel)
    bw, iw = ref.masked_top1(gw, ok)
    long_tol = tol if ne <= 16384 else max(tol, 1e-4)
    _close(g, gw, long_tol)
    assert torch.equal(i.cpu(), iw.cpu())
    _close(b, bw, long_tol)
  # shared cap and block, per-query state: the batched query form
  ev, cd, _, cap, _, _ = _cov_operands(r, (), 500, 300, 32, td, dev)
  cover = cap * torch.rand(16, 500, device=dev)
  mask = (torch.rand(16, 500, device=dev) > 0.1).float()
  ok = torch.rand(16, 300, device=dev) > 0.3
  b, i = ops.coverage_select(ev, cd, cover, cap, mask, ok, kernel=kernel)
  bw, iw = ref.coverage_select_ref(ev, cd, cover, cap, mask, ok,
                                   kernel=kernel)
  assert torch.equal(i, iw)
  _close(b, bw, tol)
  # nothing feasible
  b, i = ops.coverage_select(ev, cd, cover, cap, mask, torch.zeros_like(ok),
                             kernel=kernel)
  assert bool((b == ref.NEG).all()) and bool((i == 0).all())
  # exact ties: +-10 sign rows, the best candidate duplicated twice
  signs = torch.where(torch.rand(300, 8, device=dev) > 0.5, 10.0, -10.0)
  e_t = signs[torch.randint(0, 300, (700,), device=dev)]
  zero = torch.zeros(700, device=dev)
  big = torch.full((700,), 1e4, device=dev)
  ones = torch.ones(700, device=dev)
  j = int(ref.coverage_gain_ref(e_t, signs, zero, big, ones,
                                kernel=kernel).argmax())
  signs[(j + 211) % 300] = signs[j]
  signs[(j + 97) % 300] = signs[j]
  allok = torch.ones(300, dtype=torch.bool, device=dev)
  b, i = ops.coverage_select(e_t.to(td), signs.to(td), zero, big, ones,
                             allok, kernel=kernel)
  bw, iw = ref.coverage_select_ref(e_t.to(td), signs.to(td), zero, big, ones,
                                   allok, kernel=kernel)
  assert int(i) == int(iw) and float(b) == float(bw)


def _fl_case(r, lead, ne, nc, d, td, dev, shared_cd=False, shared_cap=False):
  """Facility and coverage operands: eval rows, candidates (shared by the
  partitions when ``shared_cd``), a facility cov, a cover with some rows
  past their cap (shared when ``shared_cap``), a mask, an ok."""
  ev = torch.tensor(r.normal(size=(*lead, ne, d)), device=dev).to(td)
  cd = torch.tensor(r.normal(size=((() if shared_cd else lead)) + (nc, d)),
                    device=dev).to(td)
  cov = torch.tensor(np.abs(r.normal(size=(*lead, ne))), device=dev).float()
  cap = np.abs(r.normal(size=((() if shared_cap else lead)) + (ne,))) * d
  cover = torch.tensor(cap * r.uniform(0.0, 1.3, size=(*lead, ne)),
                       device=dev).float()
  mask = torch.tensor(r.uniform(size=(*lead, ne)) > 0.1, device=dev).float()
  ok = torch.tensor(r.uniform(size=(*lead, nc)) > 0.3, device=dev)
  return ev, cd, cov, torch.tensor(cap, device=dev).float(), cover, mask, ok


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_facility_persistent_matches_plain(cuda_device, kernel, dtype):
  """The facility / coverage kernel at d 64 (a resident 256-row candidate
  band, eval tiles through a TMA ring) against the plain
  versions: ragged ne and nc, a shared candidate block and a shared cap
  (batch stride 0), the chunked round-2 shape (one partition, a long eval
  axis), unbatched operands, nothing feasible and exact ties from +-10
  sign rows; two calls give the same bits."""
  from repro_torch.kernels import facility_gain as fg
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(18)
  dev = cuda_device
  for lead, ne, nc, sh_cd, sh_cap in [((3,), 1000, 1037, False, False),
                                      ((4,), 700, 300, True, True),
                                      ((1,), 40000, 1000, False, False),
                                      ((), 3000, 700, False, False)]:
    ev, cd, cov, cap, cover, mask, ok = _fl_case(r, lead, ne, nc, 64, td,
                                                 dev, sh_cd, sh_cap)
    o = fg.operands("facility", ev, cd, cov, mask, ok)
    oc = fg.operands("coverage", ev, cd, cover, mask, ok, cap=cap)
    assert o.path == oc.path == "resident"
    if ne == 40000:  # the eval axis is split: chunk partials, stage 2 sums
      assert o.plan.chunks > 1 and oc.plan.chunks > 1
    long_tol = tol if ne <= 16384 else max(tol, 1e-4)
    for fn, sel, args, want in (
        (ops.facility_gain, ops.facility_select, (cov,),
         ref.facility_gain_ref),
        (ops.coverage_gain, ops.coverage_select, (cover, cap),
         ref.coverage_gain_ref)):
      g = fn(ev, cd, *args, mask, kernel=kernel)
      b, i = sel(ev, cd, *args, mask, ok, kernel=kernel)
      g2 = fn(ev, cd, *args, mask, kernel=kernel)
      b2, i2 = sel(ev, cd, *args, mask, ok, kernel=kernel)
      torch.cuda.synchronize()
      assert torch.equal(g, g2) and torch.equal(b, b2) and torch.equal(i, i2)
      gw = want(ev, cd, *args, mask, kernel=kernel)
      bw, iw = ref.masked_top1(gw, ok)
      _close(g, gw, long_tol)
      assert torch.equal(i.cpu(), iw.cpu())
      _close(b, bw, long_tol)
      b, i = sel(ev, cd, *args, mask, torch.zeros_like(ok), kernel=kernel)
      assert bool((b == ref.NEG).all()) and bool((i == 0).all())
  # exact ties: +-10 sign rows, the best candidate again at a higher and a
  # lower index; every similarity and gain is an exact float
  signs = torch.where(torch.rand(2, 300, 64, device=dev) > 0.5, 10.0, -10.0)
  e_t = signs[:, torch.randint(0, 300, (700,), device=dev)]
  zero = torch.zeros(2, 700, device=dev)
  big = torch.full((2, 700), 1e6, device=dev)
  ones = torch.ones(2, 700, device=dev)
  top = ref.facility_gain_ref(e_t, signs, zero, ones,
                              kernel=kernel).argmax(dim=1)
  for p in range(2):
    j = int(top[p])
    signs[p, (j + 211) % 300] = signs[p, j]
    signs[p, (j + 97) % 300] = signs[p, j]
  allok = torch.ones(2, 300, dtype=torch.bool, device=dev)
  e_t, signs = e_t.to(td), signs.to(td)
  b, i = ops.facility_select(e_t, signs, zero, ones, allok, kernel=kernel)
  bw, iw = ref.facility_select_ref(e_t, signs, zero, ones, allok,
                                   kernel=kernel)
  assert torch.equal(i, iw) and torch.equal(b, bw)
  b, i = ops.coverage_select(e_t, signs, zero, big, ones, allok,
                             kernel=kernel)
  bw, iw = ref.coverage_select_ref(e_t, signs, zero, big, ones, allok,
                                   kernel=kernel)
  assert torch.equal(i, iw) and torch.equal(b, bw)


@pytest.mark.cuda
@pytest.mark.parametrize("case,d,dtype,path,copies", [
    ("plain", 22, "f32", "resident", ("ev", "cd")),
    ("plain", 22, "bf16", "resident", ("ev", "cd")),
    ("plain", 128, "f32", "streamed", ()),
    ("plain", 64, "f32", "resident", ()),
    ("plain", 64, "bf16", "resident", ()),
    ("plain", 128, "bf16", "resident", ()),
    ("offset features", 64, "f32", "resident", ("ev",)),
    ("vector rows not 16 bytes apart", 64, "f32", "resident",
     ("cov", "mask"))])
def test_cuda_facility_shape_rule(cuda_device, case, d, dtype, path, copies):
  """The ring rule picks the mode (resident within 2 boxes of 128 bytes of
  d, streamed past them) and the operands TMA does not read as they are go
  over as padded copies (rows not a multiple of 16 bytes, a misaligned
  base, batched vectors whose rows are not 16 bytes apart); the call
  matches the plain versions; an rbf width outside the division-free
  quotient's range raises."""
  from repro_torch.kernels import facility_gain as fg
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(19)
  ne = 1001 if case.startswith("vector") else 1000
  ev, cd, cov, cap, cover, mask, ok = _fl_case(r, (3,), ne, 300, d, td,
                                               cuda_device)
  if case == "offset features":  # one element past 16-byte alignment
    ev = torch.cat([ev.new_zeros(1), ev.flatten()])[1:].view(ev.shape)
  o = fg.operands("t", ev, cd, cov, mask, ok)
  assert (o.path, o.copies) == (path, copies)
  oc = fg.operands("t", ev, cd, cover, mask, ok, cap=cap)
  assert (oc.path, oc.copies) == (path, copies + (
      ("cap",) if "cov" in copies else ()))
  for kernel in ("linear", "rbf"):
    g = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
    b, i = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
    c = ops.coverage_gain(ev, cd, cover, cap, mask, kernel=kernel)
    torch.cuda.synchronize()
    gw = ref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel)
    bw, iw = ref.masked_top1(gw, ok)
    _close(g, gw, tol)
    _close(b, bw, tol)
    assert torch.equal(i, iw)
    _close(c, ref.coverage_gain_ref(ev, cd, cover, cap, mask, kernel=kernel),
           tol)
  with pytest.raises(ValueError, match="rbf width"):
    ops.facility_gain(ev, cd, cov, mask, kernel="rbf", h=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_pitched_operands_need_no_copy_and_keep_the_bits(cuda_device,
                                                              dtype):
  """``ring.pitched`` pads rows that are not a multiple of 16 bytes once:
  the wrappers then take them with no copy and give the bits of the call
  that copies; ``pairwise(x, x)`` copies x once.  The facility objective
  holds its eval rows so, a greedy run its candidates, and the standard
  and lazy runs select what the plain versions select."""
  from repro_torch.core import greedy as G
  from repro_torch.core import objectives as O
  from repro_torch.kernels import facility_gain as fg
  from repro_torch.kernels import pairwise as pw
  from repro_torch.kernels import ring
  td, _ = DTYPES[dtype]
  r = np.random.default_rng(29)
  ev, cd, cov, cap, cover, mask, ok = _fl_case(r, (3,), 1000, 300, 22, td,
                                               cuda_device)
  pe, pc = ring.pitched(ev), ring.pitched(cd)
  assert pe.shape == ev.shape and torch.equal(pe, ev) and torch.equal(pc, cd)
  assert fg.operands("t", ev, cd, cov, mask, ok).copies == ("ev", "cd")
  assert fg.operands("t", pe, pc, cov, mask, ok).copies == ()
  assert ring.pitched(pe) is pe
  o = pw.operands(ev, ev)
  assert o.x is o.y and o.x.copied and pw.operands(pe, pe).copies == ()
  assert torch.equal(ops.pairwise(pe, pc), ops.pairwise(ev, cd))
  assert torch.equal(ops.facility_gain(pe, pc, cov, mask),
                     ops.facility_gain(ev, cd, cov, mask))
  for got, want in zip(ops.facility_select(pe, pc, cov, mask, ok),
                       ops.facility_select(ev, cd, cov, mask, ok)):
    assert torch.equal(got, want)
  assert torch.equal(ops.coverage_gain(pe, pc, cover, cap, mask),
                     ops.coverage_gain(ev, cd, cover, cap, mask))
  for got, want in zip(ops.coverage_select(pe, pc, cover, cap, mask, ok),
                       ops.coverage_select(ev, cd, cover, cap, mask, ok)):
    assert torch.equal(got, want)
  obj = O.FacilityLocation()
  st = obj.broadcast(obj.init(ev[0]), 3)
  assert not ring.features("t", st.eval_feats).copied
  assert not ring.features("t", obj.kernel_rows(cd)).copied
  if dtype == "f32":  # bf16 plain sums round differently
    want = G.greedy(obj, st, cd, 6, backend="ref").idx
    for mode in ("standard", "lazy"):
      assert torch.equal(G.greedy(obj, st, cd, 6, mode=mode,
                                  lazy_tile=64).idx, want), mode


@pytest.mark.cuda
def test_cuda_service_warm_epoch_equals_cold(cuda_device):
  """A small selection service on the card: two appends with a growth,
  three epochs, saturated coverage and facility location, warm-started
  epochs select what cold ones select; the coverage kernels ran."""
  from repro_torch.service import SelectionService
  r = np.random.default_rng(9)
  x = np.abs(r.normal(size=(3000, 32))).astype(np.float32)
  x /= np.linalg.norm(x, axis=1, keepdims=True)
  for objective in ("saturated_coverage", "facility"):
    sels = {}
    for warm in (True, False):
      svc = SelectionService(m=4, d=32, kappa=8, k_final=8, capacity=1024,
                             append_block=256, warm_start=warm, seed=1,
                             objective=objective, device=cuda_device)
      ops.reset_launch_counts()
      out = []
      for part in (x[:2000], x[2000:]):
        svc.append(part)
        out.append(svc.epoch())
      out.append(svc.epoch())
      assert svc.growths == 2
      assert [o.stats.warm for o in out] == [warm] * 3
      sels[warm] = [o.sel_gids.tolist() for o in out]
      if objective == "saturated_coverage":
        assert ops.launch_counts()["coverage_gain"] > 0
    assert sels[True] == sels[False]


def _cut_weights(r, n, dev, td):
  """Sparse exponential weights, symmetric, zero diagonal."""
  w = r.exponential(size=(n, n)) * (r.uniform(size=(n, n)) < 0.05)
  w = 0.5 * (w + w.T)
  np.fill_diagonal(w, 0.0)
  return torch.tensor(w, device=dev).float().to(td).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_graph_cut_kernels_match_plain(cuda_device, dtype):
  """graph_cut_gain and graph_cut_select against their plain versions at
  ragged n (narrow loads), n % 8 == 0 (16-byte loads), P in {1, 16} and
  beyond one pass of 16, with partition indicators; gains within rtol 1e-5
  plus 1e-5 of each row's absolute sum (bf16 W is exact in f32, so one
  tolerance serves both), indices equal; nothing feasible gives (NEG, 0)
  and exact ties (binary weights) the lowest node."""
  td, _ = DTYPES[dtype]
  r = np.random.default_rng(12)
  dev = cuda_device
  for n in (100, 513, 1899, 2048):
    w = _cut_weights(r, n, dev, td)
    for P in (None, 1, 16, 37):
      lead = () if P is None else (P,)
      x = torch.tensor(r.uniform(size=(*lead, n)) < 0.3, device=dev).float()
      ind = None
      if P is not None:
        ind = torch.tensor(r.uniform(size=(P, n)) < 0.5, device=dev).float()
      ok = torch.tensor(r.uniform(size=(*lead, n)) < 0.7, device=dev)
      g = ops.graph_cut_gain(w, x, ind)
      b, i = ops.graph_cut_select(w, x, ok, ind)
      torch.cuda.synchronize()
      gw = ref.graph_cut_gain_ref(w, x, ind)
      bw, iw = ref.masked_top1(gw, ok)
      scale = ref.graph_cut_cols(x, ind).abs() @ w.float().abs().T
      assert bool(((g - gw).abs() <= 1e-5 * gw.abs() + 1e-5 * scale).all())
      assert torch.equal(i, iw)
      assert bool(((b - bw).abs() <= 1e-5 * bw.abs() + 1e-5 * scale.max())
                  .all())
      b, i = ops.graph_cut_select(w, x, torch.zeros_like(ok), ind)
      assert bool((b == ref.NEG).all()) and bool((i == 0).all())
  binary = (torch.rand(700, 700, device=dev) < 0.02).float()
  binary = torch.maximum(binary, binary.T).fill_diagonal_(0.0).to(td)
  zeros = torch.zeros(4, 700, device=dev)
  allok = torch.ones(4, 700, dtype=torch.bool, device=dev)
  b, i = ops.graph_cut_select(binary, zeros, allok)
  bw, iw = ref.graph_cut_select_ref(binary, zeros, allok)
  assert torch.equal(i, iw) and torch.equal(b, bw)


@pytest.mark.cuda
def test_cuda_graph_cut_counts_and_checks(cuda_device):
  """Each graph-cut wrapper counts its launches (a greedy step over
  GraphCut launches the gains kernel twice: the gains and the update's
  recompute; assume_node_order launches the select kernel), and the
  wrappers refuse what the kernel does not take."""
  from repro_torch.core import objectives as O
  from repro_torch.core.greedy import greedy
  r = np.random.default_rng(3)
  n = 300
  w = _cut_weights(r, n, cuda_device, torch.float32)
  eye = torch.eye(n, device=cuda_device)
  obj = O.GraphCut()
  ops.reset_launch_counts()
  a = greedy(obj, obj.init_w(w), eye, 5, use_select=False)
  counts = ops.launch_counts()
  assert counts["graph_cut_gain"] == 10 and counts["graph_cut_select"] == 0
  fused = O.GraphCut(assume_node_order=True)
  ops.reset_launch_counts()
  b = greedy(fused, fused.init_induced(w), eye, 5)
  counts = ops.launch_counts()
  assert counts["graph_cut_select"] == 5 and counts["graph_cut_gain"] == 5
  assert torch.equal(a.idx, b.idx)
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    ops.graph_cut_gain(w.double(), torch.zeros(n, device=cuda_device))
  with pytest.raises(ValueError, match="contiguous"):
    ops.graph_cut_gain(w.T, torch.zeros(n, device=cuda_device))
  with pytest.raises(ValueError, match="length"):
    ops.graph_cut_gain(w, torch.zeros(n + 1, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(cuda_device, causal, dtype):
  """The flash-attention kernel against ``mha_ref`` (1e-4 in f32, 3e-2 in
  bf16, the rule of tests/test_kernels.py) at ragged lengths, GQA and MHA,
  every head width it takes, a strided v; one launch per call."""
  td = DTYPES[dtype][0]
  tol = 1e-4 if dtype == "f32" else 3e-2
  r = np.random.default_rng(7)
  cases = [(2, 4, 2, 200, 64), (1, 8, 1, 63, 32), (1, 4, 4, 129, 128),
           (3, 8, 2, 1, 128)]
  ops.reset_launch_counts()
  for b, h, hkv, length, dh in cases:
    q = torch.tensor(r.normal(size=(b, h, length, dh)), device=cuda_device)
    k = torch.tensor(r.normal(size=(b, hkv, length, dh)), device=cuda_device)
    v = torch.tensor(r.normal(size=(b, length, hkv, dh)), device=cuda_device)
    q, k, v = q.to(td), k.to(td), v.to(td).transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.mha_ref(q, k, v, causal=causal)
    assert got.dtype == td and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
  assert ops.launch_counts()["flash_attention"] == len(cases)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), backend="cuda")
  bad = torch.zeros(1, 2, 16, 48, device=cuda_device, dtype=td)
  with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
    ops.flash_attention(bad, bad, bad)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_takes_tensor_cores(cuda_device):
  """Every bf16 call launches the tensor-core kernel (its own counter) and
  float32 the FFMA kernel; a bf16 stride aligned to 4 but not 8 elements
  raises; two launches on the same inputs give identical bytes; a grid of
  B H past 65535 and a non-default scale on strided operands hold the plain
  version (3e-2)."""
  from repro_torch.kernels import flash_attention as fa
  r = np.random.default_rng(8)
  dev = cuda_device

  def qkv(b, h, hkv, length, dh, td):
    q = torch.tensor(r.normal(size=(b, h, length, dh)), device=dev).to(td)
    k = torch.tensor(r.normal(size=(b, hkv, length, dh)), device=dev).to(td)
    v = torch.tensor(r.normal(size=(b, length, hkv, dh)), device=dev).to(td)
    return q, k, v.transpose(1, 2)

  ops.reset_launch_counts()
  q, k, v = qkv(257, 256, 32, 9, 32, torch.bfloat16)       # B H = 65792
  torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                             ref.mha_ref(q, k, v).float(), rtol=3e-2,
                             atol=3e-2)
  q, k, v = qkv(2, 8, 2, 200, 64, torch.bfloat16)
  a = ops.flash_attention(q, k, v, causal=False, scale=0.3)
  b = ops.flash_attention(q, k, v, causal=False, scale=0.3)
  torch.cuda.synchronize()
  assert torch.equal(a.view(torch.int16), b.view(torch.int16))
  torch.testing.assert_close(
      a.float(), ref.mha_ref(q, k, v, causal=False, scale=0.3).float(),
      rtol=3e-2, atol=3e-2)
  ops.flash_attention(q.float(), k.float(), v.float())
  assert (fa.launches, fa.tc_launches) == (4, 3)
  wide = torch.zeros(1, 4, 16, 36, dtype=torch.bfloat16, device=dev)
  with pytest.raises(ValueError, match="multiples of 8"):
    ops.flash_attention(wide[..., :32], wide[:, :2, :, :32],
                        wide[:, :2, :, :32])
  assert fa.tc_launches == 3


@pytest.mark.cuda
def test_cuda_graph_cut_one_kernel_a_call(cuda_device):
  """Each graph_cut_gain and graph_cut_select call is one CUDA kernel at
  P = 1, 10 and 16 over a ragged n, with x and the indicator in their own
  dtypes and an expanded (stride 0) indicator; the results equal the plain
  versions' and the select's index is int64.  The kernels are counted by
  the launch calls torch.profiler records on the host (``cudaLaunch*`` /
  ``cuLaunch*``), which are complete, where its device records can drop a
  window's first ones."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  r = np.random.default_rng(13)
  dev = cuda_device
  n = 1899
  w = _cut_weights(r, n, dev, torch.float32)
  for P, x_dt, ind_kind in ((None, torch.bool, None), (1, torch.float32,
                                                       "u8"),
                            (10, torch.uint8, "expanded"),
                            (16, torch.float32, "f32")):
    lead = () if P is None else (P,)
    x = torch.tensor(r.uniform(size=(*lead, n)) < 0.2, device=dev).to(x_dt)
    ind = None
    if ind_kind == "u8":
      ind = torch.tensor(r.uniform(size=(P, n)) < 0.5, device=dev).to(
          torch.uint8)
    elif ind_kind == "expanded":
      ind = torch.tensor(r.uniform(size=n) < 0.5, device=dev).float().expand(
          P, n)
    elif ind_kind == "f32":
      ind = torch.tensor(r.uniform(size=(P, n)) < 0.5, device=dev).float()
    ok = torch.tensor(r.uniform(size=(*lead, n)) < 0.7, device=dev)
    calls = (lambda: ops.graph_cut_gain(w, x, ind),
             lambda: ops.graph_cut_select(w, x, ok, ind))
    for call in calls:
      call()                                     # warm-up: build, buffers
      torch.cuda.synchronize()
      with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True) as prof:
        for _ in range(3):
          call()
        torch.cuda.synchronize()
      evs = prof.events()
      launch = [e.name for e in evs if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunch", "cuLaunch"))]
      assert len(launch) == 3, (launch, sorted(
          {e.name for e in evs if e.device_type == DeviceType.CUDA}))
    g = ops.graph_cut_gain(w, x, ind)
    b, i = ops.graph_cut_select(w, x, ok, ind)
    gw = ref.graph_cut_gain_ref(w, x, ind)
    bw, iw = ref.masked_top1(gw, ok)
    scale = ref.graph_cut_cols(x, ind).abs() @ w.float().abs().T
    assert bool(((g - gw).abs() <= 1e-5 * gw.abs() + 1e-5 * scale).all())
    assert i.dtype == torch.int64 and torch.equal(i, iw)


@pytest.mark.cuda
@pytest.mark.parametrize("m,nl,nc", [(3, 300, 70), (2, 16384 + 77, 300),
                                     (16, 1000, 1024)])
def test_cuda_relu_colsum_matches_plain_bitwise(cuda_device, m, nl, nc):
  """The relu column-sum kernel equals its plain version in every bit (the
  same fixed order of additions) on ragged nl (several chunks and a tail),
  hole rows (zero rows with cov 0), pitched rows (a view of a wider
  buffer) and gathered columns; a column's bits in a gathered call equal
  its bits in the full pass; a bad column id gives NaN, not a read out of
  bounds."""
  from repro_torch.kernels import colsum
  r = np.random.default_rng(21)
  dev = cuda_device
  buf = torch.tensor(r.normal(size=(m, nl, nc + 5)), device=dev).float()
  s = buf[..., :nc]                                  # row pitch nc + 5
  holes = torch.tensor(r.uniform(size=(m, nl)) < 0.1, device=dev)
  s[holes] = 0.0
  cov = torch.tensor(np.abs(r.normal(size=(m, nl))), device=dev).float()
  cov[holes] = 0.0
  cols = torch.tensor(r.integers(0, nc, size=(m, 64)), device=dev)
  before = colsum.launches
  full = ops.relu_colsum(s, cov)
  got = ops.relu_colsum(s, cov, cols)
  assert colsum.launches == before + 2
  want = torch.clamp_min(s.double() - cov.double()[:, :, None], 0).sum(1)
  assert torch.equal(full, ref.relu_colsum_ref(s, cov))
  assert torch.equal(got, ref.relu_colsum_ref(s, cov, cols))
  _close(full, want.float(), 1e-5)
  assert torch.equal(got, torch.gather(full, 1, cols))
  bad = cols.clone()
  bad[0, 3] = nc
  out = ops.relu_colsum(s, cov, bad)
  assert bool(out[0, 3].isnan()) and not bool(out[1:].isnan().any())
  with pytest.raises(ValueError, match="cuda"):
    from repro_torch.kernels import dispatch
    dispatch.resolve("relu_colsum", "cuda")(s.cpu(), cov.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_fast_lazy_equals_standard(cuda_device, kernel):
  """The fast engine's lazy round 1 selects what its standard round 1
  selects, bit for bit (sel_gids, value, stage1_values), flat and through
  a two-level tree, with hole rows; it rescans, and every column pass
  went through the relu column-sum kernel.  ``tree_branch = m`` gives the
  flat merge's bits."""
  from repro_torch.core import greedi as TG
  r = np.random.default_rng(22)
  dev = cuda_device
  n, m = 8 * 2048, 8
  f = torch.tensor(r.normal(size=(n, 16)), device=dev).float()
  gids = torch.arange(n, device=dev)
  gids[::9] = -1
  kw = dict(m=m, kappa=16, k_final=16, kernel=kernel, gids=gids,
            kernel_kwargs=(("h", 2.0),) if kernel == "rbf" else ())
  for merge, b in (("flat", None), ("tree", 2)):
    ops.reset_launch_counts()
    std = TG.greedi_sharded_fast(f, merge=merge, tree_branch=b, **kw)
    lz = TG.greedi_sharded_fast(f, merge=merge, tree_branch=b, mode="lazy",
                                **kw)
    assert ops.launch_counts()["relu_colsum"] > 0
    assert torch.equal(std.sel_gids, lz.sel_gids), merge
    assert torch.equal(std.value, lz.value), merge
    assert torch.equal(std.stage1_values, lz.stage1_values), merge
    assert bool((lz.r1_rescans > 0).all())
    assert not bool((lz.sel_gids[lz.sel_valid] < 0).any())
  flat = TG.greedi_sharded_fast(f, **kw)
  tree = TG.greedi_sharded_fast(f, merge="tree", tree_branch=m, **kw)
  assert torch.equal(flat.sel_gids, tree.sel_gids)
  assert torch.equal(flat.value, tree.value)
  assert torch.equal(flat.stage1_values, tree.stage1_values)


@pytest.mark.cuda
def test_cuda_tree_and_hierarchical_run_on_the_kernels(cuda_device):
  """The generic tree merge and greedi_hierarchical on the card: valid,
  unique selections through the facility kernels, the same selection as
  the plain versions on the card (backend "ref")."""
  from repro_torch.core import greedi as TG
  from repro_torch.core import objectives as TO
  r = np.random.default_rng(23)
  dev = cuda_device
  f = torch.tensor(r.normal(size=(8 * 512, 16)), device=dev).float()
  f = f / f.norm(dim=1, keepdim=True)
  obj = TO.FacilityLocation()
  for run in (lambda be: TG.greedi_sharded(
                  f, m=8, kappa=8, k_final=8, objective=obj, merge="tree",
                  tree_branch=2, backend=be),
              lambda be: TG.greedi_hierarchical(
                  f, pods=2, per_pod=4, kappa=8, k_final=8, objective=obj,
                  backend=be)):
    ops.reset_launch_counts()
    got = run("auto")
    counts = ops.launch_counts()
    assert counts["facility_select"] > 0 and counts["facility_gain"] > 0
    want = run("ref")
    sel = got.sel_gids[got.sel_valid]
    assert len(set(sel.tolist())) == len(sel) == 8
    assert torch.equal(got.sel_gids, want.sel_gids)
    _close(got.value, want.value, 1e-5)


@pytest.mark.cuda
def test_cuda_service_and_cli_merge_tree(cuda_device, tmp_path, capsys):
  """SelectionService(merge="tree") and the CLI's --merge-tree on the card:
  b = m epochs select what the flat service selects; a two-level tree
  serves k unique ids; the CLI's tree run goes through the relu
  column-sum kernel and says merge=tree2 on the card."""
  from repro_torch.launch import select as cli
  from repro_torch.service import SelectionService
  r = np.random.default_rng(24)
  feats = torch.tensor(r.normal(size=(4096, 16)), device=cuda_device).float()
  mk = dict(m=8, d=16, kappa=8, k_final=8, capacity=4096)
  res = []
  for kw in ({}, dict(merge="tree", tree_branch=8),
             dict(merge="tree", tree_branch=2)):
    svc = SelectionService(**mk, **kw)
    svc.append(feats)
    res.append(svc.epoch())
  assert np.array_equal(res[0].sel_gids, res[1].sel_gids)
  sel = res[2].sel_gids
  assert sel.size == 8 and len(set(sel.tolist())) == 8
  ops.reset_launch_counts()
  out = tmp_path / "sel.npy"
  cli.main(["--n", "4096", "--d", "16", "--k", "8", "--mesh", "8",
            "--merge-tree", "2", "--no-coverage", "--out", str(out)])
  assert ops.launch_counts()["relu_colsum"] > 0
  done = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("[select] done")]
  assert "merge=tree2" in done[-1] and "device=cuda" in done[-1]
  sel = np.load(out)
  assert len(sel) == 8 and len(set(sel.tolist())) == 8


def _sieve_case(r, n_sh, ab, t, k, d, dev):
  """A chunk against S shards' part-filled sieves: duplicated rows, -1
  padding, rows split between the shards, a full bucket, empty ones."""
  rows = torch.tensor(r.normal(size=(ab, d)), device=dev).float()
  rows[1:3] = rows[0]
  gains = torch.tensor(np.abs(r.normal(size=ab)) * 3, device=dev).float()
  rgids = torch.arange(ab, device=dev) + 1000
  rgids[-3:] = -1
  active = torch.tensor(r.uniform(size=(n_sh, ab)) < 0.6, device=dev)
  tau = torch.tensor(np.exp((np.arange(t) - 3) * np.log1p(0.5)),
                     device=dev).float()
  cnt = torch.tensor(r.integers(0, k + 1, size=(n_sh, t)), device=dev)
  cnt[0, 0], cnt[0, 1] = k, 0
  slots = torch.arange(k, device=dev)
  live = slots < cnt[..., None]
  gid = torch.where(live, torch.arange(n_sh * t * k, device=dev).view(
      n_sh, t, k), -1)
  gain = torch.where(live, 1.0, 0.0)
  feat = torch.tensor(r.normal(size=(n_sh, t, k, d)), device=dev).float()
  feat = torch.where(live[..., None], feat, 0.0)
  return rows, gains, rgids, active, tau, gid, gain, feat, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("n_sh,ab,t,k,d", [(1, 64, 5, 8, 16),
                                           (2, 1024, 13, 64, 64),
                                           (3, 300, 4, 40, 22)])
def test_cuda_sieve_scan_equals_plain_bitwise(cuda_device, kernel, n_sh, ab,
                                              t, k, d):
  """The admission-scan kernel (csrc/sieve.cu) equals its plain version
  ``ref.sieve_scan_ref`` bit for bit on the same sweeps: intra-chunk
  admissions, a bucket that stays full and one that fills, inactive rows
  and -1 padding, 1 to 3 shards, k of 8 to 64 slots.  ``ops.sieve_update``
  equals the sweeps of the ``pairwise`` kernel into the plain scan, and
  launches the scan once."""
  from repro_torch.kernels import sieve as SV
  r = np.random.default_rng(30)
  dev = cuda_device
  rows, gains, rgids, active, tau, gid, gain, feat, cnt = _sieve_case(
      r, n_sh, ab, t, k, d, dev)
  s_pre = ops.pairwise(rows, feat.view(n_sh, t * k, d), kernel=kernel)
  s_intra = ops.pairwise(rows, rows, kernel=kernel)
  rsq, msq = (ref.sieve_norms(rows, feat) if kernel == "linear"
              else (None, None))
  args = (s_pre, s_intra, rsq, msq, gains, rgids, active, tau, gid, gain,
          cnt)
  before = SV.launches
  got = SV.sieve_scan(*args)
  assert SV.launches == before + 1
  want = ref.sieve_scan_ref(*args)
  for a, b in zip(got, want):
    assert torch.equal(a, b)
  assert bool((got[3] > cnt).any()) and bool((got[3][0, 0] == k))
  assert bool(((got[2] >= 0).sum(-1) >= 2).any())       # intra-chunk
  assert torch.equal(gid, args[8]) and torch.equal(cnt, args[10])
  feat_w = torch.where((want[2] >= 0)[..., None],
                       rows[want[2].clamp_min(0)], feat)
  upd = ops.sieve_update(rows, gains, rgids, active, tau, gid, gain, feat,
                         cnt, kernel=kernel)
  assert SV.launches == before + 2
  for a, b in zip(upd, (want[0], want[1], feat_w, want[3])):
    assert torch.equal(a, b)
  from repro_torch.kernels import dispatch
  with pytest.raises(ValueError, match="cuda"):
    dispatch.resolve("sieve_update", "cuda")(
        *(x.cpu() for x in (rows, gains, rgids, active, tau, gid, gain,
                            feat, cnt)))


@pytest.mark.cuda
def test_cuda_batched_selects_match_plain(cuda_device):
  """The three query-batched selects (B per-query states over one shared
  block, one launch each) against their plain versions on the card."""
  from repro_torch.kernels import dispatch
  r = np.random.default_rng(31)
  dev = cuda_device
  b, ne, nc, d, k = 6, 700, 500, 32, 8
  ev = torch.tensor(np.abs(r.normal(size=(ne, d))), device=dev).float()
  cd = torch.tensor(np.abs(r.normal(size=(nc, d))), device=dev).float()
  ok = torch.tensor(r.uniform(size=(b, nc)) > 0.3, device=dev)
  cov = torch.tensor(r.uniform(0, 2, size=(b, ne)), device=dev).float()
  mask = (torch.tensor(r.uniform(size=(b, ne)), device=dev) > 0.2).float()
  cap = torch.full((ne,), 3.0, device=dev)
  sel = torch.tensor(r.normal(size=(b, k, d)), device=dev).float() * 0.2
  kss = torch.exp(-torch.cdist(sel.double(), sel.double()) ** 2 / 0.75 ** 2)
  linv = torch.linalg.inv(torch.linalg.cholesky(
      kss + torch.eye(k, device=dev, dtype=torch.float64))).float()
  cases = (("facility_gain", (ev, cd, cov, mask, ok), {}),
           ("coverage_gain", (ev, cd, cov, cap, mask, ok), {}),
           ("info_gain_cond", (sel, linv, cd, ok), dict(kernel="rbf")))
  ops.reset_launch_counts()
  for name, args, kw in cases:
    best, idx = dispatch.resolve_select_batched(name, "cuda")(*args, **kw)
    wb, wi = dispatch.resolve_select_batched(name, "ref")(*args, **kw)
    assert best.shape == (b,) and torch.equal(idx, wi), name
    _close(best, wb, 2e-5)
  counts = ops.launch_counts()
  assert (counts["facility_select"], counts["coverage_select"],
          counts["info_select"]) == (1, 1, 1)


@pytest.mark.cuda
def test_cuda_service_query_path(cuda_device):
  """The facility service's query path on the card: the admission scan
  runs in every append chunk and adds no host sync to it; a query and a
  batch read back once a query tile; batched answers select what the
  requests select alone; the merge and the exact tier through the
  kernels select what the plain route selects."""
  import warnings

  from repro_torch.kernels import sieve as SV
  from repro_torch.service import CorpusStore, QueryRequest, SelectionService
  r = np.random.default_rng(32)
  x = torch.tensor(r.normal(size=(4096, 16)), device=cuda_device).float()
  x = x / x.norm(dim=1, keepdim=True)

  def syncs(fn):
    torch.cuda.set_sync_debug_mode("warn")
    try:
      with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    finally:
      torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)

  kw = dict(m=4, d=16, kappa=8, k_final=8, capacity=2048, append_block=256,
            seed=0)
  svc = SelectionService(**kw)
  plain = SelectionService(backend="ref", sieve=False, **kw)
  svc.append(x[:3000])
  plain.append(x[:3000])
  plain.append(x[3000:])
  before = SV.launches
  n_sync = syncs(lambda: svc.append(x[3000:]))
  assert SV.launches - before == -(-1096 // 256)
  assert n_sync == 0
  assert syncs(lambda: svc.query()) == 1
  base = svc.query().sel_gids
  reqs = [QueryRequest(k=1 + i % 8, seed=i % 3, exclude_gids=tuple(
      int(g) for g in base[:i % 4])) for i in range(20)]
  assert syncs(lambda: svc.query_batch(reqs[:10])) == 1
  batched = svc.query_batch(reqs)
  for rq, rb in zip(reqs, batched):
    rs = svc.query(rq.k, seed=rq.seed, exclude_gids=rq.exclude_gids or None)
    assert np.array_equal(rb.sel_gids, rs.sel_gids)
  st = svc.store
  ref_store = CorpusStore(m=4, d=16, maintainer=st._maintainer,
                          sieve_k=st.sieve_k, backend="ref")
  ref_store.set_sieve_state(st.sieve_state)
  assert np.array_equal(st.query_sieves()[0], ref_store.query_sieves()[0])
  ex = svc.query_batch(reqs[:6], tier="exact")
  ex_plain = plain.query_batch(reqs[:6], tier="exact")
  for a, b in zip(ex, ex_plain):
    assert np.array_equal(a.sel_gids, b.sel_gids)
    assert a.value_estimate == pytest.approx(b.value_estimate, rel=1e-5)


@pytest.mark.cuda
def test_cuda_append_from_pinned_memory_keeps_its_rows(cuda_device):
  """An append from a pinned host buffer has landed when it returns: the
  caller may overwrite the buffer at once, even with the stream busy, and
  the store holds the rows as they were."""
  from repro_torch.core import objectives as O
  from repro_torch.service import CorpusStore
  r = np.random.default_rng(33)
  rows = torch.tensor(r.normal(size=(1024, 16)), dtype=torch.float32)
  buf = rows.clone().pin_memory()
  st = CorpusStore(m=2, d=16, capacity=2048, append_block=256,
                   maintainer=O.bound_maintainer_for(O.FacilityLocation()),
                   sieve_k=8)
  busy = torch.randn(4096, 4096, device=cuda_device)
  for _ in range(8):
    busy = busy @ busy * 1e-3
  st.append(buf)
  buf.fill_(float("nan"))
  assert torch.equal(st.feats[:1024].cpu(), rows)


def _launch_calls(fn, n=3):
  """Host launch calls (``cudaLaunch*`` / ``cuLaunch*``) a call of ``fn``
  makes, read by torch.profiler over ``n`` calls after a warm-up call (the
  host's records are complete where the device's can drop)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as prof:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  calls = sum(e.device_type == DeviceType.CPU and e.name.startswith(
      ("cudaLaunch", "cuLaunch")) for e in prof.events())
  assert calls % n == 0, calls
  return calls // n


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kw,baseline", [
    ("linear", (), 0.0), ("rbf", (("h", 0.75),), 0.0),
    ("neg_sq_dist", (), -1.0)])
def test_cuda_facility_pre_gains_one_colsum_launch(cuda_device, kernel, kw,
                                                   baseline, monkeypatch):
  """FacilityLocationPre.gains on the card: one ``relu_colsum`` launch a
  call (the wrapper's count; the call's host launches are exactly those of
  one relu_colsum call beside its elementwise ops), equal in every bit to
  its plain version over the same cache; the fused similarities' cache is
  the ``pairwise`` kernel's block (the fast engine's ``s11`` bits)."""
  import dataclasses

  from repro_torch.core import objectives as O
  from repro_torch.kernels import colsum, dispatch
  r = np.random.default_rng(41)
  dev = cuda_device
  x = torch.tensor(r.normal(size=(3, 700, 64)), device=dev).float()
  x = x / x.norm(dim=-1, keepdim=True)
  mask = torch.tensor(r.uniform(size=(3, 700)) < 0.9, device=dev).float()
  obj = O.FacilityLocationPre(kernel=kernel, kernel_kwargs=kw,
                              baseline=baseline)
  st = obj.init(x, mask, x)
  if kernel != "neg_sq_dist":
    assert torch.equal(st.sim, ops.pairwise(x, x, kernel=kernel, h=0.75))
  for i in (5, 300):
    st = obj.update(st, x[:, i])
  plain = dataclasses.replace(obj, backend="ref")
  before = colsum.launches
  g = obj.gains(st, x)
  assert colsum.launches == before + 1
  assert torch.equal(g, plain.gains(st, x))
  cov = torch.where(st.eval_mask > 0, st.cov, torch.inf)
  n_colsum = _launch_calls(lambda: ops.relu_colsum(st.sim, cov))
  assert n_colsum == 1 + (colsum.chunks(700) > 1)
  n_gains = _launch_calls(lambda: obj.gains(st, x))
  resolve = dispatch.resolve
  monkeypatch.setattr(dispatch, "resolve", lambda name, backend="auto": (
      (lambda s, c: torch.empty(s.shape[0], s.shape[2], device=s.device))
      if name == "relu_colsum" else resolve(name, backend)))
  n_rest = _launch_calls(lambda: obj.gains(st, x))
  assert n_gains - n_rest == n_colsum


@pytest.mark.cuda
def test_cuda_generic_neg_sq_dist_gains_match_the_cpu(cuda_device):
  """The generic path on the card (cuBLAS blocks, the ``relu_colsum``
  kernel for facility location) within 1e-5 of the plain CPU version, for
  the four objectives over a batch of partitions.  Rows of norm about 0.3
  keep the information-gain and DPP conditional variances off their 1e-12
  floor, where the log turns an ulp of cond into 1e-4 of gain."""
  from repro_torch.core import objectives as O
  from repro_torch.kernels import colsum
  r = np.random.default_rng(42)
  x = (r.normal(size=(4, 900, 32)) * 0.05).astype(np.float32)
  c = (r.normal(size=(4, 300, 32)) * 0.05).astype(np.float32)
  mask = (r.uniform(size=(4, 900)) < 0.9).astype(np.float32)
  objs = (O.FacilityLocation(kernel="neg_sq_dist", baseline=-0.05),
          O.SaturatedCoverage(kernel="neg_sq_dist"),
          O.InformationGain(k_max=6, kernel="neg_sq_dist", kernel_kwargs=()),
          O.LogDetDPP(k_max=6, kernel="neg_sq_dist", kernel_kwargs=(),
                      jitter=1.0))
  for obj in objs:
    gains = []
    for dev in ("cpu", cuda_device):
      xt, ct = torch.tensor(x, device=dev), torch.tensor(c, device=dev)
      if isinstance(obj, (O.InformationGain, O.LogDetDPP)):
        st = obj.broadcast(obj.init_d(32, device=dev), 4)
      else:
        st = obj.init(xt, torch.tensor(mask, device=dev))
      for i in (3, 50):
        st = obj.update(st, xt[:, i])
      before = colsum.launches
      gains.append(obj.gains(st, ct).cpu())
      if dev != "cpu" and isinstance(obj, O.FacilityLocation):
        assert colsum.launches == before + 1
    _close(gains[1], gains[0], 1e-5)


@pytest.mark.cuda
def test_cuda_service_obs_off_no_sync_an_append_chunk(cuda_device):
  """With obs off an append chunk makes no host sync and a query one; with
  obs on the device-fed series reach the registry (each chunk's
  diagnostics read once) and the selection is the same."""
  import warnings

  from repro_torch import obs
  from repro_torch.service import SelectionService
  r = np.random.default_rng(43)
  x = torch.tensor(r.normal(size=(4096, 16)), device=cuda_device).float()
  x = x / x.norm(dim=1, keepdim=True)

  def syncs(fn):
    torch.cuda.set_sync_debug_mode("warn")
    try:
      with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    finally:
      torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)

  kw = dict(m=4, d=16, kappa=8, k_final=8, capacity=4096, append_block=256,
            seed=0)
  sels = []
  for on in (False, True):
    obs.REGISTRY.reset()
    if on:
      obs.enable()
    try:
      svc = SelectionService(**kw)
      svc.append(x[:2048])
      n_sync = syncs(lambda: svc.append(x[2048:]))
      q_sync = syncs(lambda: svc.query())
      sels.append(svc.epoch().sel_gids.tolist())
      snap = obs.REGISTRY.snapshot()
    finally:
      obs.disable()
    if on:
      assert n_sync == 2048 // 256
      assert snap["repro_sieve_admissions_total"]["series"][0]["value"] > 0
      assert len(snap["repro_epoch_eval_mass"]["series"]) == 4
    else:
      assert n_sync == 0 and q_sync == 1
      assert "repro_sieve_admissions_total" not in snap
  assert sels[0] == sels[1]


def _reduced_lm(dtype="float32"):
  import dataclasses

  from repro_torch import configs
  return dataclasses.replace(configs.reduced(configs.get_config("qwen3-4b")),
                             dtype=dtype)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
  """Two reduced train steps (qwen3-4b, float32, remat "dots") on the card
  against the same steps on the CPU from the same weights and batches:
  loss, grad norm and lr within 1e-5 relative, parameters within 2 x lr
  per element and 99.9 % of them within 1e-5; no flash launch (attention
  under autograd runs chunked_attention)."""
  from repro_torch.data.pipeline import SyntheticLM
  from repro_torch.models import Model
  from repro_torch.train import OptConfig, init_opt_state, make_train_step
  cfg = _reduced_lm()
  cpu = Model(cfg, device="cpu")
  card = Model(cfg, device=cuda_device)
  card.load_state_dict(cpu.state_dict())
  data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=4,
                     device="cpu")
  ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
  steps = {"cpu": make_train_step(cpu, ocfg),
           "card": make_train_step(card, ocfg)}
  opts = {"cpu": init_opt_state(cpu), "card": init_opt_state(card)}
  for i in range(2):
    batch = data.batch(i)
    want = steps["cpu"](opts["cpu"], batch)
    ops.reset_launch_counts()
    got = steps["card"](opts["card"], {k: v.to(cuda_device)
                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    for key in ("loss", "grad_norm", "lr"):
      np.testing.assert_allclose(float(got[key]), float(want[key]),
                                 rtol=1e-5, err_msg=key)
    lr = float(want["lr"])
    far = total = 0
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
      d = (p.detach().cpu() - q.detach()).abs()
      assert float(d.max()) <= 2 * lr, (i, name, float(d.max()))
      far += int((d > 1e-5).sum())
      total += d.numel()
    assert far <= 1e-3 * total, (i, far, total)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_eval_step_kernel_path_matches_plain(cuda_device, dtype):
  """The eval step (no_grad) launches the flash kernel once a layer (the
  tensor-core kernel for bf16) and its loss holds the backend="ref" run's
  (no launch): 1e-5 relative in float32, 2e-2 absolute in bf16."""
  from repro_torch.data.pipeline import SyntheticLM
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.models import Model
  from repro_torch.train import make_eval_step
  cfg = _reduced_lm(dtype)
  model = Model(cfg, device=cuda_device)
  batch = SyntheticLM(vocab=cfg.vocab, seq_len=200, global_batch=4,
                      device=str(cuda_device)).batch(0)
  step = make_eval_step(model)
  losses = {}
  for backend in ("auto", "ref"):
    model.backend = backend
    ops.reset_launch_counts()
    losses[backend] = float(step(batch)["loss"])
    launched = ops.launch_counts()["flash_attention"]
    assert launched == (cfg.n_layers if backend == "auto" else 0)
    if backend == "auto":
      assert fa.tc_launches == (cfg.n_layers if dtype == "bfloat16" else 0)
  if dtype == "float32":
    np.testing.assert_allclose(losses["auto"], losses["ref"], rtol=1e-5)
  else:
    assert abs(losses["auto"] - losses["ref"]) <= 2e-2


FAMILIES = ("deepseek-moe-16b", "grok-1-314b", "mamba2-2.7b",
            "recurrentgemma-2b", "llama-3.2-vision-90b", "whisper-tiny")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_families_kernel_route_matches_plain(cuda_device, arch, dtype):
  """Every other family at the reduced size on the card: the prefill with
  the flash kernel (one launch a causal, unwindowed attention layer: the
  MoE, VLM and whisper decoder layers; none for Mamba-2 or the windowed
  RecurrentGemma) against ``backend="ref"`` (no launch) on the same
  weights, last-token logits within 1e-4 (f32) or 3e-2 (bf16) of their
  scale; greedy tokens through ``generate`` equal in float32; decode
  against teacher forcing within 2e-3 in float32."""
  import dataclasses

  from repro_torch import configs
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.models import Model
  from repro_torch.serve import generate
  cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                            dtype=dtype)
  model = Model(cfg, device=cuda_device,
                generator=torch.Generator(device=cuda_device).manual_seed(3))
  g = torch.Generator(device=cuda_device).manual_seed(4)
  b, s, steps = 2, 40, 4
  batch = {"tokens": torch.randint(0, cfg.vocab, (b, s + steps), generator=g,
                                   device=cuda_device)}
  if cfg.family == "encdec":
    batch["frames"] = torch.randn(b, cfg.encoder.n_frames, cfg.d_model,
                                  generator=g, device=cuda_device)
  if cfg.family == "vlm":
    batch["img_embeds"] = torch.randn(b, cfg.n_img_tokens, cfg.d_model,
                                      generator=g, device=cuda_device)
  prompt = dict(batch, tokens=batch["tokens"][:, :s])
  flash_layers = 0 if cfg.sliding_window else sum(
      bt in ("attn", "cross") for bt in cfg.full_pattern)
  last, toks = {}, {}
  for backend in ("auto", "ref"):
    model.backend = backend
    ops.reset_launch_counts()
    tc0 = fa.tc_launches
    mem = model.memory(prompt)
    last[backend], _ = model.prefill(prompt, model.init_cache(
        b, s + steps, memory=mem))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == (
        flash_layers if backend == "auto" else 0), backend
    assert fa.tc_launches - tc0 == (
        flash_layers if backend == "auto" and dtype == "bfloat16" else 0)
    toks[backend] = generate(model, prompt, steps=steps)
  tol = 1e-4 if dtype == "float32" else 3e-2
  scale = float(last["ref"].float().abs().max())
  assert float((last["auto"].float() - last["ref"].float()).abs().max()) \
      <= tol * scale
  if dtype == "bfloat16":
    return
  assert torch.equal(toks["auto"], toks["ref"])
  model.backend = "auto"
  with torch.no_grad():
    train, _ = model.apply_train(batch)
  caches = model.init_cache(b, s + steps, memory=model.memory(prompt))
  got, caches = model.prefill(prompt, caches)
  _close(got, train[:, s - 1], 2e-3)
  for t in range(s, s + steps):
    got, caches = model.decode_step(batch["tokens"][:, t:t + 1], t, caches)
    _close(got, train[:, t], 2e-3)


# one rank of test_cuda_service_over_ranks_matches_stacked (under torchrun,
# gloo, every rank on the current card); rank 0 also runs every call
# stacked
SERVICE_RANK = r'''
import sys

import numpy as np
import torch

from repro_torch import no_tf32
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.service import QueryRequest, SelectionService

no_tf32()
mesh = ProcessMesh.from_env(4, "gloo", "cuda")
r = np.random.default_rng(33)
x = r.normal(size=(1500, 16))
f = torch.tensor(x / np.linalg.norm(x, axis=1, keepdims=True),
                 dtype=torch.float32, device=mesh.device)


def run(svc, out):
  for i, (lo, hi) in enumerate(((0, 300), (300, 1100), (1100, 1500))):
    svc.append(f[lo:hi])
    q = svc.query()
    out[f"q{i}"] = q.sel_gids
    out[f"v{i}"] = np.array(q.value_estimate)
    reqs = [QueryRequest(k=1 + j % 8, seed=j % 3, exclude_gids=tuple(
        int(g) for g in q.sel_gids[:j % 3])) for j in range(6)]
    for j, a in enumerate(svc.query_batch(reqs)):
      out[f"b{i}_{j}"] = a.sel_gids
    for g, x in enumerate(svc.store.sieve_state):
      out[f"s{i}_{g}"] = x.cpu().numpy()
    if i:
      svc.board.beat()
      if i == 2:
        for s in (2, 3):
          if s in svc.board.shards:
            svc.board.fail(s)
      e = svc.epoch()
      out[f"e{i}"], out[f"a{i}"] = e.sel_gids, e.stats.alive
      out[f"f{i}"] = np.array(e.stats.value)
  for j, a in enumerate(svc.query_batch([3, 8], tier="exact")):
    out[f"x{j}"] = a.sel_gids
    out[f"xv{j}"] = np.array(a.value_estimate)


kw = dict(m=4, d=16, kappa=8, k_final=8, capacity=256, append_block=128,
          seed=0, deadline=60.0)
ops.reset_launch_counts()
mine, stacked = {}, {}
run(SelectionService(mesh=mesh, **kw), mine)
mine["launches"] = np.array([ops.launch_counts()[k] for k in (
    "pairwise", "sieve_admit", "facility_gain", "facility_select")])
mine["exchanges"] = np.array(mesh.exchanges)
if mesh.rank == 0:
  run(SelectionService(**kw), stacked)
  np.savez(f"{sys.argv[1]}/stacked.npz", **stacked)
np.savez(f"{sys.argv[1]}/rank{mesh.rank}.npz", **mine)
mesh.close()
'''


@pytest.mark.cuda
def test_cuda_service_over_ranks_matches_stacked(cuda_device, tmp_path):
  """The selection service over 2 gloo ranks on the card (2 shards a
  rank): appends across growths, a query and a heterogeneous batch after
  each, the sieve state, warm epochs with rank 1's shards failed before
  the last, and the exact tier: every answer the stacked service's on
  the card, bit for bit, with the kernels launched inside the ranks and
  rows moved through the exchange."""
  import os
  import subprocess
  import sys
  script = tmp_path / "rank.py"
  script.write_text(SERVICE_RANK)
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
  run = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2", str(script), str(tmp_path)], env=env,
      capture_output=True, text=True, timeout=600)
  assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
  stacked = dict(np.load(tmp_path / "stacked.npz"))
  assert stacked["a2"].tolist() == [True, True, False, False]
  for rank in range(2):
    got = dict(np.load(tmp_path / f"rank{rank}.npz"))
    for k, want in stacked.items():
      np.testing.assert_array_equal(got[k], want, err_msg=f"rank {rank} {k}")
    assert (got["launches"][:3] > 0).all(), got["launches"]
    assert got["exchanges"] > 0


@pytest.mark.cuda
def test_cuda_rank_sums_do_not_depend_on_the_batch(cuda_device):
  """What a rank of a process mesh computes for its m / world partitions
  is the stacked call's, bit for bit: the facility / coverage gains of 4
  partitions under ``plan_for_parts(4)`` equal the first 4 of a 16
  partition call (without it the eval-chunk plan, and the bits, differ),
  and ``objectives._row_sum`` of 4 rows of 16384 equals theirs in a batch
  of 16 (``torch.sum`` splits a row by the tensor's shape)."""
  from repro_torch.core import objectives as O
  from repro_torch.kernels import facility_gain as FG
  g = torch.Generator(device=cuda_device).manual_seed(3)
  ev = torch.randn((16, 16384, 64), generator=g, device=cuda_device) / 8
  cov = torch.rand((16, 16384), generator=g, device=cuda_device) * 0.3
  mask = torch.ones((16, 16384), device=cuda_device)
  cand = torch.randn((16, 256, 64), generator=g, device=cuda_device) / 8
  want = ops.facility_gain(ev, cand, cov, mask)[:4]
  assert not torch.equal(ops.facility_gain(ev[:4], cand[:4], cov[:4],
                                           mask[:4]), want)
  with FG.plan_for_parts(4):
    got = ops.facility_gain(ev[:4], cand[:4], cov[:4], mask[:4])
    cover = ops.coverage_gain(ev[:4], cand[:4], cov[:4], 3 * cov[:4],
                              mask[:4])
  assert torch.equal(got, want)
  assert torch.equal(cover, ops.coverage_gain(ev, cand, cov, 3 * cov,
                                              mask)[:4])
  x = torch.rand((16, 16384), generator=g, device=cuda_device)
  assert torch.equal(O._row_sum(x[:4]), O._row_sum(x)[:4])
  np.testing.assert_allclose(O._row_sum(x).cpu().numpy(),
                             x.double().sum(-1).cpu().numpy(), rtol=1e-6)


# one rank of test_cuda_family_model_axis_step (under torchrun, gloo, both
# ranks on the current card); rank 0 also runs one process
FAMILY_TP_RANK = r'''
import sys

import numpy as np
import torch

from repro_torch import no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch.mesh import TrainMesh
from repro_torch.models import Model, Parallelism
from repro_torch.train import OptConfig, init_opt_state, make_train_step

no_tf32()
arch, ep = sys.argv[2], sys.argv[3] == "ep"
mesh = TrainMesh.from_env((1, 2), "gloo", "cuda")
dev = mesh.device
cfg = reduced(get_config(arch))
g = torch.Generator(device=dev).manual_seed(4)
toks = torch.randint(0, cfg.vocab, (2, 33), generator=g, device=dev)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "mask": torch.ones(2, 32, device=dev)}
if cfg.family == "encdec":
  batch["frames"] = torch.randn(2, cfg.encoder.n_frames, cfg.d_model,
                                generator=g, device=dev)
if cfg.family == "vlm":
  batch["img_embeds"] = torch.randn(2, cfg.n_img_tokens, cfg.d_model,
                                    generator=g, device=dev)
out = {}
for tag, m in (("mesh", mesh), ("one", None)):
  if tag == "one" and mesh.rank:
    break
  par = None if not ep else Parallelism(ep=True) if m is None else \
      Parallelism(dp_axes=("data",), dp_size=1, model_size=2, ep=True)
  model = Model(cfg, device=dev, mesh=m, par=par,
                generator=torch.Generator(device=dev).manual_seed(3))
  ops.reset_launch_counts()
  mem = model.memory(batch)
  last, _ = model.prefill(batch, model.init_cache(2, 32, memory=mem), mem)
  out[f"{tag}/flash"] = np.array(ops.launch_counts()["flash_attention"])
  out[f"{tag}/prefill"] = last.cpu().numpy()
  met = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=10))(
      init_opt_state(model), batch)
  out[f"{tag}/loss"] = met["loss"].cpu().numpy()
  out[f"{tag}/grad_norm"] = met["grad_norm"].cpu().numpy()
  params = {n: (p if m is None else m.whole(p, model.specs[n]))
            for n, p in model.state_dict().items()}
  for n, p in params.items():
    out[f"{tag}/param/{n}"] = p.cpu().numpy()
np.savez(f"{sys.argv[1]}/rank{mesh.rank}.npz", **out)
mesh.close()
'''


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layout", [("mamba2-2.7b", "tp"),
                                         ("deepseek-moe-16b", "ep"),
                                         ("whisper-tiny", "tp")])
def test_cuda_family_model_axis_step(cuda_device, tmp_path, arch, layout):
  """A family at the reduced size in float32 over ``--mesh 1x2`` (2 gloo
  ranks on the card): the prefill at the rank's heads (the flash kernel
  once a causal, unwindowed layer) and one train step against one process
  on the card: logits, loss and grad norm within 1e-5 of their scale,
  every parameter after the step within 2 x lr, both ranks' whole leaves
  the same bits."""
  import os
  import subprocess
  import sys
  script = tmp_path / "rank.py"
  script.write_text(FAMILY_TP_RANK)
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
  run = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2", str(script), str(tmp_path), arch, layout],
      env=env, capture_output=True, text=True, timeout=600)
  assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
  got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
  one = {k[len("one/"):]: v for k, v in got[0].items()
         if k.startswith("one/")}
  layers = {"mamba2-2.7b": 0, "deepseek-moe-16b": 2, "whisper-tiny": 2}
  assert int(got[0]["mesh/flash"]) == int(one["flash"]) == layers[arch]
  for k in ("prefill", "loss", "grad_norm"):
    _close(torch.tensor(got[0][f"mesh/{k}"]), torch.tensor(one[k]), 1e-5)
  for k, want in one.items():
    if k.startswith("param/"):
      np.testing.assert_allclose(got[0][f"mesh/{k}"], want, rtol=0,
                                 atol=2e-3, err_msg=k)
      np.testing.assert_array_equal(got[0][f"mesh/{k}"],
                                    got[1][f"mesh/{k}"], err_msg=k)


LAYOUTS_RANK = r'''
import sys

import numpy as np
import torch

from repro_torch import no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import TrainMesh
from repro_torch.models import Model
from repro_torch.models.registry import mesh_parallelism
from repro_torch.models.transformer import KVSplit
from repro_torch.train import OptConfig, init_opt_state, make_train_step

no_tf32()
out = sys.argv[1]
base = TrainMesh.from_env((2, 1), "gloo", "cuda")
rank = base.rank
res = {}
for dev in ("cuda", "cpu"):
  mesh = TrainMesh.over(2, 1, rank, torch.device(dev), "gloo")
  g = torch.Generator().manual_seed(4)
  x = (torch.randn(6, 10, generator=g) + rank).to(dev)
  for dt in (torch.float32, torch.bfloat16):
    t = x.to(dt)
    res[f"{dev}/rs/{dt}"] = mesh.dp.reduce_scatter(t, dim=0, div=2).float(
        ).cpu().numpy()
    res[f"{dev}/ag/{dt}"] = mesh.dp.all_gather(t, dim=1).float().cpu().numpy()
    res[f"{dev}/a2a/{dt}"] = mesh.dp.all_to_all(t).float().cpu().numpy()
cfg = reduced(get_config("qwen3-4b"))
oc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
toks = torch.tensor(np.random.default_rng(2).integers(
    0, cfg.vocab, size=(4, 17)), device="cuda")
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "mask": torch.ones(4, 16, device="cuda")}
mine = {k: v[rank * 2:(rank + 1) * 2] for k, v in batch.items()}
mesh = TrainMesh.over(2, 1, rank, torch.device("cuda"), "gloo")
for tag, kw in (("plain", {}), ("fsdp", dict(fsdp=True, min_fsdp_size=1))):
  m = Model(cfg, device="cuda", mesh=mesh,
            par=mesh_parallelism(cfg, mesh, **kw))
  opt = init_opt_state(m)
  met = make_train_step(m, oc)(opt, mine)
  res[f"{tag}/loss"] = met["loss"].cpu().numpy()
  for n, p in m.state_dict().items():
    res[f"{tag}/param/{n}"] = mesh.whole(p, m.specs[n]).clone().cpu().numpy()
for arch, s, steps in (("qwen3-4b", 12, 6), ("recurrentgemma-2b", 20, 24)):
  cfg = reduced(get_config(arch))
  t = torch.tensor(np.random.default_rng(1).integers(
      0, cfg.vocab, size=(1, s + steps)), device="cuda")
  for who, msh in (("one", None), ("split", mesh)):
    m = Model(cfg, device="cuda", mesh=msh)
    caches = m.init_cache(1, s + steps, kv_split=None if msh is None
                          else KVSplit(msh.dp))
    lg, caches = m.prefill({"tokens": t[:, :s]}, caches)
    got = [lg]
    for j in range(steps):
      lg, caches = m.decode_step(t[:, s + j:s + j + 1], s + j, caches)
      got.append(lg)
    res[f"decode/{arch}/{who}"] = torch.stack(got).cpu().numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
base.close()
'''


@pytest.mark.cuda
def test_cuda_layouts_split_decode_and_fsdp(cuda_device, tmp_path):
  """2 gloo ranks on the card: the mesh's reduce-scatter, gather and
  all-to-all on CUDA tensors equal their CPU results bit for bit (float32
  and bf16); a 2x1 FSDP train step on the card equals the 2x1 step
  without it bit for bit (reduced qwen3-4b, float32); the batch-1 decode
  with the cache split by length over the 2 data ranks within 1e-5 of one
  process on the card (reduced qwen3-4b, recurrentgemma-2b past its
  window)."""
  import os
  import subprocess
  import sys
  script = tmp_path / "rank.py"
  script.write_text(LAYOUTS_RANK)
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
  run = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2", str(script), str(tmp_path)], env=env,
      capture_output=True, text=True, timeout=600)
  assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
  for r in range(2):
    got = dict(np.load(tmp_path / f"rank{r}.npz"))
    for k, v in got.items():
      if k.startswith("cuda/"):
        np.testing.assert_array_equal(v, got["cpu/" + k[len("cuda/"):]],
                                      err_msg=k)
      if k.startswith("plain/"):
        np.testing.assert_array_equal(got["fsdp/" + k[len("plain/"):]], v,
                                      err_msg=k)
      if k.startswith("decode/") and k.endswith("/split"):
        _close(torch.tensor(v), torch.tensor(got[k[:-len("split")] + "one"]),
               1e-5)
