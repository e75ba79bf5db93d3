"""The port's standing threshold sieves (``repro_torch.kernels.ref`` sieve
plain versions, ``ops.sieve_update``, the store's sieve state and its
epoch reset) against the reference's on the same numpy inputs.

Ids and counts must be equal and gains within 1e-6 relative: the two sides
compute the similarity sweeps with different matrix products, so a gain
can differ in its last bits, and an admission could flip only where a
score sits within such a difference of its threshold (none do on these
inputs).  At m = 4 the port sums the bound pass's shard partials in
another order than the reference's psum, so the state is compared where
no admission is within 1e-6 of its threshold, and the merged answer's f(S)
otherwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as JO  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.service import CorpusStore as JStore  # noqa: E402
from repro.util import make_mesh  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.service import CorpusStore as TStore  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

D, K, AB = 16, 8, 64
H = 1.5


def _unit(seed, n, d=D):
  r = np.random.default_rng(seed)
  x = r.normal(size=(n, d))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _kw(kernel):
  return (("h", H),) if kernel == "rbf" else ()


def _stores(kernel, m=1, capacity=128):
  kw = _kw(kernel)
  jm = JO.bound_maintainer_for(JO.FacilityLocation(kernel=kernel,
                                                   kernel_kwargs=kw))
  tm = TO.bound_maintainer_for(TO.FacilityLocation(kernel=kernel,
                                                   kernel_kwargs=kw))
  js = JStore(make_mesh((m,), ("data",)), d=D, capacity=capacity,
              append_block=AB, kernel=kernel, kernel_kwargs=kw,
              maintainer=jm, sieve_k=K)
  ts = TStore(m=m, d=D, capacity=capacity, append_block=AB, kernel=kernel,
              kernel_kwargs=kw, maintainer=tm, sieve_k=K, device="cpu")
  return js, ts


def _assert_state(a, b):
  """Host sieve states (gid, gain, feat, count, delta, jtop) alike."""
  np.testing.assert_array_equal(a[0], b[0])
  np.testing.assert_allclose(b[1], a[1], rtol=1e-6, atol=1e-7)
  np.testing.assert_array_equal(a[2], b[2])
  np.testing.assert_array_equal(a[3], b[3])
  np.testing.assert_allclose(b[4], a[4], rtol=1e-6)
  np.testing.assert_array_equal(a[5], b[5])


def _chunk(seed, t, k, ab=AB, d=D):
  """An append chunk against a part-filled sieve: a duplicated row (an
  intra-chunk admission makes the copy redundant), gid -1 padding, inactive
  rows, one full bucket and one empty one."""
  r = np.random.default_rng(seed)
  rows = r.normal(size=(ab, d)).astype(np.float32)
  rows[9] = rows[4]
  gains = (np.abs(r.normal(size=ab)) * 3).astype(np.float32)
  rgids = np.arange(100, 100 + ab).astype(np.int64)
  rgids[-5:] = -1
  active = r.uniform(size=ab) > 0.2
  tau = np.exp((np.arange(t) - 3) * np.log1p(0.5)).astype(np.float32)
  cnt = np.array([k, 3, 0, 1, k - 1, 2][:t], np.int64)
  gid = np.full((t, k), -1, np.int64)
  gain = np.zeros((t, k), np.float32)
  feat = np.zeros((t, k, d), np.float32)
  for b in range(t):
    for j in range(cnt[b]):
      gid[b, j] = 10 * b + j
      gain[b, j] = 1.0
      feat[b, j] = r.normal(size=d)
  return rows, gains, rgids, active, tau, gid, gain, feat, cnt


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_sieve_update_matches_reference(kernel, backend):
  """``ops.sieve_update`` (the registered oracle, through the scan
  wrapper's plain version or the whole plain version) against the
  reference's ``sieve_update(force_xla=True)``: intra-chunk admissions,
  a bucket that fills, inactive rows and -1 padding."""
  args = _chunk(1, 6, K)
  want = jops.sieve_update(*(jnp.asarray(a.astype(np.int32)
                                         if a.dtype == np.int64 else a)
                             for a in args), kernel=kernel, h=H,
                           force_xla=True)
  fn = dispatch.resolve("sieve_update", backend)
  got = fn(*(torch.as_tensor(a) for a in args), kernel=kernel, h=H)
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                             rtol=1e-6, atol=1e-7)
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
  np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
  cnt0 = args[-1]
  assert (got[3].numpy() > cnt0).sum() >= 3       # rows were admitted
  assert got[3].numpy()[0] == K                   # the full bucket stayed
  gids = got[0].numpy()
  assert not np.isin(np.arange(100, 100 + AB)[~args[3]], gids).any()
  assert 104 in gids and 109 not in gids          # the copy is redundant


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_sieve_refs_match_reference_and_row_by_row(kernel):
  """``sieve_redundancy_ref`` / ``sieve_admit_ref`` against the
  reference's, and the chunk scan (stacked over two shards, ``active``
  per shard) equal to feeding the rows one at a time through
  ``sieve_admit_ref``."""
  rows, gains, rgids, active, tau, gid, gain, feat, cnt = _chunk(2, 5, 4)
  live = np.arange(4)[None, :] < cnt[:, None]
  want = jref.sieve_redundancy_ref(jnp.asarray(rows[0]), jnp.asarray(feat),
                                   jnp.asarray(live), kernel=kernel, h=H)
  got = ref.sieve_redundancy_ref(torch.as_tensor(rows[0]),
                                 torch.as_tensor(feat),
                                 torch.as_tensor(live), kernel=kernel, h=H)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-7)
  j = jref.sieve_admit_ref(jnp.asarray(rows[0]), jnp.float32(gains[0] * 9),
                           jnp.int32(rgids[0]), jnp.asarray(True),
                           jnp.asarray(tau), jnp.asarray(gid.astype(np.int32)),
                           jnp.asarray(gain), jnp.asarray(feat),
                           jnp.asarray(cnt.astype(np.int32)), kernel=kernel,
                           h=H)
  t = ref.sieve_admit_ref(torch.as_tensor(rows[0]), float(gains[0] * 9),
                          int(rgids[0]), True, torch.as_tensor(tau),
                          torch.as_tensor(gid), torch.as_tensor(gain),
                          torch.as_tensor(feat), torch.as_tensor(cnt),
                          kernel=kernel, h=H)
  np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
  np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
  np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6)
  # two shards stacked, each with its own active rows
  act2 = np.stack([active, ~active])
  st = [torch.as_tensor(np.stack([x, x])) for x in (gid, gain, feat, cnt)]
  out = ops.sieve_update(torch.as_tensor(rows), torch.as_tensor(gains),
                         torch.as_tensor(rgids), torch.as_tensor(act2),
                         torch.as_tensor(tau), *st, kernel=kernel, h=H)
  for s in range(2):
    seq = [torch.as_tensor(x) for x in (gid, gain, feat, cnt)]
    for i in range(AB):
      seq = ref.sieve_admit_ref(torch.as_tensor(rows[i]), float(gains[i]),
                                int(rgids[i]), bool(act2[s, i]),
                                torch.as_tensor(tau), *seq, kernel=kernel,
                                h=H)
    torch.testing.assert_close(out[0][s], seq[0], rtol=0, atol=0)
    torch.testing.assert_close(out[3][s], seq[3], rtol=0, atol=0)
    torch.testing.assert_close(out[1][s], seq[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(out[2][s], seq[2], rtol=0, atol=0)


def test_sieve_admission_semantics():
  """Hand-checkable single admissions: thresholds gate the discounted
  score, a duplicate is fully redundant, an orthogonal item is not, and
  inactive or gid -1 rows never land."""
  t, k, d = 3, 2, 4
  tau = torch.tensor([1.0, 4.0, 16.0])
  st = (torch.full((t, k), -1, dtype=torch.int64), torch.zeros((t, k)),
        torch.zeros((t, k, d)), torch.zeros((t,), dtype=torch.int64))
  v = torch.tensor([1.0, 0.0, 0.0, 0.0])
  s1 = ref.sieve_admit_ref(v, 5.0, 7, True, tau, *st)
  assert s1[3].tolist() == [1, 1, 0] and s1[0][:, 0].tolist() == [7, 7, -1]
  s2 = ref.sieve_admit_ref(v, 5.0, 8, True, tau, *s1)
  assert s2[3].tolist() == [1, 1, 0]
  u = torch.tensor([0.0, 1.0, 0.0, 0.0])
  s3 = ref.sieve_admit_ref(u, 5.0, 9, True, tau, *s2)
  assert s3[3].tolist() == [2, 2, 0]
  for act, gid in ((False, 10), (True, -1)):
    s4 = ref.sieve_admit_ref(u, 99.0, gid, act, tau, *s3)
    assert s4[3].tolist() == s3[3].tolist()


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_store_sieve_state_matches_reference(kernel):
  """One shard: appends with growths between and a chunk of rows 40 x
  larger (Delta grows, the grid top moves up, the buckets roll), then the
  epoch reset seeded with three rows: the state as the reference's."""
  js, ts = _stores(kernel)
  f = _unit(3, 300)
  for part in (f[:100], f[100:250], f[250:] * 40.0):
    js.append(part)
    ts.append(part)
    _assert_state(js.sieve_state_host(), ts.sieve_state_host())
  assert ts.growths == js.growths == 2
  assert ts.sieve_thresholds == js.sieve_thresholds == 8
  a = js.sieve_state_host()
  assert a[3].sum() > 0 and a[5][0] > 0
  sel = np.array([3, 120, 260])
  js.reset_sieves(f[sel], sel.astype(np.int32))
  ts.reset_sieves(f[sel], sel)
  _assert_state(js.sieve_state_host(), ts.sieve_state_host())
  assert ts.sieve_state_host()[3].sum() > 0


def test_store_sieve_growth_and_corpus_block():
  """Growth leaves the sieve state bit for bit, and a merge reads only
  the sieve state: poisoning the block, its ids and its table after the
  appends changes no answer."""
  _, ts = _stores("linear")
  ts.append(_unit(4, 128))
  before = ts.sieve_state_host()
  g0, s0 = ts.query_sieves()
  ts.reserve(512)
  assert ts.growths >= 2
  for a, b in zip(before, ts.sieve_state_host()):
    np.testing.assert_array_equal(a, b)
  ts._feats = ts._gids = ts._table = None
  g1, s1 = ts.query_sieves()
  np.testing.assert_array_equal(g0, g1)
  np.testing.assert_array_equal(s0, s1)
  live = g0[g0 >= 0]
  assert len(g0) == K and len(live) > 0 and len(set(live.tolist())) == len(
      live)


@pytest.mark.parametrize("maintainer", ["none", "info_gain"])
def test_store_sieve_needs_a_sum_form_maintainer(maintainer):
  """No maintainer, or one without sum-form gains: no sieve, and the
  store still appends as a plain block."""
  m = (None if maintainer == "none" else
       TO.bound_maintainer_for(TO.InformationGain(k_max=4)))
  ts = TStore(m=1, d=D, capacity=128, append_block=AB, maintainer=m,
              sieve_k=K, device="cpu")
  assert not ts.sieve_enabled and ts.sieve_state_bytes == 0
  ts.append(_unit(5, 50))
  with pytest.raises(RuntimeError):
    ts.query_sieves()
  ts.reset_sieves()  # a no-op without a sieve


def test_store_sieve_four_shards_against_reference(subrun):
  """Four shards (the reference's 4-device mesh, the port's 4 stacked
  shards): appends with a growth and a grid roll, a merge from each
  side's own state, then a merge from the reference's state carried
  across.  The states are compared where no admission sits within 1e-6
  of its threshold; otherwise the merged answers' f(S) within 1e-5."""
  out = subrun(r"""
import numpy as np, jax, jax.numpy as jnp, torch
from repro.core import objectives as JO
from repro.service import CorpusStore as JStore
from repro.util import make_mesh
from repro_torch import interop, no_tf32
from repro_torch.core import objectives as TO
from repro_torch.service import CorpusStore as TStore
no_tf32()
D, K = 16, 8
r = np.random.default_rng(6)
x = r.normal(size=(400, D))
f = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
f[330:] *= 40.0
js = JStore(make_mesh((4,), ("data",)), d=D, capacity=128, append_block=64,
            maintainer=JO.bound_maintainer_for(JO.FacilityLocation()),
            sieve_k=K)
ts = TStore(m=4, d=D, capacity=128, append_block=64,
            maintainer=TO.bound_maintainer_for(TO.FacilityLocation()),
            sieve_k=K, device="cpu")
for part in (f[:100], f[100:330], f[330:]):
  js.append(part)
  ts.append(part)
a, b = js.sieve_state_host(), ts.sieve_state_host()
assert ts.growths == js.growths == 2
np.testing.assert_array_equal(a[5], b[5])
np.testing.assert_allclose(b[4], a[4], rtol=1e-6)
t = js.sieve_thresholds
tau = np.exp((a[5][0] - (t - 1) + np.arange(t)) * np.log1p(0.5))
rel = np.abs(a[1] / np.tile(tau, 4)[:, None] - 1.0)[a[0] >= 0]
near = bool((rel < 1e-6).any())

def f_of(ids):
  s = np.maximum(f @ f[ids].T, 0.0)
  return float(s.max(axis=1).mean())

if near:
  ga, gb = js.query_sieves()[0], ts.query_sieves()[0]
  fa, fb = f_of(ga[ga >= 0]), f_of(gb[gb >= 0])
  assert abs(fa - fb) <= 1e-5 * fa, (fa, fb)
else:
  np.testing.assert_array_equal(a[0], b[0])
  np.testing.assert_array_equal(a[3], b[3])
  np.testing.assert_allclose(b[1], a[1], rtol=1e-6)
  np.testing.assert_array_equal(a[2], b[2])
assert (a[3].reshape(4, t).sum(1) > 0).sum() >= 2  # rows on two shards
ts.set_sieve_state(interop.sieve_state(a))
g1, s1 = js.query_sieves(k=6)
g2, s2 = ts.query_sieves(k=6)
np.testing.assert_array_equal(g1, g2)
np.testing.assert_allclose(s2, s1, rtol=1e-6)
print("SIEVE4", "near-tie" if near else "equal")
""", 4)
  assert "SIEVE4" in out
