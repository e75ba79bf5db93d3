"""The port's information-gain kernels and objectives against the JAX
reference's.

On the CPU the port's ``info_gain_cond``/``info_select`` wrappers take their
plain PyTorch versions; they are held here against ``repro.kernels.ops``
(Pallas in interpret mode) and ``repro.kernels.ref`` on the same numpy
inputs, over counts, k_max, ragged candidate counts, widths, linear/rbf,
f32/bf16, nothing feasible, exact ties and a partition axis.  The
objectives ``InformationGain`` and ``LogDetDPP`` are held against the
reference's on a state the reference built part way through a greedy run,
carried across by ``interop.ig_state``.

With the selection counts (``live``) the port's plain versions apply the
kernel's contract (``tril(linv)`` with the rows and columns at or past the
count zeroed); on the reference's ``_masked_linv`` factors, and on such a
factor carrying junk past its live triangle, they are held to the JAX
kernel on the masked factor, per partition when the counts differ.

Tolerances: cond within 2e-5 (f32) or 3e-2 (bf16) relative to the largest
magnitude (the rule of tests/test_kernels.py); top-1 indices equal.  The
DPP's cond is k_vv + 1e-6 - |L^-1 k|^2, a difference of nearly equal
numbers, so its values are held with an absolute tolerance of 2e-5 * k_vv
and its log gains only where cond exceeds 1e-3.  The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as JO  # noqa: E402
from repro.core.objectives import _masked_linv as j_masked_linv  # noqa: E402
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# k_max, count, nc, d: ragged nc, k_max not a multiple of 8, empty and full
CASES = [(1, 1, 70, 17), (7, 3, 300, 6), (13, 13, 257, 22), (8, 0, 100, 8),
         (12, 5, 129, 3)]


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _sim_np(x, y, kernel, h):
  if kernel == "linear":
    return x @ y.T
  d2 = (x * x).sum(1)[:, None] - 2 * x @ y.T + (y * y).sum(1)[None, :]
  return np.exp(-np.maximum(d2, 0.0) / (h * h))


def _operands(k_max, count, nc, d, kernel, ridge=1.0, seed=0, h=0.75):
  """A selection block, its masked inverse Cholesky factor (built in
  float64 from the first ``count`` rows) and candidates, as numpy f32."""
  r = np.random.default_rng(seed)
  sel = np.zeros((k_max, d))
  sel[:count] = r.normal(size=(count, d)) / np.sqrt(d)
  cand = r.normal(size=(nc, d)) / np.sqrt(d)
  linv = np.zeros((k_max, k_max))
  if count:
    kss = _sim_np(sel[:count], sel[:count], kernel, h) + ridge * np.eye(count)
    linv[:count, :count] = np.linalg.inv(np.linalg.cholesky(kss))
  return (sel.astype(np.float32), linv.astype(np.float32),
          cand.astype(np.float32))


def _both(a, dtype):
  jd, td, _ = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.tensor(a).to(td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("k_max,count,nc,d", CASES)
def test_info_gain_cond_matches_reference(k_max, count, nc, d, kernel,
                                          dtype):
  sel, linv, cand = _operands(k_max, count, nc, d, kernel)
  (js, ts), (jc, tc) = _both(sel, dtype), _both(cand, dtype)
  got = ops.info_gain_cond(ts, torch.tensor(linv), tc, kernel=kernel,
                           ridge=0.49).numpy()
  tol = DTYPES[dtype][2]
  _close(got, jops.info_gain_cond(js, jnp.asarray(linv), jc, kernel=kernel,
                                  ridge=0.49), tol)
  _close(got, jref.info_gain_cond_ref(js, jnp.asarray(linv), jc,
                                      kernel=kernel, ridge=0.49), tol)
  assert got.shape == (nc,) and (got >= 1e-12).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("k_max,count,nc,d", CASES[1:4])
def test_info_select_matches_reference(k_max, count, nc, d, kernel, dtype):
  sel, linv, cand = _operands(k_max, count, nc, d, kernel, seed=1)
  ok = np.random.default_rng(2).uniform(size=(nc,)) > 0.3
  (js, ts), (jc, tc) = _both(sel, dtype), _both(cand, dtype)
  best, idx = ops.info_select(ts, torch.tensor(linv), tc, torch.tensor(ok),
                              kernel=kernel)
  jb, ji = jops.info_select(js, jnp.asarray(linv), jc, jnp.asarray(ok),
                            kernel=kernel)
  assert int(idx) == int(ji)
  _close(float(best), float(jb), DTYPES[dtype][2])
  assert idx.dtype == torch.int64 and best.dtype == torch.float32


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_info_select_infeasible_and_ties(kernel):
  """Nothing feasible -> (0.0, 0); exact ties go to the lowest index, as in
  the reference.  With nothing selected (linv = 0) every rbf candidate
  ties at 1 + ridge; under linear the largest-norm row, copied to a lower
  and a higher index, ties with itself."""
  sel, linv, cand = _operands(6, 0, 90, 5, kernel, seed=3)
  top = int(np.argmax((cand * cand).sum(1)))
  cand[[top // 2, (top + 40) % 90]] = cand[top]
  ok = np.ones((90,), bool)
  ok[0] = False
  args = [(jnp.asarray(a), torch.tensor(a)) for a in (sel, linv, cand)]
  j = [a for a, _ in args]
  t = [b for _, b in args]
  for okv in (ok, np.zeros((90,), bool)):
    best, idx = ops.info_select(*t, torch.tensor(okv), kernel=kernel)
    jb, ji = jops.info_select(*j, jnp.asarray(okv), kernel=kernel)
    assert int(idx) == int(ji), (okv.sum(), int(idx), int(ji))
    assert float(best) == float(jb)
  assert float(best) == 0.0 and int(idx) == 0      # nothing feasible
  best, idx = ops.info_select(*t, torch.tensor(ok), kernel=kernel)
  copies = {top // 2, top, (top + 40) % 90} - {0}
  assert int(idx) == (1 if kernel == "rbf" else min(copies))


@pytest.mark.parametrize("shared_cands", [True, False])
def test_info_kernels_partition_axis(shared_cands):
  """A (P, ...) batch equals per-partition reference calls; a 2-D
  candidate block next to batched selections is shared (round 2 of the
  generic engine)."""
  P, k_max, nc, d = 3, 9, 150, 7
  ops_ = [_operands(k_max, c, nc, d, "rbf", seed=10 + c) for c in (0, 4, 9)]
  sel = np.stack([o[0] for o in ops_])
  linv = np.stack([o[1] for o in ops_])
  cand = ops_[0][2] if shared_cands else np.stack([o[2] for o in ops_])
  ok = np.random.default_rng(4).uniform(size=(P, nc)) > 0.2
  got = ops.info_gain_cond(torch.tensor(sel), torch.tensor(linv),
                           torch.tensor(cand)).numpy()
  best, idx = ops.info_select(torch.tensor(sel), torch.tensor(linv),
                              torch.tensor(cand), torch.tensor(ok))
  assert got.shape == (P, nc) and best.shape == idx.shape == (P,)
  for p in range(P):
    c = cand if shared_cands else cand[p]
    _close(got[p], jops.info_gain_cond(jnp.asarray(sel[p]),
                                       jnp.asarray(linv[p]),
                                       jnp.asarray(c)), 2e-5)
    jb, ji = jops.info_select(jnp.asarray(sel[p]), jnp.asarray(linv[p]),
                              jnp.asarray(c), jnp.asarray(ok[p]))
    assert int(idx[p]) == int(ji)
    _close(float(best[p]), float(jb), 2e-5)


# ---------------------------------------------------------------------------
# objectives on a state the reference built
# ---------------------------------------------------------------------------


def _feats(n, d, seed, scale=1.0):
  r = np.random.default_rng(seed)
  return (scale * r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)


OBJECTIVES = [  # (name, kernel, kernel_kwargs, feature scale)
    ("ig", "rbf", (("h", 0.75),), 1.0),
    ("ig", "linear", (), 1.0),
    ("dpp", "linear", (), 3.0),
    ("dpp", "rbf", (("h", 0.3),), 1.0),
]


def _objectives(name, kernel, kw, k_max):
  if name == "ig":
    return (JO.InformationGain(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                               sigma=0.7, backend="ref"),
            TO.InformationGain(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                               sigma=0.7))
  return (JO.LogDetDPP(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                       backend="ref"),
          TO.LogDetDPP(k_max=k_max, kernel=kernel, kernel_kwargs=kw))


def _hold_cond(name, got_gain, want_gain, k_vv, obj):
  """Compare gains: IG within 2e-5 relative; the DPP's conds with an
  absolute tolerance scaled by k_vv, and its log gains where cond > 1e-3."""
  got = np.asarray(got_gain, np.float64)
  want = np.asarray(want_gain, np.float64)
  if name == "ig":
    _close(got, want, 2e-5)
    return
  np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0,
                             atol=2e-5 * float(np.max(k_vv)) + 1e-7)
  big = np.exp(want) > 1e-3
  np.testing.assert_allclose(got[big], want[big], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,kernel,kw,scale", OBJECTIVES)
def test_objective_methods_on_carried_state(name, kernel, kw, scale):
  """gains, select, update and value of the port on a mid-trajectory state
  built by the reference (5 of k_max = 9 rows selected), carried across by
  ``interop.ig_state``."""
  d, n, k_max = 6, 200, 9
  x = _feats(n, d, seed=21, scale=scale)
  jobj, tobj = _objectives(name, kernel, kw, k_max)
  jx, tx = jnp.asarray(x), torch.tensor(x)
  jr = j_greedy(jobj, jobj.init_d(d), jx, 5, use_select=False,
                stop_nonpositive=(name == "dpp"))
  jst = jr.state
  tst = interop.ig_state(jax.tree.map(np.asarray, jst))
  assert int(tst.count) == int(jst.count) and tst.count.dtype == torch.int64
  k_vv = (x * x).sum(1) if kernel == "linear" else np.ones(n)
  _hold_cond(name, tobj.gains(tst, tx).numpy(),
             np.asarray(jobj.gains(jst, jx)), k_vv, tobj)
  ok = np.random.default_rng(5).uniform(size=(n,)) > 0.25
  tb, ti = tobj.select(tst, tx, torch.tensor(ok))
  jb, ji = jobj.select(jst, jx, jnp.asarray(ok))
  assert int(ti) == int(ji)
  _hold_cond(name, [float(tb)], [float(jb)], k_vv, tobj)
  j = int(ji)
  tnew = tobj.update(tst, tx[j])
  jnew = jobj.update(jst, jx[j])
  np.testing.assert_array_equal(tnew.count.numpy(), np.asarray(jnew.count))
  np.testing.assert_allclose(tnew.chol.numpy(), np.asarray(jnew.chol),
                             rtol=2e-5, atol=2e-5)
  np.testing.assert_array_equal(tnew.sel_feats.numpy(),
                                np.asarray(jnew.sel_feats))
  np.testing.assert_allclose(float(tobj.value(tnew)),
                             float(jobj.value(jnew)), rtol=2e-5, atol=1e-5)


def test_information_gain_shard_state_and_broadcast():
  """``init`` on an evaluation block records the live mass;
  ``partial_stats`` weights the gains by it, as the reference does; and a
  broadcast or (P, ...) state equals the per-partition states."""
  d, n = 5, 64
  x = _feats(n, d, seed=22)
  mask = (np.arange(n) % 7 != 0).astype(np.float32)
  jobj = JO.InformationGain(k_max=4, kernel="rbf", sigma=1.0, backend="ref")
  tobj = TO.InformationGain(k_max=4, kernel="rbf", sigma=1.0)
  jst = jobj.init(jnp.asarray(x), jnp.asarray(mask))
  jst = jobj.update(jst, jnp.asarray(x[3]))
  tst = interop.ig_shard_state(jax.tree.map(np.asarray, jst))
  jp, jn = jobj.partial_stats(jst, jnp.asarray(x))
  tp, tn = tobj.partial_stats(tst, torch.tensor(x))
  assert float(tn) == float(jn) == float(mask.sum())
  _close(tp.numpy(), np.asarray(jp), 2e-5)
  # stacked: two shards, each its own live count
  t2 = tobj.init(torch.tensor(np.stack([x, x])),
                 torch.tensor(np.stack([mask, np.ones_like(mask)])))
  t2 = tobj.update(t2, torch.tensor(np.stack([x[3], x[3]])))
  p2, n2 = tobj.partial_stats(t2, torch.tensor(x))
  assert n2.tolist() == [float(mask.sum()), float(n)]
  _close(p2[0].numpy(), np.asarray(jp), 2e-5)
  b = tobj.broadcast(tst, 3)
  assert b.inner.chol.shape == (3, 4, 4) and b.n_live.shape == (3,)
  _close(tobj.gains(b, torch.tensor(x))[2].numpy(),
         np.asarray(jobj.gains(jst, jnp.asarray(x))), 2e-5)


def test_update_at_full_buffer_mirrors_reference():
  """An update with count == k_max writes the last row without its
  diagonal, as the reference's clamped dynamic_update_slice and dropped
  out-of-range set do; the greedy loop refuses k_steps > k_max."""
  d, k_max = 4, 3
  x = _feats(10, d, seed=23)
  jobj = JO.InformationGain(k_max=k_max, kernel="rbf", backend="ref")
  tobj = TO.InformationGain(k_max=k_max, kernel="rbf")
  jst, tst = jobj.init_d(d), tobj.init_d(d)
  for i in range(k_max + 1):
    jst = jobj.update(jst, jnp.asarray(x[i]))
    tst = tobj.update(tst, torch.tensor(x[i]))
  np.testing.assert_allclose(tst.chol.numpy(), np.asarray(jst.chol),
                             rtol=2e-5, atol=2e-6)
  np.testing.assert_array_equal(tst.sel_feats.numpy(),
                                np.asarray(jst.sel_feats))
  from repro_torch.core.greedy import greedy
  with pytest.raises(ValueError, match="k_max"):
    greedy(tobj, tobj.init_d(d), torch.tensor(x), k_max + 1)


# ---------------------------------------------------------------------------
# the selection-count contract (``live``)
# ---------------------------------------------------------------------------

K_MAX = 9
LIVE_COUNTS = [0, 1, 5, K_MAX]  # empty, one row, partial, full buffer


def _ref_state(count, d, kernel, seed, k_max=K_MAX):
  """The reference's information-gain state after ``count`` updates: its
  selection block, its ``_masked_linv`` factor and the count, as numpy."""
  kw = (("h", 0.75),) if kernel == "rbf" else ()
  jobj = JO.InformationGain(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                            sigma=0.7, backend="ref")
  st = jobj.init_d(d)
  x = _feats(max(count, 1), d, seed)
  for i in range(count):
    st = jobj.update(st, jnp.asarray(x[i]))
  return (np.asarray(st.sel_feats, np.float32),
          np.asarray(j_masked_linv(st.chol, st.count), np.float32),
          int(st.count))


def _junk(linv, count, seed):
  """``linv`` with random values in its upper triangle and in the rows and
  columns at or past ``count``: what the live contract masks away."""
  k = linv.shape[-1]
  ar = np.arange(k)
  keep = ((ar[:, None] < count) & (ar[None, :] < count)
          & (ar[:, None] >= ar[None, :]))
  junk = np.random.default_rng(seed).normal(size=linv.shape)
  return np.where(keep, linv, junk).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("count", LIVE_COUNTS)
def test_live_matches_reference_on_masked_linv(count, kernel, dtype):
  """With ``live`` the plain versions equal the JAX kernel on the
  reference's masked factor, at counts 0, 1, partial and k_max."""
  sel, linv, c = _ref_state(count, 6, kernel, seed=30 + count)
  assert c == count
  cand = _feats(133, 6, seed=31)
  ok = np.random.default_rng(32).uniform(size=(133,)) > 0.3
  (js, ts), (jc, tc) = _both(sel, dtype), _both(cand, dtype)
  live = torch.tensor(count)
  got = ops.info_gain_cond(ts, torch.tensor(linv), tc, kernel=kernel,
                           ridge=0.49, live=live).numpy()
  tol = DTYPES[dtype][2]
  _close(got, jops.info_gain_cond(js, jnp.asarray(linv), jc, kernel=kernel,
                                  ridge=0.49), tol)
  best, idx = ops.info_select(ts, torch.tensor(linv), tc, torch.tensor(ok),
                              kernel=kernel, ridge=0.49, live=live)
  jb, ji = jops.info_select(js, jnp.asarray(linv), jc, jnp.asarray(ok),
                            kernel=kernel, ridge=0.49)
  assert int(idx) == int(ji)
  _close(float(best), float(jb), tol)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("count", [0, 3, K_MAX])
def test_live_masks_junk_past_the_live_triangle(count, kernel):
  """A factor with junk in its upper triangle and past ``live`` gives, with
  ``live``, what the JAX kernel gives on the masked factor; the dense call
  on the same junk does not."""
  sel, linv, _ = _ref_state(count, 5, kernel, seed=40 + count)
  cand = _feats(97, 5, seed=41)
  junk = _junk(linv, count, seed=42)
  got = ops.info_gain_cond(torch.tensor(sel), torch.tensor(junk),
                           torch.tensor(cand), kernel=kernel, ridge=0.49,
                           live=torch.tensor(count)).numpy()
  want = jops.info_gain_cond(jnp.asarray(sel), jnp.asarray(linv),
                             jnp.asarray(cand), kernel=kernel, ridge=0.49)
  _close(got, want, 2e-5)
  np.testing.assert_array_equal(
      ref.live_linv(torch.tensor(junk), torch.tensor(count)).numpy(),
      np.tril(np.where(np.arange(K_MAX) < count, 1.0, 0.0)[:, None]
              * np.where(np.arange(K_MAX) < count, 1.0, 0.0)[None, :]
              * junk).astype(np.float32))
  if 0 < count < K_MAX:
    dense = ops.info_gain_cond(torch.tensor(sel), torch.tensor(junk),
                               torch.tensor(cand), kernel=kernel,
                               ridge=0.49).numpy()
    assert np.abs(dense - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("shared_cands", [True, False])
def test_live_partitions_with_different_counts(shared_cands):
  """One batched call over partitions at counts 0, 4 and k_max (junk past
  each live triangle) equals the JAX kernel per partition on its masked
  factor."""
  counts = (0, 4, K_MAX)
  states = [_ref_state(c, 7, "rbf", seed=50 + c) for c in counts]
  sel = np.stack([s_[0] for s_ in states])
  linv = np.stack([_junk(s_[1], c, seed=51 + c)
                   for s_, c in zip(states, counts)])
  cands = [_feats(150, 7, seed=52 + p) for p in range(3)]
  cand = cands[0] if shared_cands else np.stack(cands)
  ok = np.random.default_rng(53).uniform(size=(3, 150)) > 0.2
  live = torch.tensor(counts)
  got = ops.info_gain_cond(torch.tensor(sel), torch.tensor(linv),
                           torch.tensor(cand), live=live).numpy()
  best, idx = ops.info_select(torch.tensor(sel), torch.tensor(linv),
                              torch.tensor(cand), torch.tensor(ok), live=live)
  for p, (s_, c) in enumerate(zip(states, counts)):
    cp = cand if shared_cands else cand[p]
    _close(got[p], jops.info_gain_cond(jnp.asarray(s_[0]),
                                       jnp.asarray(s_[1]), jnp.asarray(cp)),
           2e-5)
    jb, ji = jops.info_select(jnp.asarray(s_[0]), jnp.asarray(s_[1]),
                              jnp.asarray(cp), jnp.asarray(ok[p]))
    assert int(idx[p]) == int(ji)
    _close(float(best[p]), float(jb), 2e-5)


@pytest.mark.parametrize("name,kernel,kw,scale", OBJECTIVES)
@pytest.mark.parametrize("count", [0, 1, K_MAX - 1, K_MAX])
def test_objective_gains_select_across_counts(count, name, kernel, kw,
                                              scale):
  """The objectives' gains and select (which pass their selection count
  to the kernels as ``live``) on a state the reference built by ``count``
  updates, carried across by ``interop.ig_state``, against the
  reference's."""
  d, n = 6, 120
  x = _feats(n, d, seed=60 + count, scale=scale)
  jobj, tobj = _objectives(name, kernel, kw, K_MAX)
  jst = jobj.init_d(d)
  for i in range(count):
    jst = jobj.update(jst, jnp.asarray(x[(7 * i) % n]))
  tst = interop.ig_state(jax.tree.map(np.asarray, jst))
  assert int(tst.count) == count
  jx, tx = jnp.asarray(x), torch.tensor(x)
  k_vv = (x * x).sum(1) if kernel == "linear" else np.ones(n)
  _hold_cond(name, tobj.gains(tst, tx).numpy(),
             np.asarray(jobj.gains(jst, jx)), k_vv, tobj)
  ok = np.random.default_rng(61).uniform(size=(n,)) > 0.25
  tb, ti = tobj.select(tst, tx, torch.tensor(ok))
  jb, ji = jobj.select(jst, jx, jnp.asarray(ok))
  assert int(ti) == int(ji)
  _hold_cond(name, [float(tb)], [float(jb)], k_vv, tobj)
