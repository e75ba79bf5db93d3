"""The port's FacilityLocation and greedy loop against the JAX reference.

Same numpy inputs on both sides; the port runs on CPU tensors (the kernels'
plain versions), the reference through its Pallas kernels in interpret
mode.  Selected indices and realized gains must be equal (the corpora are
well separated, so no top-2 gap is near the f32 tolerance), values within
1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import tiny_images_like  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.greedy import greedy as jgreedy  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.core import constraints as TC  # noqa: E402
from repro_torch.core import greedy as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

KERNELS = [("linear", ()), ("rbf", (("h", 0.9),))]


def _feats(n, d=16, seed=0):
  return np.asarray(tiny_images_like(n, d, clusters=12, seed=seed))


def _objs(kernel, kw):
  return (JO.FacilityLocation(kernel=kernel, kernel_kwargs=kw,
                              backend="pallas"),
          TO.FacilityLocation(kernel=kernel, kernel_kwargs=kw))


@pytest.mark.parametrize("kernel,kw", KERNELS)
def test_facility_location_methods_match_reference(kernel, kw):
  """init / gains / select / update / value / partial_stats."""
  f = _feats(160, seed=1)
  ev, cd = f[:120], f[120:]
  mask = (np.arange(120) % 7 != 0).astype(np.float32)
  jo, to = _objs(kernel, kw)
  js = jo.init(jnp.asarray(ev), jnp.asarray(mask))
  ts = to.init(torch.tensor(ev), torch.tensor(mask))
  np.testing.assert_array_equal(ts.cov.numpy(), np.asarray(js.cov))
  ok = np.arange(40) % 5 != 0
  for step in range(3):
    jg = np.asarray(jo.gains(js, jnp.asarray(cd)))
    tg = to.gains(ts, torch.tensor(cd)).numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5 * jg.max())
    jb, ji = jo.select(js, jnp.asarray(cd), jnp.asarray(ok))
    tb, ti = to.select(ts, torch.tensor(cd), torch.tensor(ok))
    assert int(ti) == int(ji)
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-5)
    jp, jn = jo.partial_stats(js, jnp.asarray(cd))
    tp, tn = to.partial_stats(ts, torch.tensor(cd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5 * float(np.max(jp)))
    assert float(tn) == float(jn)
    js = jo.update(js, jnp.asarray(cd[int(ji)]))
    ts = to.update(ts, torch.tensor(cd[int(ji)]))
    np.testing.assert_allclose(ts.cov.numpy(), np.asarray(js.cov),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(to.value(ts)), float(jo.value(js)),
                               rtol=1e-5)
    ok[int(ji)] = False


@pytest.mark.parametrize("use_select", [True, False])
@pytest.mark.parametrize("kernel,kw", KERNELS)
def test_greedy_matches_reference(kernel, kw, use_select):
  f = _feats(200, seed=2)
  cand_mask = np.arange(200) % 9 != 4
  jo, to = _objs(kernel, kw)
  jr = jgreedy(jo, jo.init(jnp.asarray(f)), jnp.asarray(f), 12,
               cand_mask=jnp.asarray(cand_mask), use_select=use_select)
  tr = TG.greedy(to, to.init(torch.tensor(f)), torch.tensor(f), 12,
                 cand_mask=torch.tensor(cand_mask), use_select=use_select)
  np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
  np.testing.assert_allclose(tr.gains.numpy(), np.asarray(jr.gains),
                             rtol=1e-5)
  np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                             rtol=1e-5)
  np.testing.assert_array_equal(tr.feats.numpy(), np.asarray(jr.feats))
  assert (tr.rescans.numpy() == 0).all()


def test_greedy_batched_partitions_match_vmapped_reference():
  """A leading partition axis equals the reference's vmap over partitions,
  including a partition that runs out of feasible candidates (no-op steps
  with idx -1 and gain 0)."""
  P, n = 3, 48
  f = _feats(P * n, seed=3).reshape(P, n, -1)
  mask = np.ones((P, n), bool)
  mask[2, 5:] = False                      # partition 2: five candidates
  jo, to = _objs("linear", ())
  jm = jnp.asarray(mask.astype(np.float32))

  def one(part, m_row, cm):
    return jgreedy(jo, jo.init(part, m_row), part, 8, cand_mask=cm)

  jr = jax.vmap(one)(jnp.asarray(f), jm, jnp.asarray(mask))
  ts = to.init(torch.tensor(f), torch.tensor(mask.astype(np.float32)))
  tr = TG.greedy(to, ts, torch.tensor(f), 8, cand_mask=torch.tensor(mask))
  np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
  assert (tr.idx.numpy()[2, 5:] == -1).all()
  np.testing.assert_allclose(tr.gains.numpy(), np.asarray(jr.gains),
                             rtol=1e-5)
  np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                             rtol=1e-5)


def test_greedy_runs_out_of_candidates_and_caps_at_cardinality():
  """More steps than candidates: the surplus steps are no-ops (idx -1), as
  in the reference; an explicit Cardinality(k) below k_steps caps the
  selection."""
  f = _feats(40, seed=4)
  jo, to = _objs("linear", ())
  jr = jgreedy(jo, jo.init(jnp.asarray(f)), jnp.asarray(f), 45)
  tr = TG.greedy(to, to.init(torch.tensor(f)), torch.tensor(f), 45)
  np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
  assert (tr.idx.numpy()[40:] == -1).all()
  tr = TG.greedy(to, to.init(torch.tensor(f)), torch.tensor(f), 10,
                 constraint=TC.Cardinality(4))
  assert (tr.idx.numpy()[:4] >= 0).all() and (tr.idx.numpy()[4:] == -1).all()


def test_greedy_other_modes_raise():
  """The random modes are ported (tests/test_torch_constraints.py); what
  raises now is a mode that does not exist, and a mode without the inputs
  it needs (a sample fraction, item costs).  Every similarity of the
  reference is ported (``neg_sq_dist``: tests/test_torch_objectives.py), so
  what an objective refuses is a similarity outside ``KERNELS``."""
  f = torch.tensor(_feats(20, seed=5))
  to = TO.FacilityLocation()
  with pytest.raises(ValueError, match="not in"):
    TG.greedy(to, to.init(f), f, 3, mode="sieve")
  with pytest.raises(ValueError, match="sample_frac"):
    TG.greedy(to, to.init(f), f, 3, mode="stochastic")
  with pytest.raises(ValueError, match="cost"):
    TG.greedy(to, to.init(f), f, 3, mode="cost_benefit")
  with pytest.raises(ValueError, match="not in"):
    TO.FacilityLocation(kernel="cosine")
