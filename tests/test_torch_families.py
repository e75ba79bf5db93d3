"""The other model families' modules against the JAX reference.

Each test feeds the same numpy inputs, drawn from a seed, to the JAX
function on the CPU and to its port (``repro_torch.models``: ``moe``,
``ssm``, ``rglru``, ``attention.local_attention`` / ``cross_attention``,
``layers.causal_conv1d`` / ``gelu_mlp`` and the encoder), in float32, at
the reference's ``reduced`` sizes.  Block parameters come from the
reference's own ``init_*`` (zero-initialised biases and gains replaced by
numpy draws, so those paths are exercised) and cross as tensors.

Tolerances: rtol 1e-5, with an atol of 1e-5 times the largest |want|,
unless a test says otherwise.  The MoE routing (top-k experts, each pair's
rank in its expert, the kept set) is compared bit for bit: the reference's
own intermediates are read off its two ``jax.nn.one_hot`` calls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Parallelism  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import rglru as TRG  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.transformer import Params  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

TOL = 1e-5
PAR = Parallelism(dp_axes=(), dp_size=0)
# leaves the reference initialises to zero; drawn here so they matter
DRAWN = ("b_a", "b_i", "dt_bias", "norm", "ln1", "ln2", "ln_f")


def _close(got, want, tol=TOL):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _np(t):
  return t.detach().float().cpu().numpy()


def _cfgs(arch):
  return (jconfigs.reduced(jconfigs.get_config(arch)),
          tconfigs.reduced(tconfigs.get_config(arch)))


def _drawn(tree, seed):
  """The reference's params as numpy, the zero-initialised leaves drawn."""
  r = np.random.default_rng(seed)

  def draw(path, leaf):
    leaf = np.asarray(leaf)
    if str(getattr(path[-1], "key", "")) in DRAWN:
      return leaf + r.normal(scale=0.2, size=leaf.shape).astype(leaf.dtype)
    return leaf

  return jax.tree_util.tree_map_with_path(draw, tree)


def _params(tree) -> Params:
  """A numpy pytree as the port's ``Params`` module."""
  return Params(_tensors(tree))


def _tensors(v):
  if isinstance(v, dict):
    return {k: _tensors(x) for k, x in v.items()}
  return interop.tensor(v).clone()


def _rand(r, *shape, scale=1.0):
  return (r.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
  r = np.random.default_rng(0)
  x, w = _rand(r, 2, 9, 24), _rand(r, 4, 24, scale=0.3)
  state = _rand(r, 2, 3, 24) if with_state else None
  jy, js = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                            None if state is None else jnp.asarray(state))
  ty, ts = TL.causal_conv1d(torch.tensor(x), torch.tensor(w),
                            None if state is None else torch.tensor(state))
  _close(_np(ty), jy)
  np.testing.assert_array_equal(_np(ts), np.asarray(js))
  # one token a call, the state carried, equals the whole sequence
  st = None if state is None else torch.tensor(state)
  steps = []
  for t in range(x.shape[1]):
    y1, st = TL.causal_conv1d(torch.tensor(x[:, t:t + 1]), torch.tensor(w),
                              st)
    steps.append(_np(y1))
  _close(np.concatenate(steps, axis=1), jy)


def test_gelu_mlp_is_the_tanh_gelu():
  r = np.random.default_rng(1)
  x, wu, wd = (_rand(r, 3, 5, 32), _rand(r, 32, 48, scale=0.2),
               _rand(r, 48, 32, scale=0.2))
  got = TL.gelu_mlp(torch.tensor(x), torch.tensor(wu), torch.tensor(wd))
  _close(_np(got), JL.gelu_mlp(jnp.asarray(x), jnp.asarray(wu),
                               jnp.asarray(wd)))
  z = np.linspace(-6, 6, 101).astype(np.float32)
  _close(_np(TL.gelu(torch.tensor(z))), jax.nn.gelu(jnp.asarray(z)))
  _close(_np(TL.softplus(torch.tensor(z * 5))),
         jax.nn.softplus(jnp.asarray(z * 5)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_setup(seed, cf=None, router=None):
  jcfg, tcfg = _cfgs("deepseek-moe-16b")
  if cf is not None:
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
  p = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(seed), jcfg,
                                             jnp.float32))
  if router is not None:
    p["router"] = router
  return jcfg, tcfg, p


def _ref_moe(x, p, jcfg, group):
  """The reference's moe_ffn, and its routing read off its two one_hot
  calls: top_e (G, Sg, k), the rank of every (pair, expert) and cap."""
  seen = []
  one_hot = jax.nn.one_hot

  def spy(a, n, **kw):
    seen.append((np.asarray(a), n))
    return one_hot(a, n, **kw)

  jax.nn.one_hot = spy
  try:
    y, aux = JMOE.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
                          group_size=group, dp_axes=(), ep_axis=None)
  finally:
    jax.nn.one_hot = one_hot
  (top_e, _), (pos, cap) = seen
  g, sg, k = top_e.shape
  rank = np.take_along_axis(pos.reshape(g, sg * k, -1),
                            top_e.reshape(g, sg * k, 1), axis=2)
  return np.asarray(y), float(aux), top_e, rank.reshape(g, sg, k), cap


@torch.no_grad()
def _port_moe(x, p, tcfg, group):
  tp = _params(p)
  y, aux = TMOE.moe_ffn(torch.tensor(x), tp, tcfg, group_size=group)
  sg = TMOE.group_len(tcfg, x.shape[0] * x.shape[1], group)
  xg, valid = TMOE._grouped(torch.tensor(x), sg)
  return _np(y), float(aux), TMOE.route(xg, valid, tp.router, tcfg)


def test_moe_drops_the_reference_pairs():
  """Groups of 64 with capacity factor 1 (cap 32 for 64 x 2 pairs over 4
  experts) over 2 x 80 tokens: the last group half padding; some pairs
  dropped; the routing and the kept set equal the reference's bit for
  bit, the output and the aux loss within 1e-5."""
  jcfg, tcfg, p = _moe_setup(0, cf=1.0)
  r = np.random.default_rng(2)
  x = _rand(r, 2, 80, tcfg.d_model)
  jy, jaux, top_e, rank, cap = _ref_moe(x, p, jcfg, 64)
  ty, taux, rt = _port_moe(x, p, tcfg, 64)
  assert rt.cap == cap == 32 and rt.valid.shape == (3, 64)
  assert not bool(rt.valid[2, 32:].any())
  valid = rt.valid.numpy()[..., None]
  np.testing.assert_array_equal(rt.top_e.numpy(), top_e)
  np.testing.assert_array_equal(np.where(valid, rt.rank.numpy(), -1),
                                np.where(valid, rank, -1))
  want_keep = (rank < cap) & valid
  np.testing.assert_array_equal(rt.keep.numpy(), want_keep)
  assert 0 < int((~want_keep & valid).sum()), "no pair was dropped"
  _close(ty, jy)
  _close(taux, jaux)


def test_moe_decode_size_routes_exactly():
  """A decode step's group (2 tokens <= 32) has cap = sg: every pair is
  kept; the output equals the reference's."""
  jcfg, tcfg, p = _moe_setup(1)
  x = _rand(np.random.default_rng(3), 2, 1, tcfg.d_model)
  jy, jaux, top_e, rank, cap = _ref_moe(x, p, jcfg, None)
  ty, taux, rt = _port_moe(x, p, tcfg, None)
  assert rt.cap == cap == 2 and bool(rt.keep.all())
  np.testing.assert_array_equal(rt.top_e.numpy(), top_e)
  _close(ty, jy)
  _close(taux, jaux)


def test_moe_top_k_ties_go_to_the_lowest_expert():
  """Router columns 1 and 2 equal (and column 0 twice column 1, column 3
  its negative), so every token's second choice ties between experts 1
  and 2: both packages pick 1 and route the same pairs, bit for bit."""
  jcfg, tcfg, _ = _moe_setup(2)
  r = np.random.default_rng(4)
  w = _rand(r, tcfg.d_model, scale=0.1)
  router = np.stack([2 * w, w, w, -w], axis=1).astype(np.float32)
  _, _, p = _moe_setup(2, router=router)
  x = _rand(r, 2, 24, tcfg.d_model)
  _, _, top_e, rank, _ = _ref_moe(x, p, jcfg, None)
  ty, _, rt = _port_moe(x, p, tcfg, None)
  probs = rt.probs.numpy()
  assert (probs[..., 1] == probs[..., 2]).all()
  np.testing.assert_array_equal(rt.top_e.numpy(), top_e)
  assert set(np.unique(top_e[..., 1])) == {1}
  np.testing.assert_array_equal(rt.rank.numpy(), rank)


def test_moe_aux_loss_matches_reference():
  """The Switch aux term on a skewed router (half the tokens on one
  expert) and the shared experts' SwiGLU."""
  jcfg, tcfg, p = _moe_setup(3)
  p["router"] = p["router"] * 4.0
  p["router"][:, 0] += 0.5
  x = _rand(np.random.default_rng(5), 3, 40, tcfg.d_model)
  jy, jaux, *_ = _ref_moe(x, p, jcfg, None)
  ty, taux, _ = _port_moe(x, p, tcfg, None)
  assert jaux > jcfg.moe.router_aux_weight
  _close(taux, jaux)
  _close(ty, jy)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------


def _ssd_inputs(r, b=2, l=37, h=4, p=8, g=1, n=16):
  x = _rand(r, b, l, h, p)
  dt = np.log1p(np.exp(_rand(r, b, l, h))).astype(np.float32)
  a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
  return x, dt, a_log, _rand(r, b, l, g, n), _rand(r, b, l, g, n)


def test_ssd_chunked_ragged_tail_and_h0_match_reference():
  """L = 37 over chunks of 16 (a padded tail of 11) from a carried h0."""
  r = np.random.default_rng(6)
  ins = _ssd_inputs(r)
  h0 = _rand(r, 2, 4, 8, 16, scale=0.5)
  jy, jh = JSSM.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=16,
                            h0=jnp.asarray(h0))
  ty, th = TSSM.ssd_chunked(*(torch.tensor(a) for a in ins), chunk=16,
                            h0=torch.tensor(h0))
  assert ty.shape == (2, 37, 4, 8)
  _close(_np(ty), jy)
  _close(_np(th), jh)
  # the tail padding leaves the state as one chunk of 37 leaves it
  _, th1 = TSSM.ssd_chunked(*(torch.tensor(a) for a in ins), chunk=37,
                            h0=torch.tensor(h0))
  _close(_np(th), _np(th1), 1e-4)


def test_ssd_decode_steps_chain_to_the_chunked_scan():
  r = np.random.default_rng(7)
  x, dt, a_log, b, c = _ssd_inputs(r, l=40, g=2, h=4)
  ty, th = TSSM.ssd_chunked(*(torch.tensor(a) for a in (x, dt, a_log, b, c)),
                            chunk=16)
  h = torch.zeros(2, 4, 8, 16)
  jh = jnp.zeros((2, 4, 8, 16))
  ys = []
  for t in range(x.shape[1]):
    step = [a[:, t] for a in (x, dt)] + [a_log] + [a[:, t] for a in (b, c)]
    y, h = TSSM.ssd_decode_step(*(torch.tensor(a) for a in step), h)
    jy, jh = JSSM.ssd_decode_step(*(jnp.asarray(a) for a in step), jh)
    _close(_np(y), jy)
    ys.append(_np(y))
  _close(_np(h), jh)
  _close(np.stack(ys, 1), _np(ty), 1e-4)
  _close(_np(h), _np(th), 1e-4)


@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_matches_reference(decode):
  jcfg, tcfg = _cfgs("mamba2-2.7b")
  p = _drawn(JSSM.init_mamba(jax.random.PRNGKey(8), jcfg, jnp.float32), 9)
  r = np.random.default_rng(10)
  x = _rand(r, 2, 1 if decode else 40, tcfg.d_model)
  state = None
  if decode:
    state = (_rand(r, 2, jcfg.ssm.conv_width - 1, TSSM.conv_dim(tcfg)),
             _rand(r, 2, TSSM.n_heads(tcfg), tcfg.ssm.head_dim,
                   tcfg.ssm.d_state, scale=0.3))
  jy, (jc, jh) = JSSM.mamba_block(
      jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
      decode_state=None if state is None else tuple(map(jnp.asarray, state)))
  ty, (tc, th) = TSSM.mamba_block(
      torch.tensor(x), _params(p), tcfg,
      decode_state=None if state is None else tuple(map(torch.tensor,
                                                        state)))
  _close(_np(ty), jy)
  _close(_np(tc), jc)
  _close(_np(th), jh)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,with_h0", [(32, False), (45, True)])
def test_rglru_scan_matches_associative_scan(length, with_h0):
  """The doubling scan against ``jax.lax.associative_scan`` (another
  combine order): rtol 1e-5."""
  r = np.random.default_rng(11)
  x = _rand(r, 2, length, 8)
  rr = 1 / (1 + np.exp(-_rand(r, 2, length, 8)))
  ii = 1 / (1 + np.exp(-_rand(r, 2, length, 8)))
  lam = np.linspace(-2, 2, 8).astype(np.float32)
  h0 = _rand(r, 2, 8) if with_h0 else None
  args = (x, rr.astype(np.float32), ii.astype(np.float32), lam)
  jh, jlast = JRG.rglru_scan(*(jnp.asarray(a) for a in args), 8.0,
                             None if h0 is None else jnp.asarray(h0))
  th, tlast = TRG.rglru_scan(*(torch.tensor(a) for a in args), 8.0,
                             None if h0 is None else torch.tensor(h0))
  _close(_np(th), jh)
  _close(_np(tlast), jlast)
  h = torch.zeros(2, 8) if h0 is None else torch.tensor(h0)
  jstep = jnp.zeros((2, 8)) if h0 is None else jnp.asarray(h0)
  for t in range(length):
    step = [a[:, t] for a in args[:3]] + [lam]
    h, _ = TRG.rglru_decode_step(*(torch.tensor(a) for a in step), 8.0, h)
    jstep, _ = JRG.rglru_decode_step(*(jnp.asarray(a) for a in step), 8.0,
                                     jstep)
  _close(_np(h), jstep)
  _close(_np(h), jlast)


@pytest.mark.parametrize("decode", [False, True])
def test_recurrent_block_matches_reference(decode):
  jcfg, tcfg = _cfgs("recurrentgemma-2b")
  p = _drawn(JRG.init_rglru(jax.random.PRNGKey(12), jcfg, jnp.float32), 13)
  r = np.random.default_rng(14)
  w = TRG.lru_width(tcfg)
  x = _rand(r, 2, 1 if decode else 40, tcfg.d_model)
  state = None
  if decode:
    state = (_rand(r, 2, jcfg.rec.conv_width - 1, w), _rand(r, 2, w))
  jy, (jc, jh) = JRG.recurrent_block(
      jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
      decode_state=None if state is None else tuple(map(jnp.asarray, state)))
  ty, (tc, th) = TRG.recurrent_block(
      torch.tensor(x), _params(p), tcfg,
      decode_state=None if state is None else tuple(map(torch.tensor,
                                                        state)))
  _close(_np(ty), jy)
  _close(_np(tc), jc)
  _close(_np(th), jh)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,q_chunk,groups", [(20, 16, 2), (8, 32, 1),
                                                   (40, 16, 4)])
def test_local_attention_matches_reference(window, q_chunk, groups):
  """L = 96 over several query chunks, windows shorter than L."""
  r = np.random.default_rng(15)
  q = _rand(r, 2, 4, 96, 32)
  k, v = _rand(r, 2, 4 // groups, 96, 32), _rand(r, 2, 4 // groups, 96, 32)
  want = JA.local_attention(*(jnp.asarray(a) for a in (q, k, v)),
                            window=window, q_chunk=q_chunk)
  got = TA.local_attention(*(torch.tensor(a) for a in (q, k, v)),
                           window=window, q_chunk=q_chunk)
  _close(_np(got), want)
  with pytest.raises(ValueError, match="multiple"):
    TA.local_attention(torch.tensor(q[:, :, :40]), torch.tensor(k[:, :, :40]),
                       torch.tensor(v[:, :, :40]), window=8, q_chunk=16)
  # the rule: a window takes local_attention, never the kernel
  got = TA.self_attention(*(torch.tensor(a) for a in (q, k, v)),
                          window=window, backend="cuda")
  _close(_np(got), JA.local_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      window=window))


def test_cross_attention_matches_reference():
  r = np.random.default_rng(16)
  q = _rand(r, 2, 4, 300, 32)
  k, v = _rand(r, 2, 2, 24, 32), _rand(r, 2, 2, 24, 32)
  want = JA.cross_attention(*(jnp.asarray(a) for a in (q, k, v)))
  got = TA.cross_attention(*(torch.tensor(a) for a in (q, k, v)))
  _close(_np(got), want)


def test_encoder_matches_reference():
  """The enc-dec family's bidirectional encoder (``Model.memory`` over
  frames) against the reference's ``_encode``."""
  jcfg, tcfg = _cfgs("whisper-tiny")
  jm = j_build_model(jcfg, remat=None)
  params = _drawn(jm.init(jax.random.PRNGKey(17)), 18)
  tm = interop.lm_params(Model(tcfg, device="cpu"), params)
  frames = _rand(np.random.default_rng(19), 2, jcfg.encoder.n_frames,
                 jcfg.d_model)
  want = jm._encode(jax.tree.map(jnp.asarray, params), jnp.asarray(frames),
                    PAR)
  with torch.no_grad():
    got = tm.memory({"frames": torch.tensor(frames)})
  _close(_np(got), want)
