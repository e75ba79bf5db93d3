"""The port's training path against the JAX reference.

Reduced qwen3-4b in float32: the reference's ``model.init`` parameters
(the zero-initialised norm gains replaced by numpy draws, so those paths
are exercised) go through ``interop.lm_params`` into the port, and both
packages see the same numpy batches.  The reference's jitted functions are
compiled once per file (module fixtures / caches).

Tolerances: the loss within 1e-5 relative; ``chunked_attention`` and its
q / k / v gradients within 1e-5 (rtol, and atol times the largest |want|);
every parameter's gradient within 1e-4 of its leaf's largest |want|.
Three train steps from one optimizer state (``interop.opt_state``): loss,
grad norm and lr within 1e-5 relative each step; parameters within 2 x lr
of the reference per element (Adam's step bounds the sign flip of a
near-zero gradient) and 99.9 % of the elements within 1e-5.  Microbatches
against one batch: 5e-3, the reference test's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.selection import \
    greedi_select_indices as j_select  # noqa: E402
from repro.core import greedi as JG  # noqa: E402
from repro.models import Parallelism  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.train_step import make_train_step as j_train_step  # noqa
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.data.pipeline import (EmbeddedCorpus, SyntheticLM,  # noqa
                                       batches_from_indices)
from repro_torch.data.selection import greedi_select_indices  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import make_eval_step, make_train_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

PAR = Parallelism(dp_axes=(), dp_size=0)
B, S = 2, 24
DRAWN = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _np(t):
  return t.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _reference():
  """(reference model, its params as numpy, the port's config)."""
  jcfg = jconfigs.reduced(jconfigs.get_config("qwen3-4b"))
  jm = j_build_model(jcfg, remat=None)
  params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
  r = np.random.default_rng(8)

  def draw(path, leaf):
    if str(getattr(path[-1], "key", "")) in DRAWN:
      return leaf + r.normal(scale=0.2, size=leaf.shape).astype(leaf.dtype)
    return leaf

  params = jax.tree_util.tree_map_with_path(draw, params)
  return jm, params, tconfigs.reduced(tconfigs.get_config("qwen3-4b"))


def _port(remat=None, params=None) -> Model:
  _, ref_params, tcfg = _reference()
  return interop.lm_params(Model(tcfg, device="cpu", remat=remat),
                           ref_params if params is None else params)


def _batch(seed=3, b=B, s=S, masked=True):
  r = np.random.default_rng(seed)
  vocab = _reference()[2].vocab
  toks = r.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
  mask = np.ones((b, s), np.float32)
  if masked:
    mask[0, : s // 3] = 0.0
    mask[1, -2:] = 0.0
  return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _t(batch):
  return {k: torch.as_tensor(np.asarray(v)).long() if v.dtype == np.int32
          else torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
  return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad(loss_chunk: int):
  jm = _reference()[0]

  def loss(p, b):
    return jm.loss_fn(p, b, PAR, loss_chunk=loss_chunk)

  return jax.jit(jax.value_and_grad(loss, has_aux=True))


# ---------------------------------------------------------------------------
# the loss and attention
# ---------------------------------------------------------------------------


def test_softmax_xent_matches_reference():
  r = np.random.default_rng(0)
  logits = r.normal(scale=3.0, size=(3, 7, 50)).astype(np.float32)
  labels = r.integers(0, 50, size=(3, 7)).astype(np.int32)
  mask = (r.uniform(size=(3, 7)) > 0.3).astype(np.float32)
  want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(mask))
  got = TL.softmax_xent(torch.tensor(logits), torch.tensor(labels).long(),
                        torch.tensor(mask))
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
  # every token masked: 0, as the reference's max(sum(mask), 1) gives
  assert float(TL.softmax_xent(torch.tensor(logits),
                               torch.tensor(labels).long(),
                               torch.zeros(3, 7))) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length,q_chunk,k_chunk", [(40, 16, 16),
                                                    (37, 8, 32),
                                                    (32, 32, 8)])
def test_chunked_attention_matches_reference(causal, length, q_chunk,
                                             k_chunk):
  """GQA (4 query heads on 2 KV heads), ragged lengths (padded queries and
  masked padded keys), q_chunk below L: the output and the q / k / v
  gradients of sum(out * w)."""
  r = np.random.default_rng(length + q_chunk)
  q = r.normal(size=(2, 4, length, 32)).astype(np.float32)
  k = r.normal(size=(2, 2, length, 32)).astype(np.float32)
  v = r.normal(size=(2, 2, length, 32)).astype(np.float32)
  w = r.normal(size=(2, 4, length, 32)).astype(np.float32)
  kw = dict(causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)

  def jf(q, k, v):
    return jnp.sum(JA.chunked_attention(q, k, v, **kw) * w)

  want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)
  jgrads = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
  tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
  got = TA.chunked_attention(tq, tk, tv, **kw)
  _close(_np(got), want, 1e-5)
  (got * torch.tensor(w)).sum().backward()
  for t, g in zip((tq, tk, tv), jgrads):
    _close(_np(t.grad), g, 1e-5)
  with torch.no_grad():
    _close(_np(TA.chunked_attention(tq, tk, tv, **kw)), want, 1e-5)


def test_grad_path_never_reaches_the_kernel(monkeypatch):
  """Under autograd every self_attention call takes chunked_attention (no
  call of ops.flash_attention); an eval step under no_grad calls it once a
  layer."""
  calls = []
  kernel = ops.flash_attention

  def counted(*a, **kw):
    calls.append(1)
    return kernel(*a, **kw)

  monkeypatch.setattr(ops, "flash_attention", counted)
  tm = _port(remat="dots")
  batch = _t(_batch())
  loss, _ = tm.loss_fn(batch)
  loss.backward()
  assert calls == []
  tm.apply_train(batch)[0].sum().backward()
  assert calls == []
  make_eval_step(tm)(batch)
  assert len(calls) == tm.cfg.n_layers
  with torch.no_grad():
    tm.apply_train(batch)
  assert len(calls) == 2 * tm.cfg.n_layers


@pytest.mark.parametrize("loss_chunk", [8, 10, 512])
def test_loss_fn_matches_reference(loss_chunk):
  """With a mask; loss_chunk dividing S (8: three chunks), not dividing it
  (10: one chunk of S, the reference's rule) and past it."""
  jm, params, _ = _reference()
  batch = _batch()
  (want, wm), _ = _ref_loss_and_grad(loss_chunk)(
      jax.tree.map(jnp.asarray, params), _j(batch))
  tm = _port()
  with torch.no_grad():
    got, gm = tm.loss_fn(_t(batch), loss_chunk=loss_chunk)
  np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
  np.testing.assert_allclose(float(gm["xent"]), float(wm["xent"]), rtol=1e-5)
  assert float(gm["aux"]) == float(wm["aux"]) == 0.0
  no_mask = {k: v for k, v in batch.items() if k != "mask"}
  (want, _), _ = _ref_loss_and_grad(loss_chunk)(
      jax.tree.map(jnp.asarray, params), _j(no_mask))
  got, _ = tm.loss_fn(_t(no_mask), loss_chunk=loss_chunk)
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


@pytest.mark.parametrize("loss_chunk", [8, 10])
def test_gradients_match_reference(loss_chunk):
  """Every parameter's gradient against jax.grad of the reference loss,
  names mapped as interop.lm_params maps them."""
  jm, params, _ = _reference()
  batch = _batch(seed=4)
  _, jgrads = _ref_loss_and_grad(loss_chunk)(
      jax.tree.map(jnp.asarray, params), _j(batch))
  want = interop.lm_tree(_port(), jax.tree.map(np.asarray, jgrads))
  tm = _port(remat="dots")
  tm.loss_fn(_t(batch), loss_chunk=loss_chunk)[0].backward()
  got = dict(tm.named_parameters())
  assert set(got) == set(want)
  for name, g in want.items():
    _close(_np(got[name].grad), g.numpy(), 1e-4)


def test_remat_policies_give_the_same_gradients():
  batch = _t(_batch(seed=5))
  grads = {}
  for remat in (None, "dots", "full"):
    tm = _port(remat=remat)
    tm.loss_fn(batch, loss_chunk=8)[0].backward()
    grads[remat] = {n: p.grad for n, p in tm.named_parameters()}
  for remat in ("dots", "full"):
    for name, g in grads[None].items():
      torch.testing.assert_close(grads[remat][name], g, rtol=1e-6,
                                 atol=1e-7)
  with pytest.raises(ValueError, match="remat"):
    Model(_reference()[2], device="cpu", remat="some")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
  for cfg in (JO.OptConfig(lr=1.0, warmup_steps=10, total_steps=110),
              JO.OptConfig(lr=3e-4, warmup_steps=0, total_steps=7),
              JO.OptConfig(lr=2e-3, warmup_steps=5, total_steps=5)):
    tcfg = TO.OptConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 3, 5, 10, 60, 110, 200):
      got = TO.schedule(tcfg, torch.tensor(step))
      assert got.dtype == torch.float32
      np.testing.assert_allclose(float(got),
                                 float(JO.schedule(cfg, jnp.int32(step))),
                                 rtol=1e-6, atol=1e-12)


def test_norm_and_clip_match_reference():
  r = np.random.default_rng(1)
  tree = {"a": r.normal(size=(7, 5)).astype(np.float32) * 3,
          "b": r.normal(size=(11,)).astype(np.float32)}
  tt = {k: torch.tensor(v) for k, v in tree.items()}
  jt = {k: jnp.asarray(v) for k, v in tree.items()}
  np.testing.assert_allclose(float(TO.global_norm(tt)),
                             float(JO.global_norm(jt)), rtol=1e-6)
  for max_norm in (1.0, 100.0):
    got, gn = TO.clip_by_global_norm(tt, max_norm)
    want, wn = JO.clip_by_global_norm(jt, max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k in tree:
      _close(_np(got[k]), want[k], 1e-6)
  assert abs(float(TO.global_norm(TO.clip_by_global_norm(tt, 1.0)[0]))
             - 1.0) < 1e-5


def test_decay_mask_selects_the_reference_leaves():
  """The set of decayed leaves: the reference's rule on its paths, carried
  to the port's names by interop.lm_tree, equals the port's rule on its
  names (norm gains exempt, every matrix decayed)."""
  _, params, _ = _reference()
  tm = _port()
  flat, treedef = jax.tree_util.tree_flatten_with_path(params)
  decisions = jax.tree_util.tree_unflatten(treedef, [
      np.full(leaf.shape, JO._decay_mask(
          "/".join(str(getattr(k, "key", k)) for k in path)))
      for path, leaf in flat])
  want = {n: bool(t.reshape(-1)[0])
          for n, t in interop.lm_tree(tm, decisions).items()}
  got = {n: TO._decay_mask(n) for n, _ in tm.named_parameters()}
  assert got == want
  assert not got["ln_f"] and not got["layers.0.attn.q_norm"]
  assert got["embed"] and got["layers.1.mlp.down"]


def test_adamw_update_matches_reference_with_a_bf16_leaf():
  r = np.random.default_rng(2)
  params = {"w": r.normal(size=(6, 4)).astype(np.float32),
            "ln": r.normal(size=(4,)).astype(np.float32),
            "emb": r.normal(size=(5, 3)).astype(np.float32)}
  cfg = JO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=6, clip_norm=0.5)
  jp = {k: jnp.asarray(v) for k, v in params.items()}
  jp["emb"] = jp["emb"].astype(jnp.bfloat16)
  tp = {k: torch.tensor(v) for k, v in params.items()}
  tp["emb"] = tp["emb"].to(torch.bfloat16)
  jst = JO.init_opt_state(jp)
  tst = TO.init_opt_state(tp)
  tcfg = TO.OptConfig(**dataclasses.asdict(cfg))
  for i in range(3):
    g = {k: r.normal(size=v.shape).astype(np.float32)
         for k, v in params.items()}
    jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
    tg = {k: torch.tensor(v).to(tp[k].dtype) for k, v in g.items()}
    jp, jst, jm = JO.adamw_update(cfg, jp, jg, jst)
    tm = TO.adamw_update(tcfg, tp, tg, tst)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tst.step) == int(jst.step) == i + 1
    for k in params:
      _close(_np(tst.mu[k]), jst.mu[k], 1e-6)
      _close(_np(tst.nu[k]), jst.nu[k], 1e-6)
    _close(_np(tp["w"]), jp["w"], 1e-6)
    _close(_np(tp["ln"]), jp["ln"], 1e-6)
    assert tp["emb"].dtype == torch.bfloat16
    # one bf16 ulp at most (the float32 update rounds to bf16 on both sides)
    np.testing.assert_allclose(_np(tp["emb"]),
                               np.asarray(jp["emb"], np.float32),
                               rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_steps():
  """The reference: one step from init (so the moments are not zero), then
  three more; returns the state after the first and each step's metrics
  and parameters."""
  jm, params, _ = _reference()
  step = jax.jit(j_train_step(jm, JO.OptConfig(**OCFG), PAR))
  p = jax.tree.map(jnp.asarray, params)
  opt = JO.init_opt_state(p)
  p, opt, _ = step(p, opt, _j(_batch(seed=10)))
  start = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, opt))
  out = []
  for i in range(3):
    p, opt, m = step(p, opt, _j(_batch(seed=11 + i)))
    out.append(({k: float(v) for k, v in m.items()},
                jax.tree.map(np.asarray, p)))
  return start, out


def test_train_steps_match_reference():
  (p0, opt0), ref = _ref_steps()
  tm = _port(remat="dots", params=p0)
  opt = interop.opt_state(tm, opt0)
  assert int(opt.step) == 1
  step = make_train_step(tm, TO.OptConfig(**OCFG))
  names = None
  for i, (wm, wp) in enumerate(ref):
    m = step(opt, _t(_batch(seed=11 + i)))
    assert int(opt.step) == i + 2
    for key in ("loss", "xent", "grad_norm", "lr"):
      np.testing.assert_allclose(float(m[key]), wm[key], rtol=1e-5,
                                 err_msg=f"step {i} {key}")
    assert float(m["aux"]) == 0.0
    want = interop.lm_tree(tm, wp)
    names = names or sorted(want)
    far, total = 0, 0
    for name, p in tm.named_parameters():
      d = np.abs(_np(p) - want[name].numpy())
      assert float(d.max()) <= 2 * wm["lr"], (i, name, float(d.max()))
      far += int((d > 1e-5).sum())
      total += d.size
    assert far <= 1e-3 * total, (i, far, total)
  assert sorted(dict(tm.named_parameters())) == names


def test_microbatches_match_one_batch():
  batch = _batch(seed=6, b=4, s=16, masked=False)
  ocfg = TO.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
  tm1, tm2 = _port(), _port()
  m1 = make_train_step(tm1, ocfg)(TO.init_opt_state(tm1), _t(batch))
  mb = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in _t(batch).items()}
  m2 = make_train_step(tm2, ocfg, microbatches=2)(TO.init_opt_state(tm2), mb)
  err = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(tm1.parameters(), tm2.parameters()))
  assert err < 5e-3, err
  np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                             rtol=1e-4)


def test_eval_step_matches_reference():
  _, params, _ = _reference()
  batch = _batch(seed=7)
  (want, _), _ = _ref_loss_and_grad(512)(jax.tree.map(jnp.asarray, params),
                                         _j(batch))
  tm = _port()
  got = make_eval_step(tm)(_t(batch))
  assert not got["loss"].requires_grad
  np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-5)
  assert all(p.grad is None for p in tm.parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_prune_and_leftover_tmp(tmp_path):
  ck = CheckpointManager(str(tmp_path), keep_last=2)
  tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "nested": {"b": torch.tensor([1.5, -2.25, 3.0, 1e-3],
                                       dtype=torch.bfloat16)},
          "opt": TO.init_opt_state({"x.w": torch.ones(3)})}
  for step in (10, 20, 30):
    ck.save(step, tree, extra={"tag": "x"})
  assert ck.all_steps() == [20, 30]  # pruned to keep_last=2
  # a crash mid-save leaves a tmp.* that the restore never reads
  (tmp_path / "tmp.40").mkdir()
  (tmp_path / "tmp.40" / "arrays.npz").write_bytes(b"partial")
  assert ck.latest_step() == 30
  like = {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(
      4, dtype=torch.bfloat16)}, "opt": TO.init_opt_state(
          {"x.w": torch.zeros(3)})}
  restored, meta = ck.restore(like)
  assert meta["step"] == 30 and meta["tag"] == "x"
  assert torch.equal(restored["a"], tree["a"])
  assert restored["nested"]["b"].dtype == torch.bfloat16
  assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
  assert isinstance(restored["opt"], TO.OptState)
  assert restored["opt"].step.dtype == torch.int64
  restored, meta = ck.restore(like, step=20)
  assert meta["step"] == 20


def test_checkpoint_detects_corruption(tmp_path):
  ck = CheckpointManager(str(tmp_path))
  ck.save(1, {"a": torch.ones(3)})
  with pytest.raises(ValueError, match="shape mismatch"):
    ck.restore({"a": torch.zeros(4)})
  with pytest.raises(KeyError, match="missing leaf"):
    ck.restore({"a": torch.zeros(3), "b": torch.zeros(1)})
  assert CheckpointManager(str(tmp_path / "empty")).restore_latest_or_none(
      {"a": torch.zeros(3)}) == (None, None)


def test_failure_restart_resumes_training(tmp_path):
  """A crash after 3 steps, a restart that resumes to 6: the same
  parameters as 6 uninterrupted steps."""
  ocfg = TO.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
  batch = _t(_batch(seed=9, s=16, masked=False))

  def run(upto, directory):
    ck = CheckpointManager(directory, keep_last=2)
    tm = _port(remat="dots")
    opt = TO.init_opt_state(tm)
    restored, meta = ck.restore_latest_or_none(
        {"p": tm.state_dict(), "o": opt})
    start = 0
    if restored is not None:
      tm.load_state_dict(restored["p"])
      opt, start = restored["o"], meta["step"]
    step = make_train_step(tm, ocfg)
    for s in range(start, upto):
      step(opt, batch)
      ck.save(s + 1, {"p": tm.state_dict(), "o": opt})
    return tm, int(opt.step)

  _, step_a = run(3, str(tmp_path))
  resumed, step_b = run(6, str(tmp_path))
  assert (step_a, step_b) == (3, 6)
  straight, _ = run(6, str(tmp_path / "straight"))
  err = max(float((a - b).abs().max()) for a, b in
            zip(resumed.parameters(), straight.parameters()))
  assert err < 1e-5, err


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_lm_determinism_and_shards():
  d = SyntheticLM(vocab=1000, seq_len=16, global_batch=8, seed=3,
                  device="cpu")
  b1, b2 = d.batch(5), d.batch(5)
  assert torch.equal(b1["tokens"], b2["tokens"])
  assert not torch.equal(b1["tokens"], d.batch(6)["tokens"])
  assert not torch.equal(b1["tokens"], dataclasses.replace(
      d, seed=4).batch(5)["tokens"])
  assert b1["tokens"].shape == (8, 16) and b1["tokens"].dtype == torch.int64
  assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000
  assert torch.equal(b1["mask"], torch.ones(8, 16))
  # labels are next-token shifted
  assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
  for n in (2, 4):
    parts = [d.batch(5, shard=s, num_shards=n) for s in range(n)]
    assert parts[0]["tokens"].shape == (8 // n, 16)
    for key in ("tokens", "labels"):
      assert torch.equal(torch.cat([p[key] for p in parts]), b1[key])
  with pytest.raises(ValueError):
    d.batch(0, num_shards=3)
  # the truncated power law: P(token < 100) = P(u < 0.1 ** (1 / 1.2))
  toks = SyntheticLM(vocab=1000, seq_len=256, global_batch=16,
                     device="cpu").batch(0)["tokens"]
  assert abs(float((toks < 100).float().mean()) - 0.1 ** (1 / 1.2)) < 0.02


def test_batches_from_indices_start_skips_without_building(monkeypatch):
  """start= (a resumed run) gives the tail of the run from 0, and builds
  tokens only for the batches it yields."""
  corpus = EmbeddedCorpus(n_docs=64, feat_dim=8, device="cpu")
  sel = np.arange(0, 64, 3)
  full = list(batches_from_indices(corpus, sel, 4, 7))
  built = []
  tokens_for = EmbeddedCorpus.tokens_for

  def counted(self, idx):
    built.append(1)
    return tokens_for(self, idx)

  monkeypatch.setattr(EmbeddedCorpus, "tokens_for", counted)
  tail = list(batches_from_indices(corpus, sel, 4, 7, start=5))
  assert len(built) == len(tail) == 2
  for got, want in zip(tail, full[5:]):
    for key in want:
      assert torch.equal(got[key], want[key])


def _keep_table(key, k, n, p):
  """(k, n) stochastic-greedy samples from the reference greedy's key
  chain: bernoulli(r_step, p, (n,)) per step."""
  rows, rng = [], key
  for _ in range(k):
    rng, r_step = jax.random.split(rng)
    rows.append(np.asarray(jax.random.bernoulli(r_step, p, (n,))))
  return np.stack(rows)


def test_select_indices_sample_frac_matches_reference():
  """greedi_select_indices in the stochastic mode takes sample_frac: with
  the reference's partition and per-round samples, the reference's ids."""
  n, m, kappa, k, frac = 203, 4, 6, 8, 0.5  # ragged: one hole
  feats = np.random.default_rng(11).normal(size=(n, 8)).astype(np.float32)
  feats /= np.linalg.norm(feats, axis=1, keepdims=True)
  key = jax.random.PRNGKey(3)
  want = j_select(key, jnp.asarray(feats), m=m, kappa=kappa, k_final=k,
                  mode="stochastic", sample_frac=frac)
  r_part, r_sel, r_r2, _ = JG.greedi_keys(key)
  from repro.core.partition import random_partition
  _, _, perm = random_partition(r_part, jnp.asarray(feats), m)
  perm = np.asarray(perm)
  keys = jax.random.split(r_sel, m)
  t1 = np.stack([_keep_table(keys[i], kappa, perm.shape[1], frac)
                 for i in range(m)])
  t2 = _keep_table(r_r2, k, m * kappa, frac)
  got = greedi_select_indices(None, torch.tensor(feats), m=m, kappa=kappa,
                              k_final=k, mode="stochastic", sample_frac=frac,
                              perm=interop.perm(perm),
                              r1_draws=interop.keep_table(t1),
                              r2_draws=interop.keep_table(t2))
  assert got.tolist() == np.asarray(want).tolist()
  # the port's own draws: k valid, distinct ids
  own = greedi_select_indices(torch.Generator().manual_seed(0),
                              torch.tensor(feats), m=m, kappa=kappa,
                              k_final=k, mode="stochastic", sample_frac=frac)
  assert len(set(own.tolist())) == len(own) == k
  assert own.min() >= 0 and own.max() < n
