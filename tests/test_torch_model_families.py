"""The port's other model families, whole, against the JAX reference.

For each of the six architectures beyond the dense stack (deepseek-moe-16b
and grok-1-314b: MoE; mamba2-2.7b: SSM; recurrentgemma-2b: RG-LRU with
windowed attention, one period and a remainder layer; llama-3.2-vision-90b:
cross blocks over image embeddings; whisper-tiny: encoder-decoder), at the
reference's ``reduced`` size in float32: the reference's ``model.init``
parameters (zero-initialised gains and biases replaced by numpy draws, so
those paths are exercised) go through ``interop.lm_params`` into the port,
and on the same tokens (and frames or image embeddings) the port must
reproduce the reference's teacher-forcing logits and aux loss, the prefill
logits and every cache leaf, each decode step's logits, ``generate``'s
greedy tokens, and the loss and every gradient.  Inside the port, prefill
and decode equal teacher forcing position by position; RecurrentGemma's
windowed ring buffer decodes past the window as the reference does, and
past a prompt longer than the window whose length is not a multiple of it
(where the reference's cache layout loses a key; the port's keeps it).

Tolerances: logits, aux and caches within 1e-4 (rtol, and atol times the
largest |want|); the loss within 1e-5 relative and every gradient within
1e-4 of its leaf's largest |want|; decode against teacher forcing 2e-3 (the
reference test's).  Greedy tokens are compared after every step's top-2
gap in the reference is shown to exceed 1e-3.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Parallelism  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

PAR = Parallelism(dp_axes=(), dp_size=0)
B, S, STEPS = 2, 32, 4
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "mamba2-2.7b",
         "recurrentgemma-2b", "llama-3.2-vision-90b", "whisper-tiny"]
TOL = 1e-4
TOL_TF = 2e-3
TOL_GAP = 1e-3
DRAWN = ("ln1", "ln2", "lnx", "ln_f", "q_norm", "k_norm", "bq", "bk", "bv",
         "b_a", "b_i", "dt_bias", "norm")


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _np(t):
  return t.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _models(arch: str):
  """(reference model, its params, port model) holding the same weights."""
  jcfg = jconfigs.reduced(jconfigs.get_config(arch))
  tcfg = tconfigs.reduced(tconfigs.get_config(arch))
  jm = j_build_model(jcfg, remat=None)
  params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
  r = np.random.default_rng(8)

  def draw(path, leaf):
    if str(getattr(path[-1], "key", "")) in DRAWN:
      return leaf + r.normal(scale=0.2, size=leaf.shape).astype(leaf.dtype)
    return leaf

  params = jax.tree_util.tree_map_with_path(draw, params)
  tm = interop.lm_params(Model(tcfg, device="cpu", remat=None), params)
  return jm, jax.tree.map(jnp.asarray, params), tm


def _inputs(cfg, seed, length=S + STEPS):
  """Tokens (B, length) and the family's memory input, as numpy."""
  r = np.random.default_rng(seed)
  out = {"tokens": r.integers(0, cfg.vocab, size=(B, length)).astype(
      np.int32)}
  if cfg.family == "encdec":
    out["frames"] = r.normal(size=(B, cfg.encoder.n_frames,
                                   cfg.d_model)).astype(np.float32)
  if cfg.family == "vlm":
    out["img_embeds"] = r.normal(size=(B, cfg.n_img_tokens,
                                       cfg.d_model)).astype(np.float32)
  return out


def _j(batch, **kw):
  return {k: jnp.asarray(v) for k, v in dict(batch, **kw).items()}


def _t(batch, **kw):
  return {k: torch.as_tensor(np.asarray(v)).long() if v.dtype == np.int32
          else torch.as_tensor(np.asarray(v))
          for k, v in dict(batch, **kw).items()}


def _layer_caches(cfg, caches):
  """The reference's caches (periods stacked, then the remainder) as one
  dict a layer, in the port's order."""
  caches = jax.tree.map(np.asarray, caches)
  width = len(cfg.pattern)
  out = []
  for t in range(cfg.n_periods):
    for j in range(width):
      out.append({n: v[t] for n, v in caches["periods"][f"b{j}"].items()})
  for j in range(cfg.n_remainder):
    out.append(caches["rem"][f"r{j}"])
  return out


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str):
  """The reference's teacher-forcing logits and aux, and its prefill +
  decode logits and caches over the same inputs."""
  jm, params, tm = _models(arch)
  batch = _inputs(tm.cfg, 9)
  toks = batch["tokens"]
  train, aux = jm.apply_train(params, _j(batch), PAR)
  memory = jm._memory(params, _j(batch), PAR)
  caches = jm.init_cache(B, S + STEPS, memory=memory)
  last, caches = jm.prefill(params, _j(batch, tokens=toks[:, :S]), caches,
                            PAR)
  prefill_caches = _layer_caches(tm.cfg, caches)
  steps = []
  for t in range(S, S + STEPS):
    logits, caches = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t), caches, PAR)
    steps.append(np.asarray(logits))
  return (batch, np.asarray(train), float(aux), np.asarray(last),
          prefill_caches, steps)


def _port_prefill(tm, batch, max_len, length=S):
  tb = _t(batch, tokens=batch["tokens"][:, :length])
  caches = tm.init_cache(B, max_len, memory=tm.memory(tb))
  return tm.prefill(tb, caches)


def test_every_family_is_in_the_port():
  assert set(ARCHS) | {"qwen3-4b", "qwen3-8b", "qwen1.5-4b",
                       "deepseek-67b"} == set(tconfigs.ARCHS)
  assert {tconfigs.get_config(a).family for a in ARCHS} == {
      "moe", "ssm", "hybrid", "vlm", "encdec"}


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_every_leaf(arch):
  """Every parameter of the port holds the reference's leaf bit for bit,
  stacked period leaves split to their layers."""
  _, params, tm = _models(arch)
  want = interop.lm_tree(tm, jax.tree.map(np.asarray, params))
  got = tm.state_dict()
  assert set(want) == set(got)
  for name, w in want.items():
    np.testing.assert_array_equal(got[name].numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_train_matches_reference(arch):
  _, _, tm = _models(arch)
  batch, train, aux, *_ = _reference_run(arch)
  with torch.no_grad():
    got, got_aux = tm.apply_train(_t(batch))
  assert got.shape == (B, S + STEPS, tm.cfg.vocab)
  _close(_np(got), train, TOL)
  _close(float(got_aux), aux, TOL)
  assert (aux > 0) == bool(tm.cfg.moe.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference(arch):
  _, _, tm = _models(arch)
  batch, _, _, last, jcaches, _ = _reference_run(arch)
  got, caches = _port_prefill(tm, batch, S + STEPS)
  _close(_np(got), last, TOL)
  assert len(caches) == len(jcaches) == tm.cfg.n_layers
  for i, (c, want) in enumerate(zip(caches, jcaches)):
    assert set(c) == set(want), i
    for name, w in want.items():
      if name == "kpos":
        np.testing.assert_array_equal(c[name].numpy(), w)
      else:
        assert c[name].dtype == (torch.float32), name
        _close(_np(c[name]), w, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
  _, _, tm = _models(arch)
  batch, _, _, _, _, steps = _reference_run(arch)
  toks = torch.as_tensor(batch["tokens"]).long()
  _, caches = _port_prefill(tm, batch, S + STEPS)
  for t, want in zip(range(S, S + STEPS), steps):
    got, caches = tm.decode_step(toks[:, t:t + 1], t, caches)
    _close(_np(got), want, TOL)


def _gaps(jm, params, batch, tokens):
  """The reference's top-2 logit gap at every greedy step of ``tokens``."""
  memory = jm._memory(params, _j(batch), PAR)
  caches = jm.init_cache(B, S + tokens.shape[1], memory=memory)
  logits, caches = jm.prefill(params, _j(batch), caches, PAR)
  gaps = []
  for t in range(tokens.shape[1]):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
    gaps.append(top2[:, 1] - top2[:, 0])
    logits, caches = jm.decode_step(params, jnp.asarray(tokens[:, t:t + 1]),
                                    jnp.int32(S + t), caches, PAR)
  return np.stack(gaps, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(arch):
  jm, params, tm = _models(arch)
  batch = _inputs(tm.cfg, 11, S)
  want = np.asarray(j_generate(jm, params, _j(batch), steps=6, par=PAR))
  assert _gaps(jm, params, batch, want).min() > TOL_GAP
  got = generate(tm, _t(batch), steps=6)
  assert got.shape == (B, 6)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
  """Inside the port: prefill + decode logits equal the teacher-forcing
  forward position by position (tests/test_models.py's check)."""
  _, _, tm = _models(arch)
  batch = _inputs(tm.cfg, 12)
  toks = torch.as_tensor(batch["tokens"]).long()
  with torch.no_grad():
    train, _ = tm.apply_train(_t(batch))
  last, caches = _port_prefill(tm, batch, S + STEPS)
  _close(_np(last), _np(train[:, S - 1]), TOL_TF)
  for t in range(S, S + STEPS):
    logits, caches = tm.decode_step(toks[:, t:t + 1], t, caches)
    _close(_np(logits), _np(train[:, t]), TOL_TF)


def test_windowed_decode_ring_buffer():
  """RecurrentGemma's local attention (window 32): 8 prompt tokens, then
  decode to position 47 in a 32-row ring, every step's logits against the
  reference's decode, and the last against teacher forcing (the reference
  test's case)."""
  jm, params, tm = _models("recurrentgemma-2b")
  assert tm.cfg.sliding_window == 32
  total = 48
  toks = np.random.default_rng(13).integers(
      0, tm.cfg.vocab, size=(B, total)).astype(np.int32)
  jc = jm.init_cache(B, total)
  _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :8])}, jc, PAR)
  tc = tm.init_cache(B, total)
  assert tc[2]["k"].shape[2] == 32
  tm.prefill({"tokens": torch.as_tensor(toks[:, :8]).long()}, tc)
  for t in range(8, total):
    jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t), jc, PAR)
    tl, tc = tm.decode_step(torch.as_tensor(toks[:, t:t + 1]).long(), t, tc)
    _close(_np(tl), jl, TOL)
  assert int(tc[2]["kpos"].max()) == total - 1
  with torch.no_grad():
    train, _ = tm.apply_train({"tokens": torch.as_tensor(toks).long()})
  _close(_np(tl), _np(train[:, -1]), 3e-3)


@pytest.mark.parametrize("prompt", [64, 45])
def test_ring_buffer_after_a_prompt_past_the_window(prompt):
  """A prompt longer than the window fills the ring with its tail at
  slot p % 32; decoding on matches teacher forcing.  At 64 (a multiple of
  the window) the cache and the logits also equal the reference's."""
  jm, params, tm = _models("recurrentgemma-2b")
  total = prompt + 6
  toks = np.random.default_rng(14).integers(
      0, tm.cfg.vocab, size=(B, total)).astype(np.int32)
  tc = tm.init_cache(B, total)
  tm.prefill({"tokens": torch.as_tensor(toks[:, :prompt]).long()}, tc)
  kpos = tc[2]["kpos"].numpy()
  np.testing.assert_array_equal(np.sort(kpos), np.arange(prompt - 32,
                                                         prompt))
  np.testing.assert_array_equal(kpos % 32, np.arange(32))
  with torch.no_grad():
    train, _ = tm.apply_train({"tokens": torch.as_tensor(toks).long()})
  if prompt % 32 == 0:
    jc = jm.init_cache(B, total)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :prompt])},
                       jc, PAR)
    np.testing.assert_array_equal(
        kpos, np.asarray(jc["periods"]["b2"]["kpos"][0]))
  for t in range(prompt, total):
    tl, tc = tm.decode_step(torch.as_tensor(toks[:, t:t + 1]).long(), t, tc)
    _close(_np(tl), _np(train[:, t]), TOL_TF)
    if prompt % 32 == 0:
      jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t), jc, PAR)
      _close(_np(tl), jl, TOL)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad(arch: str):
  jm = _models(arch)[0]

  def loss(p, b):
    return jm.loss_fn(p, b, PAR, loss_chunk=8)

  return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
  """``loss_fn`` (xent + aux) and every parameter's gradient against
  jax.grad of the reference's, names mapped as interop.lm_params maps
  them; the port under remat "dots"."""
  jm, params, tm = _models(arch)
  batch = _inputs(tm.cfg, 15, 24)
  toks = batch["tokens"]
  batch = dict(batch, tokens=toks[:, :-1], labels=toks[:, 1:],
               mask=np.ones((B, 23), np.float32))
  batch["mask"][0, :5] = 0.0
  (jloss, jmet), jgrads = _ref_loss_and_grad(arch)(params, _j(batch))
  want = interop.lm_tree(tm, jax.tree.map(np.asarray, jgrads))
  port = interop.lm_params(Model(tm.cfg, device="cpu", remat="dots"),
                           jax.tree.map(np.asarray, params))
  loss, met = port.loss_fn(_t(batch), loss_chunk=8)
  _close(float(loss.detach()), float(jloss), 1e-5)
  _close(float(met["aux"]), float(jmet["aux"]), 1e-5)
  loss.backward()
  got = dict(port.named_parameters())
  assert set(got) == set(want)
  for name, g in want.items():
    _close(_np(got[name].grad), g.numpy(), TOL)


def _losses(out: str) -> list[float]:
  return [float(line.split("loss")[1].split()[0])
          for line in out.splitlines() if line.startswith("[train] step")]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_every_family(arch, tmp_path, capsys):
  """``launch/train.py --arch`` on one process at ``--reduced`` (the
  enc-dec and VLM batches carry their frames / image embeddings)."""
  from repro_torch.launch import train as launch_train
  launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--seq-len", "16", "--global-batch", "2", "--steps",
                     "2", "--ckpt-every", "0", "--ckpt-dir",
                     str(tmp_path / "ck")])
  out = capsys.readouterr().out
  losses = _losses(out)
  assert "[train] done: steps 0..2 on cpu" in out and len(losses) == 2
  assert all(np.isfinite(losses))


def test_launcher_data_axis_runs_a_moe_family(tmp_path, capsys):
  """``--mesh 2x1`` under torchrun (2 gloo ranks) trains reduced
  deepseek-moe-16b, each rank on its data shard of 512 tokens (one of the
  batch's two groups of ``group_size`` 512), and prints the losses one
  process prints on the whole batch."""
  import os
  import subprocess
  import sys

  from repro_torch.launch import train as launch_train
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
             OMP_NUM_THREADS="1")
  common = ["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
            "--seq-len", "256", "--global-batch", "4", "--steps", "2",
            "--ckpt-every", "0"]
  proc = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *common,
       "--mesh", "2x1", "--dist-backend", "gloo", "--ckpt-dir",
       str(tmp_path / "ck")],
      env=env, capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "[train] done: steps 0..2" in proc.stdout
  assert "mesh 2x1 backend gloo" in proc.stdout
  launch_train.main([*common, "--ckpt-dir", str(tmp_path / "one")])
  one = _losses(capsys.readouterr().out)
  assert len(one) == 2
  np.testing.assert_allclose(_losses(proc.stdout), one, rtol=0, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_specs_match_reference(arch):
  """At full size (shapes only: the reference's eval_shape, the port's
  ``param_shapes``): every leaf's shape, and ``param_specs`` under a model
  axis of 16 with fsdp, with expert parallelism over the model axis
  (``ep``) and over the pod axis (``ep_pod``), keyed by the port's names
  (``interop.lm_specs``)."""
  from repro.models import Parallelism as JParallelism
  from repro_torch.models import Parallelism as TParallelism
  from repro_torch.models import param_shapes, param_specs
  jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
  jm = j_build_model(jcfg)
  shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
  want_shapes = interop._by_name(jcfg, shapes, lambda leaf, index: tuple(
      leaf.shape if index is None else leaf.shape[1:]))
  assert param_shapes(tcfg) == want_shapes
  for kw in (dict(fsdp=True), dict(ep=True), dict(ep_pod=True)):
    par = dict(dp_axes=("data",), dp_size=16, model_size=16, **kw)
    want = interop.lm_specs(jcfg, jm.param_specs(JParallelism(**par)))
    assert param_specs(tcfg, TParallelism(**par)) == want, kw
