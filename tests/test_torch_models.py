"""The port's dense decoder and serving path against the JAX reference.

The reference's ``model.init`` parameters (their zero-initialised norm gains
and QKV biases replaced by numpy draws, so those paths are exercised) go
through ``interop.lm_params`` into the port, for reduced qwen3-4b (GQA,
qk-norm) and reduced qwen1.5-4b (MHA, QKV bias), each from its package's
``configs.reduced``.  On the same tokens the port must reproduce the
reference's layers, teacher-forcing logits, prefill logits and cache, every
decode step's logits and ``generate``'s greedy tokens.

Tolerances: float32 within 1e-4 (rtol, and atol times the largest |want|);
the bfloat16 model within 3e-2 of the largest logit (the bf16 rule of
tests/test_kernels.py; both packages round every bf16 product and cast, in
other orders, through the whole stack: 1.1e-2 measured on this model).
Greedy tokens are compared only after every step's top-2 logit gap in the
reference is shown to exceed 1e-3 (a near-tie could flip on float32 noise).
Temperature sampling cannot match ``jax.random``: it is checked for shape,
range and reproducibility under one ``torch.Generator``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Parallelism  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

PAR = Parallelism(dp_axes=(), dp_size=0)
B, S, STEPS = 2, 32, 4
ARCHS = ["qwen3-4b", "qwen1.5-4b"]
TOL = 1e-4
TOL_BF16 = 3e-2
TOL_GAP = 1e-3
# leaves the reference initialises to zero; drawn here so they matter
DRAWN = ("ln1", "ln2", "ln_f", "q_norm", "k_norm", "bq", "bk", "bv")


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _np(t):
  return t.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str = "float32"):
  """(reference model, its params, port model) holding the same weights."""
  jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                             dtype=dtype)
  tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                             dtype=dtype)
  jm = j_build_model(jcfg, remat=None)
  params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
  r = np.random.default_rng(8)

  def draw(path, leaf):
    if str(getattr(path[-1], "key", "")) in DRAWN:
      noise = r.normal(scale=0.2, size=leaf.shape).astype(np.float32)
      return (leaf.astype(np.float32) + noise).astype(leaf.dtype)
    return leaf

  params = jax.tree_util.tree_map_with_path(draw, params)
  tm = interop.lm_params(Model(tcfg, device="cpu"), params)
  return jm, jax.tree.map(jnp.asarray, params), tm


def _tokens(cfg, seed=9):
  r = np.random.default_rng(seed)
  return r.integers(0, cfg.vocab, size=(B, S + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str):
  """The reference's teacher-forcing logits, and its prefill + decode
  logits and caches over the same tokens."""
  jm, params, tm = _models(arch)
  toks = _tokens(tm.cfg)
  train, _ = jm.apply_train(params, {"tokens": jnp.asarray(toks)}, PAR)
  caches = jm.init_cache(B, S + STEPS)
  last, caches = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                            caches, PAR)
  prefill_caches = jax.tree.map(np.asarray, caches)
  steps = []
  for t in range(S, S + STEPS):
    logits, caches = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t), caches, PAR)
    steps.append(np.asarray(logits))
  return toks, np.asarray(train), np.asarray(last), prefill_caches, steps


def test_configs_match_reference():
  """The port's configs, their parameter counts and their reduced
  variants equal the reference's, and the port has every architecture
  the reference has."""
  for name, cfg in tconfigs.ARCHS.items():
    ref = jconfigs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
    assert cfg.param_count() == ref.param_count()
    assert (dataclasses.asdict(tconfigs.reduced(cfg))
            == dataclasses.asdict(jconfigs.reduced(ref)))
  assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
  assert tconfigs.get_config("qwen3-4b").param_count() == 4_411_228_160
  with pytest.raises(KeyError, match="no such architecture"):
    tconfigs.get_config("qwen3-0b")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_match_reference(dtype):
  """rms_norm, apply_rope (at positions up to 10^5) and swiglu."""
  jd, td, tol = {"f32": (jnp.float32, torch.float32, TOL),
                 "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
  r = np.random.default_rng(10)
  x = r.normal(size=(2, 4, 50, 128)).astype(np.float32)
  gamma = r.normal(scale=0.3, size=(128,)).astype(np.float32)
  jx, tx = jnp.asarray(x, jd), torch.tensor(x).to(td)
  got = TL.rms_norm(tx, torch.tensor(gamma), 1e-6)
  assert got.dtype == td
  _close(_np(got), JL.rms_norm(jx, jnp.asarray(gamma), 1e-6), tol)
  for theta, pos in ((1e6, np.arange(100000 - 50, 100000)),
                     (1e4, np.arange(50) * 4000)):
    pos = pos.astype(np.int32)
    got = TL.apply_rope(tx, torch.tensor(pos), theta)
    assert got.dtype == td
    _close(_np(got), JL.apply_rope(jx, jnp.asarray(pos), theta), tol)
  h = r.normal(size=(3, 7, 64)).astype(np.float32)
  ws = [r.normal(scale=s, size=shape).astype(np.float32)
        for s, shape in ((0.125, (64, 96)), (0.125, (64, 96)),
                         (0.1, (96, 64)))]
  got = TL.swiglu(torch.tensor(h).to(td), *(torch.tensor(w).to(td)
                                             for w in ws))
  assert got.dtype == td
  _close(_np(got), JL.swiglu(jnp.asarray(h, jd),
                             *(jnp.asarray(w, jd) for w in ws)), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_train_matches_reference(arch):
  _, _, tm = _models(arch)
  toks, train, *_ = _reference_run(arch)
  got, aux = tm.apply_train({"tokens": torch.tensor(toks)})
  assert got.shape == (B, S + STEPS, tm.cfg.vocab)
  _close(_np(got), train, TOL)
  assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference(arch):
  _, _, tm = _models(arch)
  toks, _, last, jcaches, _ = _reference_run(arch)
  caches = tm.init_cache(B, S + STEPS)
  got, caches = tm.prefill({"tokens": torch.tensor(toks[:, :S])}, caches)
  _close(_np(got), last, TOL)
  stacked = jcaches["periods"]["b0"]
  for i, c in enumerate(caches):
    _close(_np(c["k"]), stacked["k"][i], TOL)
    _close(_np(c["v"]), stacked["v"][i], TOL)
    np.testing.assert_array_equal(c["kpos"].numpy(), stacked["kpos"][i])
  assert (caches[0]["kpos"][:S] == torch.arange(S)).all()
  assert (caches[0]["kpos"][S:] == -1).all()


def test_prefill_into_a_short_cache_keeps_the_prompt_tail():
  """A cache shorter than the prompt holds its last positions, as the
  reference's prefill keeps them."""
  jm, params, tm = _models("qwen3-4b")
  toks = _tokens(tm.cfg, seed=15)[:, :S]
  jc = jm.init_cache(B, S - 8)
  _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, jc, PAR)
  _, tc = tm.prefill({"tokens": torch.tensor(toks)}, tm.init_cache(B, S - 8))
  stacked = jax.tree.map(np.asarray, jc)["periods"]["b0"]
  for i, c in enumerate(tc):
    _close(_np(c["k"]), stacked["k"][i], TOL)
    _close(_np(c["v"]), stacked["v"][i], TOL)
    np.testing.assert_array_equal(c["kpos"].numpy(), stacked["kpos"][i])
  assert (tc[0]["kpos"] == torch.arange(8, S)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
  _, _, tm = _models(arch)
  toks, _, _, _, steps = _reference_run(arch)
  caches = tm.init_cache(B, S + STEPS)
  tm.prefill({"tokens": torch.tensor(toks[:, :S])}, caches)
  for t, want in zip(range(S, S + STEPS), steps):
    got, caches = tm.decode_step(torch.tensor(toks[:, t:t + 1]), t, caches)
    _close(_np(got), want, TOL)
    assert int(caches[0]["kpos"][t]) == t


def _gaps(jm, params, prompt, tokens):
  """The reference's top-2 logit gap at every greedy step of ``tokens``."""
  caches = jm.init_cache(B, S + tokens.shape[1])
  logits, caches = jm.prefill(params, {"tokens": jnp.asarray(prompt)},
                              caches, PAR)
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
  prompt = _tokens(tm.cfg, seed=11)[:, :S]
  want = np.asarray(j_generate(jm, params, {"tokens": jnp.asarray(prompt)},
                               steps=8, par=PAR))
  gaps = _gaps(jm, params, prompt, want)
  assert gaps.min() > TOL_GAP, gaps
  got = generate(tm, {"tokens": torch.tensor(prompt)}, steps=8)
  assert got.shape == (B, 8)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
  """Inside the port: prefill + decode logits equal the teacher-forcing
  forward position by position (tests/test_models.py's check)."""
  _, _, tm = _models(arch)
  toks = torch.tensor(_tokens(tm.cfg, seed=12))
  train, _ = tm.apply_train({"tokens": toks})
  caches = tm.init_cache(B, S + STEPS)
  last, caches = tm.prefill({"tokens": toks[:, :S]}, caches)
  _close(_np(last), _np(train[:, S - 1]), TOL)
  for t in range(S, S + STEPS):
    logits, caches = tm.decode_step(toks[:, t:t + 1], t, caches)
    _close(_np(logits), _np(train[:, t]), TOL)


def test_bf16_model_matches_reference():
  """The bf16 model (reduced qwen3-4b): teacher forcing, prefill and decode
  logits within 3e-2 of the largest logit."""
  jm, params, tm = _models("qwen3-4b", "bfloat16")
  assert tm.embed.dtype == torch.bfloat16
  assert tm.layers[0].attn.q_norm.dtype == torch.float32
  toks = _tokens(tm.cfg, seed=13)
  train, _ = jm.apply_train(params, {"tokens": jnp.asarray(toks)}, PAR)
  got, _ = tm.apply_train({"tokens": torch.tensor(toks)})
  assert got.dtype == torch.bfloat16
  _close(_np(got), train, TOL_BF16)
  jc = jm.init_cache(B, S + STEPS)
  jlast, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jc,
                         PAR)
  tc = tm.init_cache(B, S + STEPS)
  tlast, tc = tm.prefill({"tokens": torch.tensor(toks[:, :S])}, tc)
  assert tc[0]["k"].dtype == torch.bfloat16
  _close(_np(tlast), jlast, TOL_BF16)
  for t in range(S, S + STEPS):
    jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t), jc, PAR)
    tl, tc = tm.decode_step(torch.tensor(toks[:, t:t + 1]), t, tc)
    _close(_np(tl), jl, TOL_BF16)


def test_interop_bf16_pytree_is_bit_exact():
  jm, params, tm = _models("qwen3-4b", "bfloat16")
  wq = np.asarray(params["periods"]["b0"]["attn"]["wq"][1])
  assert wq.dtype.name == "bfloat16"
  got = tm.layers[1].attn.wq.detach()
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                wq.view(np.int16))
  np.testing.assert_array_equal(
      tm.embed.detach().view(torch.int16).numpy(),
      np.asarray(params["embed"]).view(np.int16))
  with pytest.raises(ValueError, match="reference"):
    interop.lm_params(Model(tm.cfg, device="cpu"),
                      jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   params))
  with pytest.raises(ValueError, match="did not fill"):
    interop.lm_params(Model(tm.cfg, device="cpu"),
                      {"embed": np.asarray(params["embed"])})


def _stand_in_mesh(data: int, model: int, rank: int = 0):
  """A ``TrainMesh`` of ``rank``'s groups with no process group behind
  them: enough to lay a model out (no collective runs while one is
  built)."""
  from repro_torch.launch.mesh import ProcessMesh, TrainMesh
  cpu = torch.device("cpu")
  d, m = rank // model, rank % model
  return TrainMesh(data, model, rank, cpu, "gloo",
                   dp=ProcessMesh(data, d, data, cpu, "gloo"),
                   tp=ProcessMesh(model, m, model, cpu, "gloo"),
                   world=ProcessMesh(data * model, rank, data * model, cpu,
                                     "gloo"))


def test_model_refuses_what_is_not_ported():
  """What stays refused: a model axis that divides neither the query heads
  nor the projections' columns (whisper-tiny's 6 x 64 at M = 5,
  recurrentgemma-2b's 10 x 256 at M = 3), through ``check_supported``,
  ``check_model_axis``, ``Model`` and the launcher (before it looks for
  torchrun); axes the port's meshes lack (a model axis not named "model",
  data axes other than ("data",) or ("pod", "data")); and a caller's
  ``Parallelism`` whose mesh-given fields differ from the mesh's.  The
  layouts that were spec-only (``fsdp``, ``seq_shard``, ``ep_pod``, a pod
  axis) now pass ``check_supported``; ``ep_pod`` over a mesh without a pod
  axis raises naming the axis.  Every family lays out at M = 2 (full and
  reduced; reduced, each rank's leaves are its slices by ``param_specs``,
  the experts dealt whole under ``ep``), builds on one device and passes a
  data-only axis."""
  from repro_torch.launch import train as launch_train
  from repro_torch.models import Parallelism
  from repro_torch.models.registry import (check_model_axis, check_supported,
                                           mesh_parallelism, param_shapes)
  archs = ("deepseek-moe-16b", "grok-1-314b", "mamba2-2.7b",
           "recurrentgemma-2b", "llama-3.2-vision-90b", "whisper-tiny")
  for arch, bad in (("whisper-tiny", 5), ("recurrentgemma-2b", 3)):
    cfg = tconfigs.get_config(arch)
    check_supported(cfg, 2)
    check_supported(cfg, 4)   # inside the heads: the columns divide
    for check in (check_supported, check_model_axis):
      with pytest.raises(ValueError, match="whole query heads"):
        check(cfg, bad)
    with pytest.raises(ValueError, match="whole query heads"):
      launch_train.main(["--arch", arch, "--mesh", f"1x{bad}", "--device",
                         "cpu", "--steps", "1"])
  base = tconfigs.reduced(tconfigs.get_config("qwen3-4b"))
  for kw in (dict(fsdp=True), dict(seq_shard=True), dict(ep_pod=True),
             dict(dp_axes=("pod", "data"))):
    check_supported(base, 2, Parallelism(**kw))
  for kw in (dict(model_axis="tensor"), dict(dp_axes=("replica",))):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
      check_supported(base, 2, Parallelism(**kw))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
      Model(base, device="cpu", par=Parallelism(**kw))
  moe = tconfigs.reduced(tconfigs.get_config("deepseek-moe-16b"))
  with pytest.raises(ValueError, match="'pod'"):
    Model(moe, device="cpu", mesh=_stand_in_mesh(1, 2),
          par=Parallelism(dp_axes=("data",), dp_size=1, model_size=2,
                          ep_pod=True))
  with pytest.raises(ValueError, match="caller's to set"):
    Model(base, device="cpu", mesh=_stand_in_mesh(1, 2),
          par=Parallelism(dp_axes=("data",), dp_size=4, model_size=2))
  with pytest.raises(SystemExit, match="torchrun"):
    launch_train.main(["--arch", "grok-1-314b", "--reduced", "--mesh", "1x2",
                       "--device", "cpu", "--steps", "1"])
  for arch in archs:
    full = tconfigs.get_config(arch)
    check_supported(full, 2)
    cfg = tconfigs.reduced(full)
    check_supported(cfg)
    check_model_axis(cfg, 1)
    assert isinstance(Model(cfg, device="cpu"), Model)
    for ep in (False, True):
      mesh = _stand_in_mesh(1, 2, rank=1)
      par = mesh_parallelism(cfg, mesh, ep=ep)
      m = Model(cfg, device="cpu", mesh=mesh, par=par)
      shapes = param_shapes(cfg)
      for n, p in m.state_dict().items():
        assert tuple(p.shape) == mesh.local_shape(shapes[n], m.specs[n]), n
      assert m.sharded and m.shard is not None
      if cfg.moe.num_experts:
        assert m.shard.experts == ("ep" if ep else "tp")
        assert m.state_dict()["layers.0.moe.gate"].shape[0] == (
            cfg.moe.num_experts // 2 if ep else cfg.moe.num_experts)
    check_supported(cfg, 1, mesh_parallelism(cfg, _stand_in_mesh(2, 1)))


def test_temperature_sampling_is_valid_and_reproducible():
  _, _, tm = _models("qwen3-4b")
  prompt = {"tokens": torch.tensor(_tokens(tm.cfg, seed=14)[:, :S])}
  runs = [generate(tm, prompt, steps=6, temperature=0.8,
                   generator=torch.Generator().manual_seed(seed))
          for seed in (1, 1, 2)]
  for r in runs:
    assert r.shape == (B, 6) and r.dtype == torch.int64
    assert int(r.min()) >= 0 and int(r.max()) < tm.cfg.vocab
  assert torch.equal(runs[0], runs[1])
  assert not torch.equal(runs[0], runs[2])
  assert torch.equal(generate(tm, prompt, steps=3, temperature=0.8),
                     generate(tm, prompt, steps=3, temperature=0.8))
