"""The model axis of every family against the JAX reference, on the CPU
(gloo).

The six architectures beyond the dense stack (deepseek-moe-16b and
grok-1-314b: MoE; mamba2-2.7b: SSM; recurrentgemma-2b: RG-LRU with
windowed multi-query attention; llama-3.2-vision-90b: cross blocks;
whisper-tiny: encoder-decoder) at the reference's ``reduced`` size in
float32, the reference's ``Model.init`` parameters (zero-initialised gains
and biases replaced by numpy draws) carried across by
``interop.lm_params``.  Two torchrun launches side by side (world 2 and
world 4), every family inside each, while this process computes the
reference's outputs:

  * ``--mesh 1x2`` (world 2): ``apply_train``'s logits and aux, and the
    loss and every gradient one ``make_train_step`` step hands the
    optimizer (gathered to whole leaves), against the reference's
    ``apply_train`` and ``jax.value_and_grad`` of its ``loss_fn`` on the
    whole batch; the MoE also under ``ep=True`` (2 of the 4 reduced
    experts a rank); prefill + decode against teacher forcing (the
    reference's ``test_decode_matches_teacher_forcing``), recurrentgemma
    also past a prompt longer than its 32-row window; the replicated
    leaves' gradients equal on both ranks bit for bit;
  * ``--mesh 2x2`` (world 4): one step of every family (the MoE with
    groups of 64 tokens that drop pairs, under TP and under ``ep``), each
    data rank on its half of the rows, against one process on the whole
    batch (rank 0's twin); and ``--mesh 1x4`` where the KV heads are
    fewer than the ranks (reduced llama-3.2-vision-90b and qwen3-4b, 2 KV
    heads, qk-norm in the latter: each rank gathers the KV head its query
    heads read);
  * checkpoints (world 2): mamba2-2.7b's fused ``w_in``, deepseek-moe-16b's
    experts under ``ep`` and recurrentgemma-2b's RG-LRU leaves saved at
    1x2 restore onto 2x1 and onto one process bit for bit;
  * ``layers.gather_summed`` (world 2): each rank reads another part of
    the gathered activation; the gradient of each rank's slice equals one
    process's autograd of the summed function.

Tolerances: logits, aux, loss and gradients rtol 1e-5 (atol 1e-5 of the
largest |want|); decode against teacher forcing 2e-3 (the reference
test's); the 2x2 step 1e-5 of one process's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Parallelism as JParallelism  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.models import Model  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "mamba2-2.7b",
         "recurrentgemma-2b", "llama-3.2-vision-90b", "whisper-tiny"]
MOE = ("deepseek-moe-16b", "grok-1-314b")
CKPT = ("mamba2-2.7b", "deepseek-moe-16b", "recurrentgemma-2b")
KV4 = ("llama-3.2-vision-90b", "qwen3-4b")   # 2 KV heads over 1x4
PAR = JParallelism(dp_axes=(), dp_size=0)
B, S = 2, 23          # the 1x2 batch: tokens (B, S), labels, mask
B4, S4 = 4, 32        # the 2x2 batch: a data rank's 2 x 32 = 64 tokens
TOL = 1e-5
TOL_TF = 2e-3
DRAWN = ("ln1", "ln2", "lnx", "ln_f", "q_norm", "k_norm", "bq", "bk", "bv",
         "b_a", "b_i", "dt_bias", "norm")

# ``python script.py OUT INPUTS``: every case of the launch's world
RANK_SCRIPT = r'''
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import interop, no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import TrainMesh
from repro_torch.models import Model, Parallelism
from repro_torch.models.layers import gather_summed
from repro_torch.train import (CheckpointManager, OptConfig,
                               init_opt_state, make_train_step, tree_specs)
from repro_torch.train import train_step as TS

no_tf32()
OUT = sys.argv[1]
INP = dict(np.load(sys.argv[2]))
ARCHS = [str(a) for a in INP["archs"]]
MOE = [str(a) for a in INP["moe"]]
CKPT = [str(a) for a in INP["ckpt"]]
KV4 = [str(a) for a in INP["kv4"]]
OCFG = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
CPU = torch.device("cpu")


def weights(arch):
  tree = {}
  prefix = f"w/{arch}/"
  for key, arr in INP.items():
    if key.startswith(prefix):
      *path, leaf = key[len(prefix):].split("/")
      node = tree
      for p in path:
        node = node.setdefault(p, {})
      node[leaf] = arr
  return tree


def batch(arch, tag):
  prefix = f"{tag}/{arch}/"
  return {k[len(prefix):]: torch.tensor(v) for k, v in INP.items()
          if k.startswith(prefix)}


def config(arch, groups=False):
  cfg = reduced(get_config(arch))
  if groups and cfg.moe.num_experts:   # groups of 64 that drop pairs
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=64, capacity_factor=1.0))
  return cfg


def model(arch, mesh=None, ep=False, groups=False):
  cfg = config(arch, groups)
  par = None
  if ep:
    par = Parallelism(ep=True) if mesh is None else Parallelism(
        dp_axes=("data",), dp_size=mesh.data, model_size=mesh.model,
        ep=True)
  return interop.lm_params(Model(cfg, device="cpu", remat="dots", mesh=mesh,
                                 par=par), weights(arch))


def whole(m, t, n):
  return t if m.mesh is None else m.mesh.whole(t, m.specs[n])


def one_step(m, b, out, tag):
  """One train step: its metrics and the gradients it hands the
  optimizer, gathered whole; over a model axis also whether each
  replicated leaf's gradient has the same bits on every rank of the
  group."""
  seen = {}
  real = TS.adamw_update

  def handed(cfg_, params, grads, opt, **kw):
    seen.update({n: g.detach().clone() for n, g in grads.items()})
    return real(cfg_, params, grads, opt, **kw)

  TS.adamw_update = handed
  try:
    met = make_train_step(m, OCFG)(init_opt_state(m), b)
  finally:
    TS.adamw_update = real
  for k in ("loss", "xent", "aux", "grad_norm"):
    out[f"{tag}/{k}"] = met[k].numpy()
  for n, g in seen.items():
    out[f"{tag}/grad/{n}"] = whole(m, g, n).numpy()
  if m.tp is not None:
    same = [bool(all(torch.equal(q, parts[0]) for q in parts))
            for n, g in seen.items() if n not in m.sharded
            for parts in [m.tp.gather_parts(g.contiguous())]]
    out[f"{tag}/replicated_same"] = np.array(all(same) and len(same) > 0)


def forward(m, b, out, tag):
  with torch.no_grad():
    logits, aux = m.apply_train(b)
  out[f"{tag}/logits"] = logits.numpy()
  out[f"{tag}/aux"] = aux.numpy()


def decode(m, b, out, tag, prompt, total):
  """Prefill ``prompt`` tokens, decode to ``total``: the logits at
  prompt - 1 .. total - 1 beside teacher forcing's."""
  toks = b["tokens"][:, :total]
  full = dict(b, tokens=toks)
  with torch.no_grad():
    train, _ = m.apply_train(full)
    memory = m.memory(full)
  caches = m.init_cache(toks.shape[0], total, memory=memory)
  last, caches = m.prefill(dict(full, tokens=toks[:, :prompt]), caches,
                           memory)
  got = [last]
  for t in range(prompt, total):
    logits, caches = m.decode_step(toks[:, t:t + 1], t, caches)
    got.append(logits)
  out[f"{tag}/decode"] = torch.stack(got, 1).numpy()
  out[f"{tag}/teacher"] = train[:, prompt - 1:total].numpy()


def gather_case(mesh, out):
  """Each rank weighs another part of the gathered activation."""
  g = torch.Generator().manual_seed(4)
  x = torch.randn(3, 2 * mesh.tp.world, generator=g)
  w = torch.randn(3, 2 * mesh.tp.world, generator=g)
  r = mesh.tp.rank
  mine = x[:, 2 * r:2 * r + 2].clone().requires_grad_(True)
  full = gather_summed(mine, mesh.tp)
  part = (full.roll(r, dims=-1) * w).sum() * (r + 1)
  part.backward()
  out["gather/forward"] = full.detach().numpy()
  out["gather/grad"] = mine.grad.numpy()


def ckpt_case(arch, rank, out):
  """1x2 (ep for the MoE): one step, a mesh save; restore onto 2x1 and
  (rank 0) one process, each leaf's whole."""
  ck = CheckpointManager(f"{OUT}/ck_{arch}")
  mesh = TrainMesh.over(1, 2, rank, CPU, "gloo")
  ep = arch in MOE
  m = model(arch, mesh, ep=ep)
  opt = init_opt_state(m)
  make_train_step(m, OCFG)(opt, batch(arch, "b2"))
  specs = tree_specs(m.specs)
  ck.save(1, {"params": m.state_dict(), "opt": opt}, mesh=mesh, specs=specs)
  for n, p in m.state_dict().items():
    out[f"ckpt/{arch}/saved/{n}"] = whole(m, p, n).numpy()
  m21 = TrainMesh.over(2, 1, rank, CPU, "gloo")
  other = Model(config(arch), device="cpu", mesh=m21,
                generator=torch.Generator().manual_seed(99))
  tree, _ = ck.restore({"params": other.state_dict(),
                        "opt": init_opt_state(other)}, mesh=m21,
                       specs=tree_specs(other.specs))
  for n, p in tree["params"].items():
    out[f"ckpt/{arch}/2x1/{n}"] = p.numpy()
  if rank == 0:
    single = Model(config(arch), device="cpu",
                   generator=torch.Generator().manual_seed(98))
    tree, _ = ck.restore({"params": single.state_dict(),
                          "opt": init_opt_state(single)})
    for n, p in tree["params"].items():
      out[f"ckpt/{arch}/single/{n}"] = p.numpy()
  out[f"ckpt/{arch}/specs"] = np.array(sorted(
      f"{n}={m.specs[n]}" for n in m.sharded))


def main():
  world = int(INP["world"])
  base = TrainMesh.from_env((world, 1), "gloo", "cpu")
  rank = base.rank
  res, twins = {}, {}
  if world == 2:
    mesh = TrainMesh.over(1, 2, rank, CPU, "gloo")
    gather_case(mesh, res)
    for arch in ARCHS:
      b = batch(arch, "b2")
      for ep in ((False, True) if arch in MOE else (False,)):
        tag = f"{arch}/ep" if ep else f"{arch}/tp"
        m = model(arch, mesh, ep=ep)
        forward(m, b, res, tag)
        one_step(m, b, res, tag)
      m = model(arch, mesh)
      decode(m, batch(arch, "tf"), res, f"{arch}/tf", 16, 24)
      if arch == "recurrentgemma-2b":   # past the 32-row window
        decode(m, batch(arch, "tf"), res, f"{arch}/ring", 45, 51)
    for arch in CKPT:
      ckpt_case(arch, rank, res)
  else:
    mesh = TrainMesh.over(2, 2, rank, CPU, "gloo")
    d = mesh.coords["data"]
    for arch in ARCHS:
      b = batch(arch, "b4")
      rows = b["tokens"].shape[0] // mesh.data
      mine = {k: v[d * rows:(d + 1) * rows] for k, v in b.items()}
      for ep in ((False, True) if arch in MOE else (False,)):
        tag = f"{arch}/{'ep' if ep else 'tp'}"
        one_step(model(arch, mesh, ep=ep, groups=True), mine, res, tag)
        if rank == 0:
          one_step(model(arch, ep=ep, groups=True), b, twins, tag)
    mesh = TrainMesh.over(1, 4, rank, CPU, "gloo")
    for arch in KV4:
      m = model(arch, mesh)
      assert m.shard.kv_gather and m.lcfg.n_kv_heads == 1
      one_step(m, batch(arch, "b4"), res, f"{arch}/1x4")
      if rank == 0:
        one_step(model(arch), batch(arch, "b4"), twins, f"{arch}/1x4")
  np.savez(f"{OUT}/rank{rank}.npz", **res)
  if twins:
    np.savez(f"{OUT}/twin.npz", **twins)
  base.close()


main()
'''


def _close(got, want, tol, what=""):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6),
                             err_msg=what)


def _flat(tree, prefix=""):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f"{prefix}{k}/"))
    else:
      out[prefix + k] = np.asarray(v)
  return out


def _reference(arch):
  """(reference model, its params as numpy, gains and biases drawn)."""
  jm = j_build_model(jconfigs.reduced(jconfigs.get_config(arch)), remat=None)
  params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
  r = np.random.default_rng(8)

  def draw(path, leaf):
    if str(getattr(path[-1], "key", "")) in DRAWN:
      return leaf + r.normal(scale=0.2, size=leaf.shape).astype(leaf.dtype)
    return leaf

  return jm, jax.tree_util.tree_map_with_path(draw, params)


def _batch(cfg, seed, b, s, masked=True):
  """tokens / labels (b, s) int64, mask (a few zeros), the family's
  memory input, as numpy."""
  r = np.random.default_rng(seed)
  toks = r.integers(0, cfg.vocab, size=(b, s + 1))
  mask = np.ones((b, s), np.float32)
  if masked:
    mask[0, :5] = 0.0
  out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
  if cfg.family == "encdec":
    out["frames"] = r.normal(size=(b, cfg.encoder.n_frames,
                                   cfg.d_model)).astype(np.float32)
  if cfg.family == "vlm":
    out["img_embeds"] = r.normal(size=(b, cfg.n_img_tokens,
                                       cfg.d_model)).astype(np.float32)
  return out


def _launch(tmp, world, inputs):
  out = tmp / f"world{world}"
  out.mkdir()
  script = tmp / "ranks.py"
  if not script.exists():
    script.write_text(RANK_SCRIPT)
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1")
  cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), str(script), str(out), str(inputs)]
  return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True), out


def _jax_run(arch, jm, params, batch):
  """The reference's teacher-forcing logits and aux, and its loss and
  gradients (keyed by the port's names) on ``batch``."""
  jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
        for k, v in batch.items()}
  jp = jax.tree.map(jnp.asarray, params)
  logits, aux = jm.apply_train(jp, jb, PAR)
  (loss, met), grads = jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, PAR), has_aux=True)(jp)
  tm = Model(tconfigs.reduced(tconfigs.get_config(arch)), device="cpu")
  grads = {n: t.numpy() for n, t in interop.lm_tree(
      tm, jax.tree.map(np.asarray, grads)).items()}
  return dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss),
              xent=float(met["xent"]), grads=grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both worlds launched side by side beside the reference's results:
  ({world: [rank results]}, rank 0's 2x2 twins, {arch: reference})."""
  tmp = tmp_path_factory.mktemp("families_tp")
  refs, inputs = {}, {"archs": np.array(ARCHS), "moe": np.array(MOE),
                      "ckpt": np.array(CKPT), "kv4": np.array(KV4)}
  _, params = _reference("qwen3-4b")
  inputs.update({f"w/qwen3-4b/{k}": v for k, v in _flat(params).items()})
  inputs.update({f"b4/qwen3-4b/{k}": v for k, v in _batch(
      jconfigs.reduced(jconfigs.get_config("qwen3-4b")), 50, B4, S4,
      masked=False).items()})
  for i, arch in enumerate(ARCHS):
    jm, params = _reference(arch)
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    refs[arch] = (jm, params, _batch(cfg, 20 + i, B, S))
    inputs.update({f"w/{arch}/{k}": v for k, v in _flat(params).items()})
    for tag, b in (("b2", refs[arch][2]),
                   ("b4", _batch(cfg, 30 + i, B4, S4, masked=False)),
                   ("tf", _batch(cfg, 40 + i, B, 51))):
      inputs.update({f"{tag}/{arch}/{k}": v for k, v in b.items()})
  procs = {}
  for world in (2, 4):
    path = tmp / f"inputs{world}.npz"
    np.savez(path, world=np.array(world), **inputs)
    procs[world] = _launch(tmp, world, path)
  want = {arch: _jax_run(arch, *refs[arch]) for arch in ARCHS}
  ranks, twins = {}, None
  for world, (proc, out) in procs.items():
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    ranks[world] = [dict(np.load(out / f"rank{r}.npz"))
                    for r in range(world)]
    if world == 4:
      twins = dict(np.load(out / "twin.npz"))
  return ranks, twins, want


CASES = [(a, "tp") for a in ARCHS] + [(a, "ep") for a in MOE]


@pytest.mark.parametrize("arch,layout", CASES)
def test_model_axis_forward_matches_reference(runs, arch, layout):
  """1x2: teacher-forcing logits and aux against the reference's
  ``apply_train`` on the whole batch; both ranks hold the same bits."""
  ranks, _, want = runs
  got = ranks[2]
  tag = f"{arch}/{layout}"
  assert got[0][f"{tag}/logits"].shape == want[arch]["logits"].shape
  _close(got[0][f"{tag}/logits"], want[arch]["logits"], TOL, "logits")
  _close(got[0][f"{tag}/aux"], want[arch]["aux"], TOL, "aux")
  assert (want[arch]["aux"] > 0) == (arch in MOE)
  assert np.array_equal(got[0][f"{tag}/logits"], got[1][f"{tag}/logits"])


@pytest.mark.parametrize("arch,layout", CASES)
def test_model_axis_loss_and_gradients_match_reference(runs, arch, layout):
  """1x2: the loss, xent and aux of one train step and every gradient it
  hands the optimizer (gathered whole) against ``jax.value_and_grad`` of
  the reference's ``loss_fn``; every replicated leaf's gradient has the
  same bits on both ranks."""
  ranks, _, want = runs
  got = ranks[2][0]
  tag = f"{arch}/{layout}"
  _close(got[f"{tag}/loss"], want[arch]["loss"], TOL, "loss")
  _close(got[f"{tag}/xent"], want[arch]["xent"], TOL, "xent")
  grads = want[arch]["grads"]
  assert sorted(grads) == sorted(k[len(f"{tag}/grad/"):] for k in got
                                 if k.startswith(f"{tag}/grad/"))
  for n, g in grads.items():
    _close(got[f"{tag}/grad/{n}"], g, TOL, n)
  assert bool(got[f"{tag}/replicated_same"])
  for n in grads:
    assert np.array_equal(got[f"{tag}/grad/{n}"],
                          ranks[2][1][f"{tag}/grad/{n}"]), n


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_decode_matches_teacher_forcing(runs, arch):
  """1x2: prefill (16 tokens) + decode to 24 equals the teacher-forcing
  forward position by position; recurrentgemma-2b also past its window
  (a 45-token prompt in a 32-row ring, decoded to 51)."""
  got = runs[0][2][0]
  tags = [f"{arch}/tf"] + ([f"{arch}/ring"] if arch == "recurrentgemma-2b"
                           else [])
  for tag in tags:
    _close(got[f"{tag}/decode"], got[f"{tag}/teacher"], TOL_TF, tag)


@pytest.mark.parametrize("arch,layout", CASES)
def test_data_and_model_axes_match_one_process(runs, arch, layout):
  """2x2: the loss, xent, aux and grad norm and every gradient handed to
  the optimizer (gathered whole) against one process's step on the whole
  batch; the MoE's groups of 64 tokens drop pairs, each data rank holding
  one; every rank hands the optimizer the same whole gradients."""
  ranks, twins, _ = runs
  got = ranks[4]
  tag = f"{arch}/{layout}"
  for k in ("loss", "xent", "aux", "grad_norm"):
    _close(got[0][f"{tag}/{k}"], twins[f"{tag}/{k}"], TOL, k)
  grads = sorted(k for k in twins if k.startswith(f"{tag}/grad/"))
  assert grads
  for k in grads:
    _close(got[0][k], twins[k], TOL, k)
    for r in range(1, 4):
      assert np.array_equal(got[0][k], got[r][k]), (k, r)
  assert all(bool(got[r][f"{tag}/replicated_same"]) for r in range(4))


@pytest.mark.parametrize("arch", KV4)
def test_model_axis_past_the_kv_heads_matches_one_process(runs, arch):
  """1x4 with 2 KV heads: the loss, xent and grad norm and every gradient
  handed to the optimizer (gathered whole; the qk-norm gains summed over
  the group) against one process's step; the replicated leaves' bits
  equal on every rank."""
  ranks, twins, _ = runs
  got = ranks[4]
  tag = f"{arch}/1x4"
  for k in ("loss", "xent", "grad_norm"):
    _close(got[0][f"{tag}/{k}"], twins[f"{tag}/{k}"], TOL, k)
  grads = sorted(k for k in twins if k.startswith(f"{tag}/grad/"))
  assert grads
  for k in grads:
    _close(got[0][k], twins[k], TOL, k)
  assert all(bool(got[r][f"{tag}/replicated_same"]) for r in range(4))


@pytest.mark.parametrize("arch", CKPT)
def test_model_axis_checkpoint_restores_across_layouts(runs, arch):
  """A 1x2 state (the MoE under ``ep``) saved, restored onto 2x1 and onto
  one process: every leaf's whole bit for bit, the family's split leaves
  among them."""
  got = runs[0][2]
  saved = {k.split("/saved/")[1]: v for k, v in got[0].items()
           if k.startswith(f"ckpt/{arch}/saved/")}
  specs = " ".join(str(s) for s in got[0][f"ckpt/{arch}/specs"])
  want = {"mamba2-2.7b": "mamba.w_in=(None, 'model')",
          "deepseek-moe-16b": "moe.gate=('model', None, None)",
          "recurrentgemma-2b": "rec.w_a=(None, 'model')"}[arch]
  assert want in specs
  for n, w in saved.items():
    for r in range(2):
      assert np.array_equal(got[r][f"ckpt/{arch}/2x1/{n}"], w), (n, r)
      assert np.array_equal(got[r][f"ckpt/{arch}/saved/{n}"], w), (n, r)
    assert np.array_equal(got[0][f"ckpt/{arch}/single/{n}"], w), n


def test_gather_summed_backward_matches_one_process(runs):
  """``layers.gather_summed`` over 2 ranks: the gathered whole forward,
  and each rank's gradient equal to one process's autograd of the ranks'
  functions summed, at the rank's slice."""
  got = runs[0][2]
  g = torch.Generator().manual_seed(4)
  x = torch.randn(3, 4, generator=g).requires_grad_(True)
  w = torch.randn(3, 4, generator=g)
  total = sum((x.roll(r, dims=-1) * w).sum() * (r + 1) for r in range(2))
  total.backward()
  for r in range(2):
    np.testing.assert_array_equal(got[r]["gather/forward"],
                                  x.detach().numpy())
    np.testing.assert_allclose(got[r]["gather/grad"],
                               x.grad[:, 2 * r:2 * r + 2].numpy(),
                               rtol=1e-6, atol=1e-6)
