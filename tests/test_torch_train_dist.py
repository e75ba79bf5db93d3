"""The port's training over processes against a one-process stacked twin
and against the JAX reference, on the CPU (gloo).

Ranks are started with ``python -m torch.distributed.run --standalone``
on a script in ``tmp_path``, one launch at world 2 and one at world 4,
side by side; each runs every case of its world and writes an ``.npz``
(rank 0 also runs the one-process twins).  The model is reduced qwen3-4b
in float32 (remat "dots", so the collectives run again in the recomputed
forward), its weights the reference's ``Model.init`` through
``interop.lm_params`` (the norm gains drawn, as in
tests/test_torch_train.py), three steps on batches of 4 x 16.

  * data axis (2x1, 4x1): every rank's parameters, losses and grad norms
    equal the stacked twin's bit for bit (each shard's gradient, then
    ``fold_sum`` in rank order / D, then ``adamw_update`` with the mesh's
    float64 norm), and the
    parameters are within tolerance of the reference's full-batch
    ``make_train_step``: 2 x lr per element, 99.9 % within 1e-5, as
    tests/test_torch_train.py holds one process;
  * model axis (1x2): the loss and grad norm within 1e-5 relative, the
    parameters within 2 x lr per element and 99.9 % within 1e-5 of the
    one-process port; the eval loss and the teacher-forced, prefill and
    decode logits within 1e-5 (of the largest |logit|); the replicated
    leaves equal across the group bit for bit; with qkv biases (reduced
    qwen1.5-4b) every gradient the optimizer is handed within 1e-5 of the
    one-process port's;
  * compression: the reference's ``jax.random`` noise in, the codes and
    scales equal the reference's ``_quantize`` bit for bit, the mean and
    the new residual within 1e-6 of ``compressed_psum`` on 4 host devices
    (``tests/conftest.py``'s ``subrun`` run alongside); the
    error-feedback oracle (rel < 0.02 over 10 steps) with
    the port's generator;
  * checkpoints: the elastic-reshard oracle (a leaf split over 2 ranks
    restored over 4), a same-layout resume equal to the uninterrupted run
    bit for bit, cross-layout restores (1x2 -> 2x1 and one process, 2x2 ->
    4x1 and one process, one process -> 1x2 and 2x2) that give back the
    saved leaves bit for bit;
  * the launcher: ``--reduced --mesh 2x2`` (losses as one process's), a
    resume at ``--mesh 4x1``, and each refusal.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Parallelism as JParallelism  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.train_step import make_train_step as j_train_step  # noqa
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import Parallelism as TParallelism  # noqa: E402
from repro_torch.models import param_shapes, param_specs  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
STEPS, B, S = 3, 4, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DRAWN = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")
TOL = 1e-5          # losses, norms, logits (relative); 99.9 % of params
TOL_MEAN = 1e-6     # the compressed mean against the reference's pmean
NOISE_KEY = 5       # the reference's key for the compression parity

# One script, every case of a world; ``python script.py OUT INPUTS``.
RANK_SCRIPT = r'''
import sys

import numpy as np
import torch

from repro_torch import interop, no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import TrainMesh, fold_sum
from repro_torch.models import Model
from repro_torch.train import (CheckpointManager, OptConfig, adamw_update,
                               init_opt_state, make_compressed_allreduce,
                               make_eval_step, make_train_step, tree_specs)
from repro_torch.train import compression as C
from repro_torch.train import train_step as TS

no_tf32()
CFG = reduced(get_config("qwen3-4b"))
OCFG = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
OUT = sys.argv[1]
INP = dict(np.load(sys.argv[2]))
STEPS = int(INP["steps"])
CPU = torch.device("cpu")


def nested(prefix):
  tree = {}
  for key, arr in INP.items():
    if key.startswith(prefix):
      *path, leaf = key[len(prefix):].split("/")
      node = tree
      for p in path:
        node = node.setdefault(p, {})
      node[leaf] = arr
  return tree


WEIGHTS = nested("w/")
BATCHES = [{k: torch.tensor(INP[f"batch{t}/{k}"]) for k in
            ("tokens", "labels", "mask")} for t in range(STEPS)]


def shard(batch, d, n):
  rows = batch["tokens"].shape[0] // n
  return {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}


def model(mesh=None):
  return interop.lm_params(Model(CFG, device="cpu", remat="dots",
                                 mesh=mesh), WEIGHTS)


def params_of(m, prefix, out):
  for n, p in m.state_dict().items():
    out[f"{prefix}/{n}"] = p.detach().clone().numpy()


def tree_of(m, opt):
  return {"params": m.state_dict(), "opt": opt}


def data_case(rank, world, res, twins):
  """D = world data ranks, three steps; rank 0 also the stacked twin."""
  mesh = TrainMesh.over(world, 1, rank, CPU, "gloo")
  d, D = mesh.coords["data"], mesh.data
  m = model(mesh)
  opt = init_opt_state(m)
  step = make_train_step(m, OCFG)
  for t, b in enumerate(BATCHES):
    met = step(opt, shard(b, d, D))
    res[f"data/step{t}/loss"] = met["loss"].numpy()
    res[f"data/step{t}/grad_norm"] = met["grad_norm"].numpy()
    params_of(m, f"data/step{t}", res)
  res["data/gathers"] = np.array(mesh.gathers)
  if rank:
    return
  tm = model()
  opt = init_opt_state(tm)
  params = dict(tm.named_parameters())
  for t, b in enumerate(BATCHES):
    grads, stats = [], []
    for d in range(D):
      for p in params.values():
        p.grad = None
      loss, met = tm.loss_fn(shard(b, d, D))
      loss.backward()
      grads.append({n: p.grad.clone() for n, p in params.items()})
      stats.append(torch.stack([met["xent"], met["aux"], loss]).detach())
    mean = {n: fold_sum([g[n] for g in grads], D) for n in params}
    # the norm as a mesh sums it (float64; no leaf is split over D x 1)
    om = adamw_update(OCFG, params, mean, opt, mesh=mesh)
    twins[f"data/step{t}/loss"] = fold_sum(stats, D)[2].numpy()
    twins[f"data/step{t}/grad_norm"] = om["grad_norm"].numpy()
    params_of(tm, f"data/step{t}", twins)


def model_case(rank, res, twins):
  """1x2 (world 2): three steps on the whole batch beside the one-process
  port; the eval loss and the logits first."""
  mesh = TrainMesh.over(1, 2, rank, CPU, "gloo")
  for tag, m in (("model", model(mesh)),) + ((("one", model()),)
                                             if rank == 0 else ()):
    out = res if tag == "model" else twins
    b = BATCHES[0]
    out["model/eval_loss"] = make_eval_step(m)(b)["loss"].numpy()
    with torch.no_grad():
      out["model/logits"] = m.apply_train(b)[0].numpy()
    caches = m.init_cache(b["tokens"].shape[0], 12)
    first, caches = m.prefill({"tokens": b["tokens"][:, :8]}, caches)
    out["model/prefill"] = first.numpy()
    for pos in (8, 9):
      logits, caches = m.decode_step(b["tokens"][:, pos:pos + 1], pos,
                                     caches)
      out[f"model/decode{pos}"] = logits.numpy()
    opt = init_opt_state(m)
    step = make_train_step(m, OCFG)
    for t, b in enumerate(BATCHES):
      met = step(opt, b)
      out[f"model/step{t}/loss"] = met["loss"].numpy()
      out[f"model/step{t}/grad_norm"] = met["grad_norm"].numpy()
      params_of(m, f"model/step{t}", out)
      if tag == "model":
        for n, p in m.state_dict().items():  # the whole leaves
          res[f"model/whole{t}/{n}"] = mesh.whole(
              p, m.specs[n]).clone().numpy()
    if tag == "model":
      res["model/sharded"] = np.array(sorted(m.sharded))
  return mesh


def bf16_case(mesh, rank, res):
  """A bfloat16 tensor through the model group (gloo has no bfloat16: it
  goes over as bytes): the parts, the rank-ordered sum."""
  x = (torch.arange(15.0).reshape(3, 5) / 7 + rank).to(torch.bfloat16)
  res["bf16/parts"] = torch.stack(mesh.tp.gather_parts(x)).float().numpy()
  res["bf16/sum"] = mesh.tp.sum(x).float().numpy()
  res["bf16/dtype"] = np.array(str(mesh.tp.sum(x).dtype))


def micro_case(mesh, rank, res, twins):
  """1x2 with two microbatches of 2 rows, beside one process's."""
  mb = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])
        for k, v in BATCHES[0].items()}
  for tag, m in (("model", model(mesh)),) + ((("one", model()),)
                                             if rank == 0 else ()):
    out = res if tag == "model" else twins
    met = make_train_step(m, OCFG, microbatches=2)(init_opt_state(m), mb)
    out["micro/loss"] = met["loss"].numpy()
    out["micro/grad_norm"] = met["grad_norm"].numpy()


def bias_case(mesh, rank, res, twins):
  """1x2 with qkv biases (reduced qwen1.5-4b, the port's own weights from
  one seed, the biases drawn): two steps beside one process, with the
  gradients the optimizer is handed at the first (whole leaves)."""
  cfg = reduced(get_config("qwen1.5-4b"))
  biases = np.random.default_rng(9)
  draws = {}
  for tag, m in (("model", Model(cfg, device="cpu", mesh=mesh)),) + (
      (("one", Model(cfg, device="cpu")),) if rank == 0 else ()):
    out = res if tag == "model" else twins
    with torch.no_grad():
      for n, p in m.named_parameters():
        if n.endswith((".bq", ".bk", ".bv")):
          if n not in draws:
            draws[n] = biases.normal(scale=0.5, size=p.shape)
          p.copy_(torch.tensor(draws[n], dtype=p.dtype))
    seen = {}
    real = TS.adamw_update

    def handed(cfg_, params, grads, opt, **kw):
      seen.update({n: g.detach().clone() for n, g in grads.items()})
      return real(cfg_, params, grads, opt, **kw)

    TS.adamw_update = handed
    try:
      opt = init_opt_state(m)
      step = make_train_step(m, OCFG)
      for t, b in enumerate(BATCHES[:2]):
        met = step(opt, b)
        out[f"bias/step{t}/loss"] = met["loss"].numpy()
        out[f"bias/step{t}/grad_norm"] = met["grad_norm"].numpy()
        for n, p in m.state_dict().items():
          out[f"bias/whole{t}/{n}"] = (p if tag == "one" else mesh.whole(
              p, m.specs[n])).detach().clone().numpy()
        if t == 0:
          for n, g in seen.items():
            out[f"bias/grad/{n}"] = (g if tag == "one" else mesh.whole(
                g, m.specs[n])).clone().numpy()
    finally:
      TS.adamw_update = real


def resume_case(mesh, res):
  """1x2: two steps, a mesh save, a fresh model restored, one step."""
  ck = CheckpointManager(f"{OUT}/ck_1x2")
  m = model(mesh)
  opt = init_opt_state(m)
  step = make_train_step(m, OCFG)
  for b in BATCHES[:2]:
    step(opt, b)
  specs = tree_specs(m.specs)
  ck.save(2, tree_of(m, opt), mesh=mesh, specs=specs)
  m2 = Model(CFG, device="cpu", remat="dots", mesh=mesh,
             generator=torch.Generator().manual_seed(99))
  tree, meta = ck.restore(tree_of(m2, init_opt_state(m2)), mesh=mesh,
                          specs=specs)
  m2.load_state_dict(tree["params"])
  make_train_step(m2, OCFG)(tree["opt"], BATCHES[2])
  params_of(m2, "resume", res)
  res["resume_meta_step"] = np.array(meta["step"])


def restore_case(tag, shape, src, rank, res, single):
  """Restore checkpoint ``src`` onto a ``shape`` mesh (and, on rank 0,
  onto one process): the whole of every restored leaf."""
  ck = CheckpointManager(src)
  mesh = TrainMesh.over(*shape, rank, CPU, "gloo")
  m = Model(CFG, device="cpu", mesh=mesh,
            generator=torch.Generator().manual_seed(98))
  specs = tree_specs(m.specs)
  tree, _ = ck.restore(tree_of(m, init_opt_state(m)), mesh=mesh, specs=specs)
  for key, leaf in _leaves(tree).items():
    res[f"{tag}/{key}"] = mesh.whole(leaf, specs.get(key, ())).numpy()
  if rank == 0 and single:
    one = Model(CFG, device="cpu", generator=torch.Generator().manual_seed(97))
    tree, _ = ck.restore(tree_of(one, init_opt_state(one)))
    for key, leaf in _leaves(tree).items():
      res[f"{tag}_single/{key}"] = leaf.numpy()


def _leaves(tree, prefix=""):
  if isinstance(tree, dict):
    items = tree.items()
  elif hasattr(tree, "_fields"):
    items = zip(tree._fields, tree)
  else:
    return {prefix.rstrip("/"): tree}
  out = {}
  for k, v in items:
    out.update(_leaves(v, f"{prefix}{k}/"))
  return out


def save_case(tag, shape, rank):
  """One step on a ``shape`` mesh, then a mesh save to OUT/ck_<tag>."""
  mesh = TrainMesh.over(*shape, rank, CPU, "gloo")
  m = model(mesh)
  opt = init_opt_state(m)
  make_train_step(m, OCFG)(opt, shard(BATCHES[0], mesh.coords["data"],
                                      mesh.data))
  CheckpointManager(f"{OUT}/ck_{tag}").save(
      1, tree_of(m, opt), extra={"layout": tag}, mesh=mesh,
      specs=tree_specs(m.specs))


def compression_case(rank, res):
  """4x1: the reference-noise parity and the error-feedback oracle."""
  mesh = TrainMesh.over(4, 1, rank, CPU, "gloo")
  grads = {k: torch.tensor(INP[f"cmp/grads_{k}"][rank]) for k in "ab"}
  error = {k: torch.tensor(INP[f"cmp/error_{k}"][rank]) for k in "ab"}
  noise = torch.tensor(INP["cmp/noise"][rank])
  flat = torch.cat([grads[k].reshape(-1) + error[k].reshape(-1)
                    for k in "ab"])
  flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % C.BLOCK))
  codes, scales = C.quantize(flat, noise)
  res["cmp/codes"], res["cmp/scales"] = codes.numpy(), scales.numpy()
  fn = make_compressed_allreduce(mesh, ("data",), {"a": (None, None),
                                                   "b": (None,)})
  g0 = mesh.gathers
  mean, new_err = fn(grads, error, noise)
  res["cmp/gathers"] = np.array(mesh.gathers - g0)
  res["cmp/wire_bytes"] = np.array(mesh.gather_bytes)
  for k in "ab":
    res[f"cmp/mean_{k}"] = mean[k].numpy()
    res[f"cmp/new_error_{k}"] = new_err[k].numpy()
  # the reference test's oracle: 10 steps of (4, 1024) with feedback
  full = torch.tensor(INP["cmp/ef_grads"])
  gen = torch.Generator().manual_seed(rank)
  err = None
  acc = torch.zeros(full.shape[1])
  exact = torch.zeros(full.shape[1])
  for t in range(10):
    g = full * (1.0 + 0.1 * t)
    avg, err = C.compressed_psum([g[rank]], err, C.draw_noise(
        C.padded_size([g[rank]]), gen), mesh.dp)
    acc += avg[0]
    exact += g.mean(0)
  res["cmp/ef_rel"] = np.array(float((acc - exact).abs().max()
                                     / exact.abs().max()))


def elastic_case(rank, res):
  """The reference's oracle: a (4, 4) leaf split over the data axis of a
  2x2 mesh (2 ranks) saved, restored over 4 data ranks."""
  full = torch.arange(16.0).reshape(4, 4)
  spec = {"w": ("data", None)}
  m22 = TrainMesh.over(2, 2, rank, CPU, "gloo")
  ck = CheckpointManager(f"{OUT}/ck_elastic")
  ck.save(5, {"w": m22.local(full, spec["w"])}, mesh=m22, specs=spec)
  m41 = TrainMesh.over(4, 1, rank, CPU, "gloo")
  tree, meta = ck.restore({"w": torch.zeros(1, 4)}, mesh=m41, specs=spec)
  res["elastic/local"] = tree["w"].numpy()
  res["elastic/whole"] = m41.whole(tree["w"], spec["w"]).numpy()
  res["elastic/step"] = np.array(meta["step"])


def main():
  base = TrainMesh.from_env((int(INP["world"]), 1), "gloo", "cpu")
  rank, world = base.rank, base.data
  res, twins = {}, {}
  data_case(rank, world, res, twins)
  if world == 2:
    mesh = model_case(rank, res, twins)
    micro_case(mesh, rank, res, twins)
    bias_case(mesh, rank, res, twins)
    bf16_case(mesh, rank, res)
    resume_case(mesh, res)
    restore_case("to_2x1", (2, 1), f"{OUT}/ck_1x2", rank, res, True)
    restore_case("single_to_1x2", (1, 2), str(INP["single_ck"]), rank, res,
                 False)
  else:
    compression_case(rank, res)
    elastic_case(rank, res)
    save_case("2x2", (2, 2), rank)
    restore_case("to_4x1", (4, 1), f"{OUT}/ck_2x2", rank, res, True)
    restore_case("single_to_2x2", (2, 2), str(INP["single_ck"]), rank, res,
                 False)
  np.savez(f"{OUT}/rank{rank}.npz", **res)
  if twins:
    np.savez(f"{OUT}/twin.npz", **twins)
  base.close()


main()
'''

COMPRESSION_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.train.compression import compressed_psum
from repro.util import make_mesh, shard_map
inp = dict(np.load({inputs!r}))
mesh = make_mesh((4,), ("data",))

@partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data"), P("data"),
                                         P("data"), P()),
         out_specs=(P("data"), P("data"), P("data"), P("data")))
def f(a, b, ea, eb, key):
  avg, err = compressed_psum({{"a": a[0], "b": b[0]}}, {{"a": ea[0],
                             "b": eb[0]}},
                             jax.random.fold_in(key, jax.lax.axis_index(
                                 "data")), ("data",))
  return avg["a"][None], avg["b"][None], err["a"][None], err["b"][None]

out = f(*(jnp.asarray(inp[k]) for k in ("cmp/grads_a", "cmp/grads_b",
                                         "cmp/error_a", "cmp/error_b")),
        jax.random.PRNGKey({key}))
np.savez({result!r}, **dict(zip(("mean_a", "mean_b", "new_error_a",
                                 "new_error_b"), map(np.asarray, out))))
print("JAX_DONE")
"""


def _flat_keys(tree, prefix=""):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat_keys(v, f"{prefix}{k}/"))
    else:
      out[prefix + k] = np.asarray(v)
  return out


def _reference():
  """(reference model, its params as numpy with the norm gains drawn, the
  port's config)."""
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


def _batches(vocab):
  r = np.random.default_rng(3)
  out = []
  for _ in range(STEPS):
    toks = r.integers(0, vocab, size=(B, S + 1)).astype(np.int64)
    out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": np.ones((B, S), np.float32)})
  return out


def _compression_inputs():
  """Per-rank gradients of two leaves (1000 elements, padded to 1024),
  residuals, and each rank's noise from the reference's key chain
  (``fold_in(PRNGKey(NOISE_KEY), rank)``, the draw ``_quantize`` makes)."""
  r = np.random.default_rng(11)
  a = r.normal(size=(4, 10, 50)).astype(np.float32)
  b = (r.normal(size=(4, 500)) * np.linspace(0.01, 3.0, 500)).astype(
      np.float32)
  ea = (0.01 * r.normal(size=a.shape)).astype(np.float32)
  eb = (0.01 * r.normal(size=b.shape)).astype(np.float32)
  keys = [jax.random.fold_in(jax.random.PRNGKey(NOISE_KEY), k)
          for k in range(4)]
  noise = np.stack([np.asarray(jax.random.uniform(k, (4, 256)) - 0.5)
                    .reshape(-1) for k in keys])
  codes, scales = [], []
  for k in range(4):
    flat = np.concatenate([a[k].reshape(-1) + ea[k].reshape(-1),
                           b[k] + eb[k], np.zeros(24, np.float32)])
    q, s = JC._quantize(jnp.asarray(flat), keys[k])
    codes.append(np.asarray(q))
    scales.append(np.asarray(s))
  ef = np.random.default_rng(0).normal(size=(4, 1024)).astype(np.float32)
  return ({"cmp/grads_a": a, "cmp/grads_b": b, "cmp/error_a": ea,
           "cmp/error_b": eb, "cmp/noise": noise, "cmp/ef_grads": ef},
          np.stack(codes), np.stack(scales))


def _single_checkpoint(path, params, tcfg, batch):
  """A one-process port checkpoint after one step (the source of the
  single -> mesh restores)."""
  m = interop.lm_params(Model(tcfg, device="cpu"), params)
  opt = init_opt_state(m)
  make_train_step(m, OptConfig(**OCFG))(opt, {k: torch.tensor(v)
                                              for k, v in batch.items()})
  CheckpointManager(path).save(1, {"params": m.state_dict(), "opt": opt})


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


def _finish(proc, out, world):
  log, _ = proc.communicate(timeout=300)
  assert proc.returncode == 0, log
  ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
  return ranks, dict(np.load(out / "twin.npz")), out


def _jax_devices(script: str, n_devices: int):
  """``tests/conftest.py``'s ``subrun`` started in the background."""
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
  return subprocess.Popen([sys.executable, "-c", script], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both worlds launched side by side beside the reference's full-batch
  steps and its compressed mean; {world: (ranks, rank 0's twins, out
  dir)}, the reference's results and the inputs."""
  tmp = tmp_path_factory.mktemp("train_dist")
  jm, params, tcfg = _reference()
  batches = _batches(tcfg.vocab)
  cmp_inputs, ref_codes, ref_scales = _compression_inputs()
  _single_checkpoint(str(tmp / "ck_single"), params, tcfg, batches[0])
  inputs = {f"w/{k}": v for k, v in _flat_keys(params).items()}
  for t, b in enumerate(batches):
    inputs.update({f"batch{t}/{k}": v for k, v in b.items()})
  inputs.update(cmp_inputs, steps=np.array(STEPS),
                single_ck=str(tmp / "ck_single"))
  started = {}
  for world in WORLDS:
    path = tmp / f"inputs{world}.npz"
    np.savez(path, **inputs, world=np.array(world))
    started[world] = _launch(tmp, world, path)
  jax_cmp = _jax_devices(COMPRESSION_SCRIPT.format(
      inputs=str(tmp / "inputs4.npz"), key=NOISE_KEY,
      result=str(tmp / "jax_cmp.npz")), 4)
  # the reference: full-batch steps, and its compressed mean
  step = jax.jit(j_train_step(jm, JO.OptConfig(**OCFG),
                              JParallelism(dp_axes=(), dp_size=0)))
  p, opt = params, JO.init_opt_state(params)
  ref = {}
  stub = types.SimpleNamespace(cfg=tcfg)
  for t, b in enumerate(batches):
    p, opt, met = step(p, opt, {k: jnp.asarray(v) if k == "mask" else
                                jnp.asarray(v, jnp.int32)
                                for k, v in b.items()})
    ref[f"step{t}/loss"] = float(met["loss"])
    for n, v in interop.lm_tree(stub, jax.tree.map(np.asarray, p)).items():
      ref[f"step{t}/{n}"] = v.numpy()
  out, _ = jax_cmp.communicate(timeout=300)
  assert jax_cmp.returncode == 0 and "JAX_DONE" in out, out
  ref.update({f"cmp/{k}": v for k, v in np.load(tmp / "jax_cmp.npz").items()})
  ref["cmp/codes"], ref["cmp/scales"] = ref_codes, ref_scales
  return ({w: _finish(*started[w], w) for w in WORLDS}, ref, inputs)


def _params(res, prefix):
  """The parameters recorded under ``prefix`` by name."""
  out = {k[len(prefix) + 1:]: v for k, v in res.items()
         if k.startswith(prefix + "/")}
  return {k: v for k, v in out.items() if k not in ("loss", "grad_norm")}


def _close_params(got, want, lr, what):
  """2 x lr per element (Adam's step bounds a sign flip of a near-zero
  gradient) and 99.9 % of the elements within TOL."""
  assert sorted(got) == sorted(want), what
  n = bad = 0
  worst = {}
  for name in want:
    diff = np.abs(np.asarray(got[name], np.float64) - want[name])
    assert diff.max() <= 2 * lr, (what, name, diff.max())
    worst[name] = int((diff > TOL * (1 + np.abs(want[name]))).sum())
    bad += worst[name]
    n += diff.size
  assert bad <= 1e-3 * n, (what, bad, n, {k: v for k, v in worst.items() if v})


# ---------------------------------------------------------------------------
# param_specs against the reference's, by name
# ---------------------------------------------------------------------------


def test_parallelism_has_the_reference_fields_and_defaults():
  want = [(f.name, f.default) for f in dataclasses.fields(JParallelism)]
  got = [(f.name, f.default) for f in dataclasses.fields(TParallelism)]
  assert got == want


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("full", [False, True])
def test_param_specs_match_reference(full, model_size, fsdp):
  """Reduced and full qwen3-4b (shapes only: the reference's eval_shape,
  the port's ``param_shapes``), model axis 2 and 4, fsdp on and off (a
  small ``min_fsdp_size`` at the reduced size so it acts)."""
  jcfg = jconfigs.get_config("qwen3-4b")
  tcfg = tconfigs.get_config("qwen3-4b")
  if not full:
    jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
  kw = dict(dp_axes=("data",), dp_size=2, model_size=model_size, fsdp=fsdp,
            min_fsdp_size=(1 << 20) if full else (1 << 10))
  want = interop.lm_specs(jcfg, j_build_model(jcfg).param_specs(
      JParallelism(**kw)))
  got = param_specs(tcfg, TParallelism(**kw))
  assert got == want
  if not full:  # the shapes behind them are the model's own, and its method
    m = Model(tcfg, device="cpu")
    assert {n: tuple(p.shape) for n, p in m.state_dict().items()} == \
        param_shapes(tcfg)
    assert m.param_specs(TParallelism(**kw)) == want
  if fsdp and full:
    assert any("data" in spec for spec in got.values())
  assert got["layers.0.attn.wq"][1] == "model"


def test_mesh_layout_helpers():
  """``parse_mesh``, the reference's ``dp_axes_of`` / ``dp_size_of``, and a
  rank's slice, local shape and split dim by spec (no group joined)."""
  from repro_torch.launch import mesh as M
  assert M.parse_mesh("4x2") == (4, 2) and M.parse_mesh("4") == (4, 1)
  with pytest.raises(ValueError, match="DxM"):
    M.parse_mesh("2x2x2")
  mesh = M.TrainMesh(2, 2, 3, torch.device("cpu"), "gloo", None, None, None)
  assert mesh.coords == {"data": 1, "model": 1}
  assert M.dp_axes_of(mesh) == ("data",) and M.dp_size_of(mesh) == 2
  full = torch.arange(24.0).reshape(4, 6)
  assert torch.equal(mesh.local(full, (None, "model")), full[:, 3:])
  assert torch.equal(mesh.local(full, ("data", None)), full[2:])
  assert torch.equal(mesh.local(full, (None, None)), full)
  assert mesh.local_shape((4, 6), ("model", None)) == (2, 6)
  one = M.TrainMesh(2, 1, 1, torch.device("cpu"), "gloo", None, None, None)
  assert torch.equal(one.local(full, (None, "model")), full)  # axis of 1
  assert torch.equal(mesh.local(full, ("data", "model")), full[2:, 3:])
  assert mesh.local_shape((4, 6), ("data", "model")) == (2, 3)
  with pytest.raises(ValueError, match="does not split"):
    mesh.local(torch.zeros(3, 2), ("model", None))


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_data_axis_equals_the_stacked_twin(runs, world):
  """Every rank's parameters, loss and grad norm after each step equal the
  one-process twin's (each shard's gradient folded in rank order / D)
  bit for bit."""
  ranks, twin, _ = runs[0][world]
  for r, got in enumerate(ranks):
    assert got["data/gathers"] > 0
    for t in range(STEPS):
      for k in ("loss", "grad_norm"):
        np.testing.assert_array_equal(got[f"data/step{t}/{k}"],
                                      twin[f"data/step{t}/{k}"],
                                      err_msg=f"rank {r} step {t} {k}")
      p, w = _params(got, f"data/step{t}"), _params(twin, f"data/step{t}")
      assert sorted(p) == sorted(w) and len(p) > 10
      for name in w:
        np.testing.assert_array_equal(p[name], w[name],
                                      err_msg=f"rank {r} step {t} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_data_axis_matches_the_reference_full_batch(runs, world):
  """The ranks' parameters and losses against the reference's
  ``make_train_step`` on the whole batch, from the same weights."""
  ranks, _, _ = runs[0][world]
  ref = runs[1]
  for t in range(STEPS):
    np.testing.assert_allclose(float(ranks[0][f"data/step{t}/loss"]),
                               ref[f"step{t}/loss"], rtol=TOL)
    want = {n: ref[f"step{t}/{n}"] for n in _params(ranks[0],
                                                     f"data/step{t}")}
    _close_params(_params(ranks[0], f"data/step{t}"), want, OCFG["lr"],
                  f"world {world} step {t}")


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------


def test_model_axis_matches_one_process(runs):
  """1x2: loss and grad norm within TOL relative, the whole parameters
  within the parameter rule of the one-process port, each step."""
  ranks, twin, _ = runs[0][2]
  for t in range(STEPS):
    for r, got in enumerate(ranks):
      for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"model/step{t}/{k}"]),
                                   float(twin[f"model/step{t}/{k}"]),
                                   rtol=TOL, err_msg=f"rank {r} {k}")
      _close_params(_params(got, f"model/whole{t}"),
                    _params(twin, f"model/step{t}"), OCFG["lr"],
                    f"rank {r} step {t}")


def test_model_axis_holds_slices_and_equal_replicated_leaves(runs):
  """Each rank holds half of every split leaf (heads, MLP columns,
  vocabulary), and every replicated leaf (norm gains, qk-norm gains whose
  gradients are summed over the group) is equal across the group bit for
  bit after each step."""
  ranks, twin, _ = runs[0][2]
  sharded = set(ranks[0]["model/sharded"].tolist())
  assert {"embed", "head", "layers.0.attn.wq", "layers.1.mlp.down"} <= \
      sharded and "layers.0.attn.q_norm" not in sharded
  for t in range(STEPS):
    mine = [_params(got, f"model/step{t}") for got in ranks]
    whole = _params(twin, f"model/step{t}")
    for name in whole:
      if name in sharded:
        assert mine[0][name].size * 2 == whole[name].size, name
      else:
        assert mine[0][name].shape == whole[name].shape, name
        np.testing.assert_array_equal(mine[0][name], mine[1][name],
                                      err_msg=f"step {t} {name}")


def test_model_axis_qkv_bias_matches_one_process(runs):
  """1x2 with qkv biases (reduced qwen1.5-4b; they enter the split region
  through ``split_group``): every gradient the optimizer is handed, whole,
  within TOL (of the leaf's largest |gradient|) of one process's, so no
  bias gradient is summed over the group twice; the loss and grad norm
  within TOL, the parameters by the parameter rule, two steps."""
  ranks, twin, _ = runs[0][2]
  for r, got in enumerate(ranks):
    grads = _params(got, "bias/grad")
    want = _params(twin, "bias/grad")
    assert sorted(grads) == sorted(want) and "layers.0.attn.bq" in want
    for n, w in want.items():
      np.testing.assert_allclose(grads[n], w, rtol=TOL,
                                 atol=TOL * float(np.abs(w).max()),
                                 err_msg=f"rank {r} gradient of {n}")
    for t in range(2):
      for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"bias/step{t}/{k}"]),
                                   float(twin[f"bias/step{t}/{k}"]),
                                   rtol=TOL, err_msg=f"rank {r} {k}")
      _close_params(_params(got, f"bias/whole{t}"),
                    _params(twin, f"bias/whole{t}"), OCFG["lr"],
                    f"rank {r} step {t}")


def test_model_axis_microbatches(runs):
  """1x2 with two microbatches: the loss and grad norm within TOL of one
  process's microbatched step and of the whole batch's step."""
  ranks, twin, _ = runs[0][2]
  for got in ranks:
    for k in ("loss", "grad_norm"):
      np.testing.assert_allclose(float(got[f"micro/{k}"]),
                                 float(twin[f"micro/{k}"]), rtol=TOL)
      np.testing.assert_allclose(float(got[f"micro/{k}"]),
                                 float(twin[f"model/step0/{k}"]), rtol=TOL)


def test_bfloat16_goes_over_gloo_bit_for_bit(runs):
  """Every rank gets each rank's bfloat16 bits and the same rank-ordered
  sum (float32 accumulation, cast back to bfloat16)."""
  ranks, _, _ = runs[0][2]
  want = [(torch.arange(15.0).reshape(3, 5) / 7 + r).to(
      torch.bfloat16).float() for r in range(2)]
  total = (want[0] + want[1]).to(torch.bfloat16).float()
  for got in ranks:
    for r in range(2):
      np.testing.assert_array_equal(got["bf16/parts"][r], want[r].numpy())
    np.testing.assert_array_equal(got["bf16/sum"], total.numpy())
    assert str(got["bf16/dtype"]) == "torch.bfloat16"


def test_model_axis_eval_and_serving_logits(runs):
  """1x2: the eval loss (the kernel's route, local heads), the teacher-
  forced logits (the vocabulary gathered), prefill and two decode steps
  (local KV caches) against the one-process port."""
  ranks, twin, _ = runs[0][2]
  for got in ranks:
    np.testing.assert_allclose(float(got["model/eval_loss"]),
                               float(twin["model/eval_loss"]), rtol=TOL)
    for key in ("model/logits", "model/prefill", "model/decode8",
                "model/decode9"):
      want = twin[key]
      np.testing.assert_allclose(got[key], want, rtol=TOL,
                                 atol=TOL * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compressed_codes_and_mean_match_reference(runs):
  """Given the reference's noise, every rank's int8 codes and scales equal
  ``_quantize``'s bit for bit; the mean (over the int8 wire) and the new
  residual are within TOL_MEAN of ``compressed_psum`` on 4 host
  devices."""
  ranks, _, _ = runs[0][4]
  ref = runs[1]
  for r, got in enumerate(ranks):
    assert got["cmp/codes"].dtype == np.int8
    np.testing.assert_array_equal(got["cmp/codes"], ref["cmp/codes"][r])
    np.testing.assert_array_equal(got["cmp/scales"], ref["cmp/scales"][r])
    assert int(got["cmp/gathers"]) == 2   # the codes and the scales
    for k in ("mean_a", "mean_b", "new_error_a", "new_error_b"):
      np.testing.assert_allclose(got[f"cmp/{k}"], ref[f"cmp/{k}"][r],
                                 rtol=0, atol=TOL_MEAN, err_msg=k)
  np.testing.assert_array_equal(ranks[0]["cmp/mean_a"],
                                ranks[3]["cmp/mean_a"])


def test_compressed_error_feedback_oracle(runs):
  """The reference test's oracle with the port's generator: over 10 steps
  the accumulated compressed mean stays within 0.02 relative of the
  exact one."""
  for got in runs[0][4][0]:
    assert 0 < float(got["cmp/ef_rel"]) < 0.02


# ---------------------------------------------------------------------------
# checkpoints: the elastic reshard
# ---------------------------------------------------------------------------


def test_elastic_reshard_oracle(runs):
  """A (4, 4) leaf split over 2 ranks, saved and restored over 4: each
  rank holds its row, the whole is the saved leaf."""
  full = np.arange(16.0).reshape(4, 4)
  for r, got in enumerate(runs[0][4][0]):
    np.testing.assert_array_equal(got["elastic/local"], full[r:r + 1])
    np.testing.assert_array_equal(got["elastic/whole"], full)
    assert int(got["elastic/step"]) == 5


def test_same_layout_resume_equals_uninterrupted(runs):
  """1x2: two steps, a save, a fresh model restored, one more step: every
  rank's slices equal the uninterrupted run's after three, bit for bit."""
  for r, got in enumerate(runs[0][2][0]):
    want = _params(got, f"model/step{STEPS - 1}")
    res = _params(got, "resume")
    assert sorted(res) == sorted(want) and int(got["resume_meta_step"]) == 2
    for name in want:
      np.testing.assert_array_equal(res[name], want[name],
                                    err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", ["1x2_to_2x1", "1x2_to_single",
                                  "2x2_to_4x1", "2x2_to_single",
                                  "single_to_1x2", "single_to_2x2"])
def test_cross_layout_restore_gives_back_the_saved_leaves(runs, case):
  """Every leaf (parameters, moments, step) restored on another layout
  equals the saved whole leaf bit for bit (the mesh ranks' slices
  gathered)."""
  src, dst = case.split("_to_")
  world = 4 if "2x2" in case else 2
  ranks, _, out = runs[0][world]
  tmp = out.parent
  path = {"1x2": out / "ck_1x2", "2x2": out / "ck_2x2",
          "single": tmp / "ck_single"}[src]
  ck = CheckpointManager(str(path))
  step = ck.latest_step()
  with np.load(path / f"step_{step:08d}" / "arrays.npz") as z:
    saved = {k: z[k] for k in z.files}
  tag = {"2x1": "to_2x1", "4x1": "to_4x1", "1x2": "single_to_1x2",
         "2x2": "single_to_2x2", "single": f"to_{'2x1' if world == 2 else '4x1'}"
         "_single"}[dst]
  for r, got in enumerate(ranks if dst != "single" else ranks[:1]):
    keys = [k[len(tag) + 1:] for k in got if k.startswith(tag + "/")]
    assert sorted(keys) == sorted(saved), (case, r)
    for key in keys:
      np.testing.assert_array_equal(got[f"{tag}/{key}"], saved[key],
                                    err_msg=f"{case} rank {r} {key}")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _losses(out: str) -> list[float]:
  return [float(line.split("loss")[1].split()[0])
          for line in out.splitlines() if line.startswith("[train] step")]


def test_launcher_mesh_trains_and_resumes_on_another_mesh(tmp_path, capsys):
  """``--reduced --mesh 2x2`` on 4 gloo ranks trains 4 steps (losses as
  the one-process launcher prints them) and checkpoints; ``--mesh 4x1``
  resumes from step 4."""
  ck = str(tmp_path / "ck")
  common = ["--reduced", "--dist-backend", "gloo", "--device", "cpu",
            "--ckpt-every", "2", "--ckpt-dir", ck, "--seq-len", "32"]
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1")
  outs = []
  for mesh, steps in (("2x2", 4), ("4x1", 6)):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *common, "--mesh", mesh, "--steps", str(steps)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    outs.append(proc.stdout)
  assert "resumed" not in outs[0] and "[train] done: steps 0..4" in outs[0]
  assert "mesh 2x2 backend gloo" in outs[0] and "gathers=" in outs[0]
  assert "[train] resumed from step 4" in outs[1]
  assert "[train] done: steps 4..6" in outs[1] and "mesh 4x1" in outs[1]
  assert outs[0].count("[train] step") == 2   # rank 0 prints alone
  assert CheckpointManager(ck).all_steps() == [2, 4, 6]
  launch_train.main(["--reduced", "--device", "cpu", "--seq-len", "32",
                     "--steps", "4", "--ckpt-every", "0", "--ckpt-dir",
                     str(tmp_path / "one")])
  one = _losses(capsys.readouterr().out)
  assert len(one) == 2
  np.testing.assert_allclose(_losses(outs[0]), one, rtol=0, atol=2e-4)


def test_launcher_refusals(monkeypatch):
  """``--mesh`` outside torchrun, a mesh that is not the world size,
  heads that do not split over M, and torchrun without ``--mesh`` are
  refused before any group is joined."""
  base = ["--reduced", "--device", "cpu", "--steps", "1", "--ckpt-every",
          "0"]
  with pytest.raises(SystemExit, match="torchrun"):
    launch_train.main([*base, "--mesh", "2x2"])
  with pytest.raises(SystemExit, match="--dist-backend needs --mesh"):
    launch_train.main([*base, "--dist-backend", "gloo"])
  monkeypatch.setenv("RANK", "0")
  monkeypatch.setenv("WORLD_SIZE", "4")
  with pytest.raises(ValueError, match="a 3x1 mesh needs 3 ranks"):
    launch_train.main([*base, "--mesh", "3x1", "--dist-backend", "gloo"])
  with pytest.raises(ValueError, match="whole query heads"):
    launch_train.main([*base, "--mesh", "1x3", "--dist-backend", "gloo"])
  with pytest.raises(SystemExit, match="pass --mesh"):
    launch_train.main(base)
  with pytest.raises(ValueError, match="DxM"):
    launch_train.main([*base, "--mesh", "2y2"])
  assert not torch.distributed.is_initialized()
