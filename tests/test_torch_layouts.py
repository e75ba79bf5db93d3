"""The layouts the dry run describes, run over gloo on the CPU: FSDP
(ZeRO-3), sequence sharding, experts over a pod axis, a model axis inside
the query heads, and serving over the data axes (a batch split by rows,
a batch-1 cache split by length), over meshes of up to three axes.

Ranks are started with ``python -m torch.distributed.run --standalone``
on a script in ``tmp_path``: one launch at world 2 and one at world 4,
side by side, each writing an ``.npz`` (one-process twins run on rank 0).
The JAX reference runs in this process (its full-batch train step) and in
one ``subrun`` (``NamedSharding(...).shard_shape`` and the reference's
``param_specs`` on 8 host devices).

  * the meshes (world 4): a 2x2 and a 2x1x2 mesh's coordinates and groups
    (each group's ranks in row-major order), ``reduce_scatter`` equal to
    ``sum`` then the slice bit for bit, ``all_to_all`` its own inverse;
  * FSDP at 2x1 (world 2) and 2x2 (world 4), reduced qwen3-4b in float32
    from the reference's weights: after each of two steps every whole
    leaf, the loss and the grad norm equal the non-FSDP run's bit for bit;
    a rank's parameter and optimizer bytes are half the non-FSDP rank's;
    the losses within 1e-5 of the reference's full-batch steps (the
    existing training parity tests' tolerance); the 2x2 FSDP state saved
    and restored onto 2x2 without FSDP, 4x1 and 2x1x2 bit for bit;
  * ``seq_shard`` at 1x2 (world 2) for qwen3-4b, mamba2-2.7b,
    recurrentgemma-2b and whisper-tiny (its encoder and cross blocks): the
    logits and loss of the 1x2 run without it bit for bit, every whole
    gradient within rtol 1e-5 (float32), and 2x2 FSDP + seq_shard (world
    4) two steps within 1e-5; in bf16 two 2x2 steps with both layouts
    equal the plain run's bit for bit (parameters, moments, losses,
    norms), and a gradient from half the batch fails that check;
  * ``ep_pod`` on 2x1x2 (world 4), reduced deepseek-moe-16b: the loss, aux
    and every whole gradient within the MoE tests' tolerance (rtol 1e-5) of
    one process on the whole batch, and with FSDP and seq_shard on too;
  * a model axis inside the query heads (world 4, 1x4, 6 query and 2 KV
    heads of 32): loss, gradients, prefill and decode logits within 1e-5
    of one process, the caches holding a quarter of head_dim; with a
    batch-1 length split too (recurrentgemma, 3 query heads, 2x2);
  * serving (world 2, 2x1): batch-1 prefill and decode with the cache
    split by length over the 2 data ranks within 1e-5 of one process for
    reduced qwen3-4b and for recurrentgemma-2b decoding past its window;
    ``generate`` over the rows of a batch of 4 (each rank its rows and its
    cache) and at batch 1 (the split cache) gives one process's tokens;
  * each rank's shard shapes (every leaf, FSDP on, reduced qwen3-4b,
    deepseek-moe-16b with ``ep_pod`` on the pod mesh, mamba2-2.7b) equal
    ``NamedSharding(mesh, spec).shard_shape`` on a 4x2 and a 2x2x2 host
    mesh, and the port's specs there equal the reference's.
"""
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
from repro.train import optimizer as JO  # noqa: E402
from repro.train.train_step import make_train_step as j_train_step  # noqa
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch.mesh import ProcessMesh, TrainMesh  # noqa: E402
from repro_torch.models import Parallelism as TParallelism  # noqa: E402
from repro_torch.models import param_shapes, param_specs  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
STEPS, B, S = 2, 4, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DRAWN = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")
TOL = 1e-5

RANK_SCRIPT = r'''
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import interop, no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import POD_AXES, TrainMesh, make_host_mesh
from repro_torch.models import Model
from repro_torch.models.registry import mesh_parallelism
from repro_torch.models.transformer import KVSplit
from repro_torch.serve import generate
from repro_torch.train import (CheckpointManager, OptConfig, init_opt_state,
                               make_train_step, tree_specs)

no_tf32()
CPU = torch.device("cpu")
OCFG = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
OUT = sys.argv[1]
INP = dict(np.load(sys.argv[2]))
QWEN = reduced(get_config("qwen3-4b"))
SEQ_ARCHS = ("qwen3-4b", "mamba2-2.7b", "recurrentgemma-2b", "whisper-tiny")


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
            ("tokens", "labels", "mask")} for t in range(int(INP["steps"]))]


def mesh_of(shape, rank):
  return make_host_mesh(shape, POD_AXES[-len(shape):], rank=rank)


def dp_index(mesh):
  return mesh.coords.get("pod", 0) * mesh.data + mesh.coords["data"]


def shard(batch, mesh):
  rows = batch["tokens"].shape[0] // mesh.dp_size
  i = dp_index(mesh)
  return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def wholes(m, mesh, out, prefix):
  for n, p in m.state_dict().items():
    out[f"{prefix}/{n}"] = mesh.whole(p.detach(), m.specs[n]).clone().numpy()


def nbytes(m, opt):
  return (sum(p.numel() * p.element_size() for p in m.parameters())
          + sum(t.numel() * t.element_size() for t in opt.mu.values())
          + sum(t.numel() * t.element_size() for t in opt.nu.values()))


def qwen(mesh, **chosen):
  par = None if mesh is None else mesh_parallelism(QWEN, mesh, **chosen)
  return interop.lm_params(Model(QWEN, device="cpu", remat="dots",
                                 mesh=mesh, par=par), WEIGHTS)


def train_case(tag, shape, rank, res, **chosen):
  """Two steps on a mesh; the whole leaves, losses, norms, bytes."""
  mesh = mesh_of(shape, rank)
  m = qwen(mesh, **chosen)
  opt = init_opt_state(m)
  step = make_train_step(m, OCFG)
  for t, b in enumerate(BATCHES):
    met = step(opt, shard(b, mesh))
    res[f"{tag}/step{t}/loss"] = met["loss"].numpy()
    res[f"{tag}/step{t}/grad_norm"] = met["grad_norm"].numpy()
    wholes(m, mesh, res, f"{tag}/step{t}")
  res[f"{tag}/bytes"] = np.array(nbytes(m, opt))
  res[f"{tag}/fsdp"] = np.array(sorted(m.fsdp))


def grads_case(tag, cfg, shape, rank, res, batch, twin, **chosen):
  """One forward and backward: logits (no grad), loss, aux and every
  whole gradient; on rank 0 the same of one process on the whole batch
  (``twin``) when asked."""
  runs = [("mesh", mesh_of(shape, rank))]
  if twin and rank == 0:
    runs.append(("one", None))
  for who, mesh in runs:
    par = None if mesh is None else mesh_parallelism(cfg, mesh, **chosen)
    m = Model(cfg, device="cpu", remat="dots", mesh=mesh, par=par)
    b = batch if mesh is None else shard(batch, mesh)
    with torch.no_grad():
      logits = m.apply_train(b)[0]
    loss, met = m.loss_fn(b)
    loss.backward()
    key = f"{tag}/{who}"
    if mesh is not None and mesh.dp_size > 1:  # the rows of every rank
      logits = mesh.dp.all_gather(logits)
      stats = mesh.dp.sum(torch.stack([loss.detach(), met["aux"].detach()]),
                          div=mesh.dp_size)
    else:
      stats = torch.stack([loss.detach(), met["aux"].detach()])
    res[f"{key}/logits"] = logits.numpy()
    res[f"{key}/loss"], res[f"{key}/aux"] = stats[0].numpy(), stats[1].numpy()
    for n, p in m.named_parameters():
      g = p.grad
      if mesh is not None:
        # the data mean and the model group's sum as the train step takes
        # them (an FSDP shard's gradient is both already)
        if mesh.dp_size > 1 and n not in m.fsdp:
          g = mesh.group(m.mean_axes[n]).sum(g, div=mesh.dp_size)
        if n in m.partial_leaves and n not in m.fsdp:
          g = mesh.tp.sum(g)
        g = mesh.whole(g, m.specs[n])
      res[f"{key}/grad/{n}"] = g.detach().numpy()


def bits_case(tag, rank, res, half=False, **chosen):
  """2x2, reduced qwen3-4b in bf16 from one seed, two steps: the whole
  leaves, AdamW's moments, losses and norms (bf16 read as float32, which
  keeps its bits).  ``half``: each rank's first half of its rows twice
  over, so the gradient is the one of half the batch."""
  mesh = mesh_of((2, 2), rank)
  cfg = dataclasses.replace(QWEN, dtype="bfloat16")
  m = Model(cfg, device="cpu", remat="dots", mesh=mesh,
            par=mesh_parallelism(cfg, mesh, **chosen),
            generator=torch.Generator().manual_seed(11))
  opt = init_opt_state(m)
  step = make_train_step(m, OCFG)
  for t, b in enumerate(BATCHES):
    mine = shard(b, mesh)
    if half:
      mine = {k: torch.cat([v[:v.shape[0] // 2]] * 2) for k, v in mine.items()}
    met = step(opt, mine)
    res[f"{tag}/step{t}/loss"] = met["loss"].numpy()
    res[f"{tag}/step{t}/grad_norm"] = met["grad_norm"].numpy()
  for n, p in m.state_dict().items():
    for what, t in (("p", p.detach()), ("mu", opt.mu[n]), ("nu", opt.nu[n])):
      res[f"{tag}/{what}/{n}"] = mesh.whole(t, m.specs[n]).float().numpy()


def ckpt_case(rank, res):
  """A 2x2 FSDP model after one step saved (whole leaves gathered over both
  axes) and restored onto 2x2 without FSDP, 4x1 and 2x1x2 with it: the
  whole leaves and moments of each, and of the saved state."""
  mesh = mesh_of((2, 2), rank)
  m = qwen(mesh, fsdp=True, min_fsdp_size=1)
  opt = init_opt_state(m)
  make_train_step(m, OCFG)(opt, shard(BATCHES[0], mesh))
  ck = CheckpointManager(f"{OUT}/ck_fsdp")
  ck.save(1, {"params": m.state_dict(), "opt": opt}, mesh=mesh,
          specs=tree_specs(m.specs))
  wholes(m, mesh, res, "ckpt/saved")
  for n, t in opt.mu.items():
    res[f"ckpt/saved/mu/{n}"] = mesh.whole(t, m.specs[n]).clone().numpy()
  for tag, shape, kw in (("plain22", (2, 2), {}),
                         ("fsdp41", (4, 1), dict(fsdp=True,
                                                  min_fsdp_size=1)),
                         ("fsdp212", (2, 1, 2), dict(fsdp=True,
                                                      min_fsdp_size=1))):
    m2 = mesh_of(shape, rank)
    model = Model(QWEN, device="cpu", mesh=m2,
                  par=mesh_parallelism(QWEN, m2, **kw),
                  generator=torch.Generator().manual_seed(5))
    tree, _ = ck.restore({"params": model.state_dict(),
                          "opt": init_opt_state(model)}, mesh=m2,
                         specs=tree_specs(model.specs))
    for n, t in tree["params"].items():
      res[f"ckpt/{tag}/{n}"] = m2.whole(t, model.specs[n]).clone().numpy()
    for n, t in tree["opt"].mu.items():
      res[f"ckpt/{tag}/mu/{n}"] = m2.whole(t, model.specs[n]).clone().numpy()


def heads_case(rank, res):
  """1x4 with 6 query and 2 KV heads: the axis splits inside the heads."""
  cfg = dataclasses.replace(QWEN, n_heads=6, n_kv_heads=2)
  b = BATCHES[0]
  grads_case("heads", cfg, (1, 4), rank, res, b, True)
  for who, mesh in (("mesh", mesh_of((1, 4), rank)),) + (
      (("one", None),) if rank == 0 else ()):
    m = Model(cfg, device="cpu", mesh=mesh)
    caches = m.init_cache(b["tokens"].shape[0], 12)
    first, caches = m.prefill({"tokens": b["tokens"][:, :8]}, caches)
    res[f"heads/{who}/prefill"] = first.numpy()
    for pos in (8, 9):
      lg, caches = m.decode_step(b["tokens"][:, pos:pos + 1], pos, caches)
      res[f"heads/{who}/decode{pos}"] = lg.numpy()
    if mesh is not None:
      res["heads/flag"] = np.array(m.shard.heads)
      res["heads/cache_dh"] = np.array(caches[0]["k"].shape[-1])
  # recurrentgemma with 3 query heads over 2x2 at batch 1: the head_dim
  # split of the model axis and the length split of the data axis together,
  # decoding through the ring past its window
  rg = reduced(get_config("recurrentgemma-2b"))
  rg = dataclasses.replace(rg, n_heads=3, n_kv_heads=1)
  toks = torch.tensor(np.random.default_rng(2).integers(0, rg.vocab,
                                                         size=(1, 44)))
  for who, mesh in (("mesh", mesh_of((2, 2), rank)),) + (
      (("one", None),) if rank == 0 else ()):
    m = Model(rg, device="cpu", mesh=mesh)
    caches = m.init_cache(1, 44, kv_split=None if mesh is None
                          else KVSplit(mesh.dp))
    lg, caches = m.prefill({"tokens": toks[:, :20]}, caches)
    out = [lg]
    for pos in range(20, 44):
      lg, caches = m.decode_step(toks[:, pos:pos + 1], pos, caches)
      out.append(lg)
    res[f"heads_split/{who}/logits"] = torch.stack(out).numpy()
    if mesh is not None:
      att = next(c for c in caches if "k" in c)["k"]
      res["heads_split/flag"] = np.array(m.shard.heads)
      res["heads_split/cache"] = np.array(att.shape)


def serve_case(rank, res):
  """2x1: batch-1 prefill + decode over a cache split by length, and
  generate over rows and at batch 1, beside one process."""
  mesh = mesh_of((2, 1), rank)
  for arch, s, steps in (("qwen3-4b", 12, 6), ("recurrentgemma-2b", 20, 24)):
    cfg = reduced(get_config(arch))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(4, s + steps)))
    for who, msh in (("split", mesh), ("one", None)):
      m = Model(cfg, device="cpu", mesh=msh)
      caches = m.init_cache(1, s + steps, kv_split=None if msh is None
                            else KVSplit(msh.dp))
      lg, caches = m.prefill({"tokens": toks[:1, :s]}, caches)
      out = [lg]
      for t in range(steps):
        lg, caches = m.decode_step(toks[:1, s + t:s + t + 1], s + t, caches)
        out.append(lg)
      res[f"serve/{arch}/{who}/logits"] = torch.stack(out).numpy()
      if msh is not None:
        res[f"serve/{arch}/rows"] = np.array(next(
            c for c in caches if "k" in c)["k"].shape[2])
      res[f"serve/{arch}/{who}/gen4"] = generate(
          m, {"tokens": toks[:, :s]}, steps=5, max_len=32).numpy()
      res[f"serve/{arch}/{who}/gen1"] = generate(
          m, {"tokens": toks[:1, :s]}, steps=5, max_len=32).numpy()


def mesh_case(rank, res):
  """World 4: the 2x2 and 2x1x2 meshes' coordinates and group members,
  reduce_scatter against sum then slice, all_to_all round trip."""
  for tag, shape in (("m22", (2, 2)), ("m212", (2, 1, 2))):
    mesh = mesh_of(shape, rank)
    res[f"{tag}/coords"] = np.array(list(mesh.coords.values()))
    for axes, g in mesh.groups.items():
      ranks = mesh.world.all_gather(torch.tensor(
          [g.rank if g is not None else 0]))
      res[f"{tag}/group/{'.'.join(axes)}"] = ranks.numpy()
    x = (torch.arange(24.0).reshape(4, 6) / 7 + rank).to(torch.bfloat16)
    for axes in mesh.groups:
      g = mesh.group(axes)
      if g.world > 1 and 4 % g.world == 0:
        rs = g.reduce_scatter(x, dim=0, div=3)
        per = 4 // g.world
        want = g.sum(x, div=3)[g.rank * per:(g.rank + 1) * per]
        res[f"{tag}/rs/{'.'.join(axes)}"] = np.array(torch.equal(rs, want))
        back = g.all_to_all(g.all_to_all(x))
        res[f"{tag}/a2a/{'.'.join(axes)}"] = np.array(torch.equal(back, x))


def main():
  world = int(INP["world"])
  base = TrainMesh.from_env((world, 1), "gloo", "cpu")
  rank = base.rank
  res = {}
  if world == 2:
    train_case("plain21", (2, 1), rank, res)
    train_case("fsdp21", (2, 1), rank, res, fsdp=True, min_fsdp_size=1)
    for arch in SEQ_ARCHS:
      cfg = reduced(get_config(arch))
      b = dict(BATCHES[0])
      if cfg.family == "encdec":   # frames of the encoder, drawn once
        b["frames"] = torch.tensor(np.random.default_rng(6).normal(
            size=(4, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
      grads_case(f"plain12/{arch}", cfg, (1, 2), rank, res, b, False)
      grads_case(f"seq12/{arch}", cfg, (1, 2), rank, res, b, False,
                 seq_shard=True)
    serve_case(rank, res)
  else:
    mesh_case(rank, res)
    train_case("plain22", (2, 2), rank, res)
    train_case("fsdp22", (2, 2), rank, res, fsdp=True, min_fsdp_size=1)
    train_case("fsdpseq22", (2, 2), rank, res, fsdp=True, seq_shard=True,
               min_fsdp_size=1)
    ckpt_case(rank, res)
    bits_case("bf_plain", rank, res)
    both = dict(fsdp=True, seq_shard=True, min_fsdp_size=1)
    bits_case("bf_both", rank, res, **both)
    bits_case("bf_half", rank, res, half=True, **both)
    moe = reduced(get_config("deepseek-moe-16b"))
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, moe.vocab, size=(4, 257)))
    mb = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
          "mask": torch.ones(4, 256)}
    grads_case("ep_pod", moe, (2, 1, 2), rank, res, mb, True, ep_pod=True)
    grads_case("ep_pod_all", moe, (2, 1, 2), rank, res, mb, False,
               ep_pod=True, fsdp=True, seq_shard=True, min_fsdp_size=1)
    heads_case(rank, res)
  np.savez(f"{OUT}/rank{rank}.npz", **res)
  base.close()


main()
'''

SHARD_SCRIPT = """
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch.mesh import make_host_mesh
from repro.models.registry import Parallelism, build_model
out = {}
for tag, shape, axes in (("m42", (4, 2), ("data", "model")),
                         ("m222", (2, 2, 2), ("pod", "data", "model"))):
  mesh = make_host_mesh(shape, axes)
  dp = tuple(a for a in axes if a != "model")
  for arch in ("qwen3-4b", "deepseek-moe-16b", "mamba2-2.7b"):
    cfg = reduced(get_config(arch))
    ep_pod = len(shape) == 3 and bool(cfg.moe.num_experts)
    par = Parallelism(dp_axes=dp, dp_size=int(np.prod(shape[:-1])),
                      model_size=shape[-1], fsdp=True, min_fsdp_size=1,
                      ep_pod=ep_pod, seq_shard=True,
                      dp_axis_sizes=tuple(shape[:-1]))
    model = build_model(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = model.param_specs(par)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    sflat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, P))
    for (path, leaf), spec in zip(flat, sflat):
      key = "/".join(str(getattr(k, "key", k)) for k in path)
      out[f"{tag}/{arch}/{key}"] = np.array(
          NamedSharding(mesh, spec).shard_shape(leaf.shape))
      out[f"{tag}/{arch}/spec/{key}"] = np.array(repr(tuple(spec)))
np.savez(PATH, **out)
print("SHARD_DONE")
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
  jcfg = jconfigs.reduced(jconfigs.get_config("qwen3-4b"))
  jm = j_build_model(jcfg, remat=None)
  params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
  r = np.random.default_rng(8)

  def draw(path, leaf):
    if str(getattr(path[-1], "key", "")) in DRAWN:
      return leaf + r.normal(scale=0.2, size=leaf.shape).astype(leaf.dtype)
    return leaf

  return jm, jax.tree_util.tree_map_with_path(draw, params)


def _batches(vocab):
  r = np.random.default_rng(3)
  out = []
  for _ in range(STEPS):
    toks = r.integers(0, vocab, size=(B, S + 1)).astype(np.int64)
    out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": np.ones((B, S), np.float32)})
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


def _finish(proc, out, world):
  log, _ = proc.communicate(timeout=600)
  assert proc.returncode == 0, log[-6000:]
  return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both worlds launched side by side beside the reference's shard shapes
  (a subrun on 8 host devices) and its full-batch train steps;
  ({world: ranks}, reference)."""
  tmp = tmp_path_factory.mktemp("layouts")
  jm, params = _reference()
  batches = _batches(jm.cfg.vocab)
  inputs = {f"w/{k}": v for k, v in _flat_keys(params).items()}
  for t, b in enumerate(batches):
    inputs.update({f"batch{t}/{k}": v for k, v in b.items()})
  started = {}
  for world in WORLDS:
    path = tmp / f"inputs{world}.npz"
    np.savez(path, **inputs, steps=np.array(STEPS), world=np.array(world))
    started[world] = _launch(tmp, world, path)
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             XLA_FLAGS="--xla_force_host_platform_device_count=8")
  shards = subprocess.Popen(
      [sys.executable, "-c",
       SHARD_SCRIPT.replace("PATH", repr(str(tmp / "sh.npz")))],
      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  step = jax.jit(j_train_step(jm, JO.OptConfig(**OCFG),
                              JParallelism(dp_axes=(), dp_size=0)))
  p, opt = params, JO.init_opt_state(params)
  ref = {}
  for t, b in enumerate(batches):
    p, opt, met = step(p, opt, {k: jnp.asarray(v) if k == "mask" else
                                jnp.asarray(v, jnp.int32)
                                for k, v in b.items()})
    ref[f"step{t}/loss"] = float(met["loss"])
  out, _ = shards.communicate(timeout=300)
  assert shards.returncode == 0 and "SHARD_DONE" in out, out
  ref.update(np.load(tmp / "sh.npz"))
  return {w: _finish(*started[w], w) for w in WORLDS}, ref


def _close(got, want, tol=TOL, what=""):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6),
                             err_msg=what)


def _under(res, prefix):
  return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------


def test_three_axis_mesh_groups_and_reduce_scatter(runs):
  """Coordinates row-major over (pod, data, model); each group's members
  in row-major order over its axes; reduce_scatter is sum's slice bit
  for bit (bf16, div 3), all_to_all its own inverse."""
  ranks = runs[0][4]
  for r, got in enumerate(ranks):
    assert list(got["m22/coords"]) == [r // 2, r % 2]
    assert list(got["m212/coords"]) == [r // 2, 0, r % 2]
  # each rank's index in its group of each axis tuple
  want = {"m22/group/model": [0, 1, 0, 1], "m22/group/data": [0, 0, 1, 1],
          "m22/group/data.model": [0, 1, 2, 3],
          "m212/group/pod": [0, 0, 1, 1], "m212/group/model": [0, 1, 0, 1],
          "m212/group/pod.data": [0, 0, 1, 1],
          "m212/group/pod.data.model": [0, 1, 2, 3]}
  for key, idx in want.items():
    assert list(ranks[0][key]) == idx, key
  for got in ranks:
    flags = {k: v for k, v in got.items() if "/rs/" in k or "/a2a/" in k}
    assert flags and all(bool(v) for v in flags.values()), flags


def test_mesh_of_three_axes_without_processes():
  """A stand-in 2x2x2 mesh: a rank's coordinates, local part and shape by
  a spec with a ("pod", "data") entry and a model entry."""
  cpu = torch.device("cpu")
  one = ProcessMesh(1, 0, 1, cpu, "gloo")
  mesh = TrainMesh(2, 2, 6, cpu, "gloo", one, one, one, pod=2)
  assert mesh.axis_names == ("pod", "data", "model")
  assert mesh.coords == {"pod": 1, "data": 1, "model": 0}
  assert mesh.dp_size == 4
  full = torch.arange(48.0).reshape(8, 6)
  spec = (("pod", "data"), "model")
  assert torch.equal(mesh.local(full, spec), full[6:8, 0:3])
  assert mesh.local_shape((8, 6), spec) == (2, 3)
  assert torch.equal(mesh.local(full, ("pod", None)), full[4:])
  with pytest.raises(ValueError, match="'tensor'"):
    mesh.local(full, ("tensor", None))


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,shape", [(2, "21"), (4, "22")])
def test_fsdp_equals_the_run_without_it(runs, world, shape):
  """Two steps: every whole leaf, loss and grad norm bit for bit; a rank's
  parameter and optimizer bytes half of the plain rank's (every leaf is
  past min_fsdp_size 1 and splits over D = 2); the losses within 1e-5 of
  the reference's full-batch steps."""
  (ranks, ref) = runs[0][world], runs[1]
  for got in ranks:
    plain = _under(got, f"plain{shape}/")
    fsdp = _under(got, f"fsdp{shape}/")
    assert len(got[f"fsdp{shape}/fsdp"]) > 0
    for key, want in plain.items():
      if key in ("bytes", "fsdp"):
        continue
      np.testing.assert_array_equal(fsdp[key], want, err_msg=key)
    assert int(fsdp["bytes"]) * 2 == int(plain["bytes"])
  for t in range(STEPS):
    _close(ranks[0][f"fsdp{shape}/step{t}/loss"], ref[f"step{t}/loss"],
           what=f"step {t}")


def test_fsdp_checkpoint_restores_onto_any_layout(runs):
  """A 2x2 FSDP state saved (whole leaves, gathered over both axes)
  restores onto 2x2 without FSDP, onto 4x1 and onto 2x1x2 with it: every
  whole parameter and first moment bit for bit."""
  for got in runs[0][4]:
    saved = _under(got, "ckpt/saved/")
    assert saved
    for tag in ("plain22", "fsdp41", "fsdp212"):
      back = _under(got, f"ckpt/{tag}/")
      assert sorted(back) == sorted(saved), tag
      for key, want in saved.items():
        np.testing.assert_array_equal(back[key], want, err_msg=f"{tag} {key}")


# ---------------------------------------------------------------------------
# sequence sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_seq_shard_matches_the_model_axis_without_it(runs, arch):
  """1x2 with and without seq_shard: the forward (logits, loss, aux) bit
  for bit (the reduce-scatter folds in the sum's rank order, and each
  block gathers the sequence before its norm); every whole gradient
  within rtol 1e-5 (the gather and reduce-scatter nodes change the order
  in which autograd sums a tensor's gradient contributions)."""
  for got in runs[0][2]:
    plain = _under(got, f"plain12/{arch}/mesh/")
    seq = _under(got, f"seq12/{arch}/mesh/")
    assert sorted(seq) == sorted(plain)
    for key, want in plain.items():
      if key in ("logits", "loss", "aux"):
        np.testing.assert_array_equal(seq[key], want, err_msg=key)
      _close(seq[key], want, what=f"{arch} {key}")


def test_fsdp_and_seq_shard_together(runs):
  """2x2 with FSDP and seq_shard: two steps within 1e-5 of the plain 2x2
  run (the FSDP half is bits; seq_shard's reduction orders are not)."""
  for got in runs[0][4]:
    plain = _under(got, "plain22/")
    both = _under(got, "fsdpseq22/")
    params = {}
    for key, want in plain.items():
      if key in ("bytes", "fsdp"):
        continue
      if key.endswith(("/loss", "/grad_norm")):
        _close(both[key], want, what=key)
      else:
        params[key] = want
    _close_params({k: both[k] for k in params}, params, OCFG["lr"], "2x2")


def test_fsdp_and_seq_shard_in_bf16_bit_for_bit(runs):
  """2x2 in bf16 (the card's dtype) with FSDP and seq_shard: after two
  steps every whole parameter and both AdamW moments, and each step's
  loss and grad norm, equal the plain 2x2 run's bit for bit (in bf16 the
  norms' float32 casts are nodes of their own, so autograd sums each
  activation's two gradient contributions in one order in both runs; in
  float32 they are not, hence the tolerance above).  A gradient from half
  the batch fails the same check: the moments differ."""
  for got in runs[0][4]:
    plain = _under(got, "bf_plain/")
    both = _under(got, "bf_both/")
    half = _under(got, "bf_half/")
    assert sorted(both) == sorted(plain) == sorted(half)
    for key, want in plain.items():
      np.testing.assert_array_equal(both[key], want, err_msg=key)
    moments = [k for k in plain if k.startswith(("mu/", "nu/"))]
    assert moments
    assert not all(np.array_equal(half[k], plain[k]) for k in moments)


def _close_params(got, want, lr, what):
  """2 x lr per element (Adam's step bounds a sign flip of a near-zero
  gradient) and 99.9 % of the elements within TOL (the rule of
  tests/test_torch_train_dist.py)."""
  n = bad = 0
  for name in want:
    diff = np.abs(np.asarray(got[name], np.float64) - want[name])
    assert diff.max() <= 2 * lr, (what, name, diff.max())
    bad += int((diff > TOL * (1 + np.abs(want[name]))).sum())
    n += diff.size
  assert bad <= 1e-3 * n, (what, bad, n)


# ---------------------------------------------------------------------------
# experts over the pod axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", ["ep_pod", "ep_pod_all"])
def test_ep_pod_matches_one_process(runs, tag):
  """2x1x2, deepseek-moe-16b reduced: the experts dealt over the 2 pods,
  their width over the model axis, tokens exchanged across pods; logits,
  loss, aux and every whole gradient within rtol 1e-5 of one process
  (``ep_pod_all`` with FSDP and seq_shard on as well)."""
  ranks = runs[0][4]
  one = _under(ranks[0], "ep_pod/one/")
  assert one
  for got in ranks:
    mine = _under(got, f"{tag}/mesh/")
    assert sorted(mine) == sorted(one)
    for key, want in one.items():
      _close(mine[key], want, what=f"{tag} {key}")


# ---------------------------------------------------------------------------
# a model axis inside the query heads
# ---------------------------------------------------------------------------


def test_model_axis_inside_the_query_heads(runs):
  """1x4 over 6 query and 2 KV heads: the q / k / v columns gathered,
  every head on every rank, the caches holding a quarter of each head's
  head_dim; within 1e-5 of one process.  recurrentgemma with 3 query
  heads over 2x2 at batch 1 (the head_dim split and the length split
  together, 24 decode steps through its ring past the window): within
  1e-5 of one process."""
  ranks = runs[0][4]
  one = _under(ranks[0], "heads/one/")
  assert one
  dh = tconfigs.reduced(tconfigs.get_config("qwen3-4b")).head_dim
  for got in ranks:
    assert bool(got["heads/flag"])
    assert int(got["heads/cache_dh"]) * 4 == dh
    mine = _under(got, "heads/mesh/")
    assert sorted(mine) == sorted(one)
    for key, want in one.items():
      _close(mine[key], want, what=key)
  rg = tconfigs.reduced(tconfigs.get_config("recurrentgemma-2b"))
  for got in ranks:
    assert bool(got["heads_split/flag"])
    # (batch, the one KV head, half the ring's slots, half of head_dim)
    assert tuple(got["heads_split/cache"]) == (
        1, 1, rg.sliding_window // 2, rg.head_dim // 2)
    _close(got["heads_split/mesh/logits"], ranks[0]["heads_split/one/logits"],
           what="heads and length split")


# ---------------------------------------------------------------------------
# serving over the data axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-2b"])
def test_batch1_cache_split_by_length(runs, arch):
  """Prefill and decode with the cache split over 2 data ranks (each half
  of the slots; recurrentgemma decodes 44 positions through its 32-row
  ring) within 1e-5 of one process; generate over rows and at batch 1
  gives one process's tokens."""
  for got in runs[0][2]:
    split = got[f"serve/{arch}/split/logits"]
    one = got[f"serve/{arch}/one/logits"]
    _close(split, one, what=arch)
    assert int(got[f"serve/{arch}/rows"]) * 2 == (
        32 if arch == "recurrentgemma-2b" else 12 + 6)
    for gen in ("gen4", "gen1"):
      np.testing.assert_array_equal(got[f"serve/{arch}/split/{gen}"],
                                    got[f"serve/{arch}/one/{gen}"])


# ---------------------------------------------------------------------------
# shard shapes against NamedSharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,shape", [("m42", (4, 2)), ("m222", (2, 2, 2))])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b",
                                  "mamba2-2.7b"])
def test_shard_shapes_match_named_sharding(runs, tag, shape, arch):
  """Every rank's local shape of every leaf (FSDP on, min_fsdp_size 1,
  seq_shard; ep_pod for the MoE on the pod mesh) equals the reference's
  ``NamedSharding(mesh, spec).shard_shape``, and the specs are the
  reference's."""
  ref = runs[1]
  cfg = tconfigs.reduced(tconfigs.get_config(arch))
  dp = ("pod", "data") if len(shape) == 3 else ("data",)
  par = TParallelism(dp_axes=dp, dp_size=int(np.prod(shape[:-1])),
                     model_size=shape[-1], fsdp=True, min_fsdp_size=1,
                     ep_pod=len(shape) == 3 and bool(cfg.moe.num_experts),
                     seq_shard=True, dp_axis_sizes=tuple(shape[:-1]))
  specs = param_specs(cfg, par)
  jspecs = {}
  for key, v in ref.items():
    if key.startswith(f"{tag}/{arch}/spec/"):
      jspecs[key[len(f"{tag}/{arch}/spec/"):]] = eval(  # noqa: S307
          str(v), {"PartitionSpec": tuple})
  jcfg = jconfigs.reduced(jconfigs.get_config(arch))
  tree = {}
  for path, spec in jspecs.items():
    node = tree
    *head, leaf = path.split("/")
    for h in head:
      node = node.setdefault(h, {})
    node[leaf] = _pspec(spec)
  assert interop.lm_specs(jcfg, tree) == specs
  shard_shapes = {}
  for path in jspecs:
    shard_shapes[path] = tuple(int(x) for x in ref[f"{tag}/{arch}/{path}"])
  by_name = _by_port_name(jcfg, shard_shapes)
  cpu = torch.device("cpu")
  one = ProcessMesh(1, 0, 1, cpu, "gloo")
  full = param_shapes(cfg)
  *pod, data, model = shape
  for rank in range(int(np.prod(shape))):
    mesh = TrainMesh(data, model, rank, cpu, "gloo", one, one, one,
                     pod=pod[0] if pod else None)
    for name, want in by_name.items():
      assert mesh.local_shape(full[name], specs[name]) == want, (rank, name)


def _pspec(entries):
  from jax.sharding import PartitionSpec
  return PartitionSpec(*entries)


def _by_port_name(jcfg, shapes: dict) -> dict:
  """The reference's per-leaf shard shapes (path -> shape, a stacked
  leaf's period dim first) keyed by the port's parameter names, the
  period dim dropped."""
  stand = {}
  for path, shp in shapes.items():
    node = stand
    *head, leaf = path.split("/")
    for h in head:
      node = node.setdefault(h, {})
    node[leaf] = np.zeros(shp, np.int8)
  out = {}
  for name, arr in interop.lm_tree(types.SimpleNamespace(cfg=jcfg),
                                   stand).items():
    out[name] = tuple(arr.shape)
  return out
