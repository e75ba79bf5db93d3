"""The other model families over a data axis against one process on the
whole batch, on the CPU (gloo).

A world-2 launch (``python -m torch.distributed.run --standalone``) runs
one ``make_train_step`` step of each case at ``--mesh 2x1``, each rank on
its half of the batch's rows; rank 0 first runs the same step on one
process over the whole batch.  The cases, at the reference's ``reduced``
size in float32 with the port's own weights from one seed:

  * deepseek-moe-16b with groups of 64 tokens and capacity factor 1, so
    the groups drop (token, choice) pairs: a rank's 64 tokens are one
    group of the whole batch's two, and its aux term takes the group's
    routed shares (``moe.moe_ffn``'s ``dp``);
  * whisper-tiny (the frames) and llama-3.2-vision-90b (the image
    embeddings): each rank's memory input is its rows of the whole batch's.

Held: the loss, xent and aux (each the mean over the data group) and the
grad norm within 1e-5 relative of one process's, and every gradient the
optimizer is handed within 1e-5 of its leaf's largest |want|.  Beside
them: an MoE shard that would cut a group is refused by ``moe_ffn`` and
by the launcher, and the launcher's 2x1 losses equal one process's for
the families with a memory input.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("deepseek-moe-16b", "whisper-tiny", "llama-3.2-vision-90b")
B, S = 4, 32
TOL = 1e-5

# ``python script.py OUT``: every case at 2x1, rank 0's one-process twins
RANK_SCRIPT = r'''
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import no_tf32
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import TrainMesh
from repro_torch.models import Model
from repro_torch.models import moe as MOE
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train import train_step as TS

no_tf32()
OUT = sys.argv[1]
B, S = 4, 32
OCFG = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
CASES = ("deepseek-moe-16b", "whisper-tiny", "llama-3.2-vision-90b")


def config(arch):
  cfg = reduced(get_config(arch))
  if cfg.moe.num_experts:   # groups of 64 that drop pairs
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=64, capacity_factor=1.0))
  return cfg


def batch_of(cfg, seed):
  r = np.random.default_rng(seed)
  toks = r.integers(0, cfg.vocab, size=(B, S + 1))
  out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "mask": np.ones((B, S), np.float32)}
  if cfg.family == "encdec":
    out["frames"] = r.normal(size=(B, cfg.encoder.n_frames, cfg.d_model))
  if cfg.family == "vlm":
    out["img_embeds"] = r.normal(size=(B, cfg.n_img_tokens, cfg.d_model))
  return {k: torch.tensor(v, dtype=torch.int64 if v.dtype.kind == "i"
                          else torch.float32) for k, v in out.items()}


def one_step(arch, mesh, batch, out):
  """One train step; the metrics and the gradients it hands the
  optimizer (the data group's mean over a mesh)."""
  cfg = config(arch)
  m = Model(cfg, device="cpu", remat="dots", mesh=mesh,
            generator=torch.Generator().manual_seed(5))
  seen = {}
  real = TS.adamw_update

  def handed(cfg_, params, grads, opt, **kw):
    seen.update({n: g.detach().clone() for n, g in grads.items()})
    return real(cfg_, params, grads, opt, **kw)

  TS.adamw_update = handed
  try:
    met = make_train_step(m, OCFG)(init_opt_state(m), batch)
  finally:
    TS.adamw_update = real
  for k in ("loss", "xent", "aux", "grad_norm"):
    out[f"{arch}/{k}"] = met[k].numpy()
  for n, g in seen.items():
    out[f"{arch}/grad/{n}"] = g.numpy()


def dropped(arch, batch):
  """The (token, choice) pairs one process's forward drops at capacity."""
  cfg = config(arch)
  m = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
  real, n = MOE.route, []

  def counted(*a):
    r = real(*a)
    n.append(int((~r.keep & r.valid[..., None]).sum()))
    return r

  MOE.route = counted
  try:
    with torch.no_grad():
      m.loss_fn(batch)
  finally:
    MOE.route = real
  return sum(n)


def main():
  mesh = TrainMesh.from_env((2, 1), "gloo", "cpu")
  d = mesh.coords["data"]
  res, twins = {}, {}
  batches = {arch: batch_of(config(arch), 11 + i)
             for i, arch in enumerate(CASES)}
  if mesh.rank == 0:
    for arch in CASES:
      one_step(arch, None, batches[arch], twins)
    twins["dropped"] = np.array(dropped(CASES[0], batches[CASES[0]]))
    np.savez(f"{OUT}/twin.npz", **twins)
  for arch in CASES:
    rows = B // mesh.data
    shard = {k: v[d * rows:(d + 1) * rows] for k, v in batches[arch].items()}
    one_step(arch, mesh, shard, res)
  np.savez(f"{OUT}/rank{mesh.rank}.npz", **res)
  mesh.close()


main()
'''


def _torchrun(args, timeout=300):
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1")
  return subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", "2", *args], env=env, capture_output=True,
      text=True, timeout=timeout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """({rank: results}, rank 0's one-process twins)."""
  tmp = tmp_path_factory.mktemp("families_dist")
  script = tmp / "ranks.py"
  script.write_text(RANK_SCRIPT)
  proc = _torchrun([str(script), str(tmp)])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  ranks = {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)}
  return ranks, dict(np.load(tmp / "twin.npz"))


@pytest.mark.parametrize("arch", CASES)
def test_data_axis_matches_one_process_on_the_whole_batch(runs, arch):
  """Loss, xent, aux and grad norm, and every gradient handed to the
  optimizer, at 2x1 against one process on the whole batch; both ranks
  hand the optimizer the same bits."""
  ranks, twin = runs
  for k in ("loss", "xent", "aux", "grad_norm"):
    np.testing.assert_allclose(ranks[0][f"{arch}/{k}"], twin[f"{arch}/{k}"],
                               rtol=TOL, atol=TOL * 1e-3, err_msg=k)
  grads = sorted(k for k in twin if k.startswith(f"{arch}/grad/"))
  assert grads and grads == sorted(k for k in ranks[0]
                                   if k.startswith(f"{arch}/grad/"))
  for k in grads:
    want = twin[k]
    np.testing.assert_allclose(ranks[0][k], want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=k)
    assert np.array_equal(ranks[0][k], ranks[1][k]), k
  if arch == "deepseek-moe-16b":
    assert float(twin[f"{arch}/aux"]) > 0
    assert int(twin["dropped"]) > 0   # the groups drop pairs


def test_moe_refuses_a_shard_that_cuts_a_group():
  """A rank whose tokens are not a whole number of the global groups:
  ``moe.data_group_len`` raises, ``moe_ffn`` with a data group raises, and
  the launcher refuses ``--mesh 2x1`` before joining any group."""
  import types

  from repro_torch.configs import get_config, reduced
  from repro_torch.models import moe as MOE
  cfg = reduced(get_config("deepseek-moe-16b"))
  assert MOE.data_group_len(cfg, 512, 2) == 512
  assert MOE.data_group_len(cfg, 1024, 2) == 512
  assert MOE.data_group_len(cfg, 64, 1) == 64
  with pytest.raises(ValueError, match="cuts the MoE groups"):
    MOE.data_group_len(cfg, 256, 2)
  with pytest.raises(ValueError, match="cuts the MoE groups"):
    MOE.moe_ffn(torch.zeros(2, 16, cfg.d_model), None, cfg,
                dp=types.SimpleNamespace(world=2))
  with pytest.raises(SystemExit, match="cuts the MoE groups"):
    launch_train.main(["--arch", "deepseek-moe-16b", "--reduced", "--device",
                       "cpu", "--mesh", "2x1", "--seq-len", "16",
                       "--global-batch", "4", "--steps", "1"])


def _losses(out: str) -> list[float]:
  return [float(line.split("loss")[1].split()[0])
          for line in out.splitlines() if line.startswith("[train] step")]


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_launcher_data_axis_memory_inputs_match_one_process(arch, tmp_path,
                                                            capsys):
  """``launch/train.py --mesh 2x1`` (2 gloo ranks) prints one process's
  losses: each rank's frames / image embeddings are its rows of the
  whole batch's."""
  common = ["--arch", arch, "--reduced", "--device", "cpu", "--seq-len",
            "16", "--global-batch", "4", "--steps", "2", "--ckpt-every", "0"]
  proc = _torchrun(["-m", "repro_torch.launch.train", *common, "--mesh",
                    "2x1", "--dist-backend", "gloo", "--ckpt-dir",
                    str(tmp_path / "mesh")])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "mesh 2x1 backend gloo" in proc.stdout
  launch_train.main([*common, "--ckpt-dir", str(tmp_path / "one")])
  one = _losses(capsys.readouterr().out)
  assert len(one) == 2
  np.testing.assert_allclose(_losses(proc.stdout), one, rtol=0, atol=2e-4)
