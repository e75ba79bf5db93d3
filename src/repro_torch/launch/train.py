"""Training driver: data -> (optional GreeDi coreset selection) -> train
loop with fault-tolerant checkpointing and auto-resume (the port of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --select-coreset
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --select-coreset --steps 6 --ckpt-every 3 --ckpt-dir DIR
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --reduced --mesh 2x2 \\
        --dist-backend gloo --device cpu --steps 4 --ckpt-every 2

Restart protocol:
  * every run begins with ``CheckpointManager.restore_latest_or_none``: a
    restarted job resumes from the newest complete checkpoint (the model's
    ``state_dict()`` and the optimizer state), printing ``[train] resumed
    from step N``; under ``--mesh`` each rank restores its slices of every
    leaf, so a run may resume on another mesh (the elastic reshard);
  * the data are a function of the step: ``SyntheticLM`` batches are pure
    functions of (seed, step), and with ``--select-coreset`` the selected
    document ids ride in each checkpoint's metadata, so a resumed run
    trains on the same coreset (without selecting again) and skips the
    coreset batches the steps before it consumed;
  * checkpoints publish atomically (tmp + rename), so a crash mid-save
    never corrupts the resume point.

``--select-coreset`` selects with ``greedi_select_indices`` at the
reference's sizes (4096 documents of width 64, m = 8, kappa = 256,
k_final = 1024; the facility-location select kernel on the card), then
trains on ``batches_from_indices`` over the selection.  ``--device``
defaults to ``cuda`` and fails when CUDA is missing; ``cpu`` runs the
plain versions.

``--mesh DxM`` (or ``D``, a data axis alone) runs under torchrun (``python
-m torch.distributed.run``), D x M ranks, rank r at (r // M, r % M): the
model is laid out by ``param_specs`` (the model axis as tensor
parallelism, ``models.registry``), each rank takes its data shard of the
global batch (``SyntheticLM.batch(step, shard=d, num_shards=D)``, or rows
d * b .. (d + 1) * b of a coreset batch), and the gradients are averaged
over the data axis in rank order (``train.train_step``).  ``--arch`` takes
every family on one process and on any mesh whose model axis divides its
query heads (``models.registry.check_model_axis``; the MoE experts split
by width, the reference launcher's ``ep=False``).  Over a data
axis an MoE family routes its groups as one process does on the whole
batch, so a rank's tokens (its rows x ``--seq-len``) must be a multiple of
the config's ``group_size``; other sizes are refused before any group is
joined.  The enc-dec and VLM families read their stubbed frontends' input
beside the tokens: ``frames`` / ``img_embeds`` (B, F, d) drawn N(0, 1) for
the global batch from the step (``modality``), each rank taking its rows,
so a data axis and a resumed run see what one process sees.  With
``--select-coreset`` rank 0 selects and the ids go to every rank over the
mesh (one gather), so every rank trains on the same coreset.
``--dist-backend`` is ``nccl`` (one rank a card, the default on CUDA) or
``gloo`` (the CPU, or several ranks sharing one card); nothing switches
either quietly.  Rank 0 prints the ``[train]`` lines; the ``done`` line
carries every rank's peak memory and rank 0's collectives.  ``--mesh``
outside torchrun, a mesh whose D x M is not the world size and a model
axis that does not divide the architecture are refused.  The reference's TPU flags have no
counterpart.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

# the coreset selection of --select-coreset: the reference's sizes
CORESET = dict(n_docs=4096, feat_dim=64, m=8, kappa=256, k_final=1024)


def _coreset_ids(sel, mesh):
  """Rank 0's coreset ids on every rank (one gather over the world)."""
  import numpy as np
  import torch
  k = CORESET["k_final"]
  mine = torch.zeros((k,), dtype=torch.int64, device=mesh.device)
  if mesh.rank == 0:
    mine.copy_(torch.as_tensor(np.asarray(sel), dtype=torch.int64))
  return mesh.world.gather_parts(mine)[0].cpu().numpy()


def modality(cfg, rows: int, step: int, dev) -> dict:
  """The stubbed modality frontend's embeddings a global batch of
  ``rows`` needs: ``frames`` (rows, n_frames, d) for the enc-dec family,
  ``img_embeds`` (rows, n_img_tokens, d) for the VLM, none otherwise;
  N(0, 1) in float32 from a generator seeded by the step."""
  import torch
  name, n = {"encdec": ("frames", cfg.encoder.n_frames),
             "vlm": ("img_embeds", cfg.n_img_tokens)}.get(cfg.family,
                                                          (None, 0))
  if name is None:
    return {}
  g = torch.Generator(device=dev).manual_seed(1_000_003 * step)
  return {name: torch.randn((rows, n, cfg.d_model), generator=g,
                            device=dev)}


def _check_moe_groups(cfg, global_batch: int, seq_len: int, ranks: int):
  """Refuse MoE groups that a rank's shard of the global batch would cut
  (``moe.data_group_len``)."""
  from repro_torch.models.moe import data_group_len
  if cfg.moe.num_experts and global_batch % ranks == 0:
    try:
      data_group_len(cfg, global_batch // ranks * seq_len, ranks)
    except ValueError as e:
      raise SystemExit(f"[train] {e}") from None


def _done_fields(mesh, dev) -> dict:
  """Every rank's peak device memory (GiB, comma-separated in rank order;
  "not measured" on the CPU) and this rank's collectives."""
  import torch
  import torch.distributed as dist
  peak = (torch.cuda.max_memory_allocated(dev) / 2**30
          if dev.type == "cuda" else None)
  got = [None] * mesh.data * mesh.model
  dist.all_gather_object(got, peak)
  return dict(rank_peak_gib=(",".join(f"{p:.6f}" for p in got)
                             if peak is not None else "not measured"),
              gathers=mesh.gathers, gather_bytes=mesh.gather_bytes)


def main(argv=None) -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="qwen3-4b")
  ap.add_argument("--steps", type=int, default=200)
  ap.add_argument("--seq-len", type=int, default=256)
  ap.add_argument("--global-batch", type=int, default=8)
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--reduced", action="store_true",
                  help="use the smoke-size config (CPU-runnable)")
  ap.add_argument("--ckpt-dir",
                  default=os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt"))
  ap.add_argument("--ckpt-every", type=int, default=50)
  ap.add_argument("--select-coreset", action="store_true",
                  help="GreeDi-select training docs before training")
  ap.add_argument("--mesh", default="",
                  help="DxM (data x model) or D, under torchrun: one rank "
                  "a mesh position")
  ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                  help="under torchrun: the process group's backend "
                  "(default nccl on CUDA, gloo on the CPU)")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  args = ap.parse_args(argv)

  import numpy as np
  import torch

  from repro_torch import no_tf32, resolve_device
  from repro_torch.configs import get_config, reduced
  from repro_torch.data.pipeline import (EmbeddedCorpus, SyntheticLM,
                                         batches_from_indices)
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.launch.mesh import TrainMesh, parse_mesh, under_torchrun
  from repro_torch.models import build_model
  from repro_torch.models.registry import check_model_axis
  from repro_torch.train import (CheckpointManager, OptConfig,
                                 init_opt_state, make_train_step, tree_specs)

  no_tf32()
  cfg = get_config(args.arch)
  if args.reduced:
    cfg = reduced(cfg)
  mesh = None
  if args.mesh:
    shape = parse_mesh(args.mesh)
    check_model_axis(cfg, shape[1])
    _check_moe_groups(cfg, args.global_batch, args.seq_len, shape[0])
    if not under_torchrun():
      raise SystemExit("[train] --mesh needs the ranks of a torchrun launch "
                       "(python -m torch.distributed.run), one a mesh "
                       "position")
    backend = args.dist_backend or (
        "nccl" if torch.device(args.device).type == "cuda" else "gloo")
    mesh = TrainMesh.from_env(shape, backend, args.device)
    dev = mesh.device
  elif under_torchrun() or args.dist_backend:
    raise SystemExit("[train] under torchrun pass --mesh DxM (D x M the "
                     "ranks); --dist-backend needs --mesh")
  else:
    dev = resolve_device(args.device)
  lead = mesh is None or mesh.rank == 0
  shard, shards = (0, 1) if mesh is None else (mesh.coords["data"],
                                               mesh.data)
  if args.global_batch % shards:
    raise SystemExit(f"[train] --global-batch {args.global_batch} does not "
                     f"split over {shards} data ranks")
  model = build_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(42),
                      mesh=mesh)
  opt_state = init_opt_state(model)
  opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 10))
  ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
  layout = {} if mesh is None else dict(mesh=mesh,
                                         specs=tree_specs(model.specs))

  # ---- init or resume -----------------------------------------------------
  start_step, meta = 0, {}
  restored, found = ckpt.restore_latest_or_none(
      {"params": model.state_dict(), "opt": opt_state}, device=dev, **layout)
  if restored is not None:
    model.load_state_dict(restored["params"])
    opt_state = restored["opt"]
    start_step, meta = found["step"], found
    if lead:
      print(f"[train] resumed from step {start_step}", flush=True)

  # ---- data (+ the paper's technique: GreeDi coreset selection) ----------
  extra = {}
  if args.select_coreset:
    corpus = EmbeddedCorpus(n_docs=CORESET["n_docs"],
                            feat_dim=CORESET["feat_dim"], vocab=cfg.vocab,
                            seq_len=args.seq_len, device=str(dev))
    if "coreset" in meta:
      sel = np.asarray(meta["coreset"], np.int64)
    else:
      sel = None
      if lead:
        sel = greedi_select_indices(
            torch.Generator().manual_seed(0), corpus.features(),
            m=CORESET["m"], kappa=CORESET["kappa"],
            k_final=CORESET["k_final"])
        print(f"[train] GreeDi selected {len(sel)} / {corpus.n_docs} docs",
              flush=True)
      if mesh is not None:
        sel = _coreset_ids(sel, mesh)
    extra = {"coreset": sel.tolist()}
    batches = batches_from_indices(corpus, sel, args.global_batch,
                                   args.steps, start=start_step)

    def tokens_of(step):
      return {k: v[shard * rows:(shard + 1) * rows]
              for k, v in next(batches).items()}
  else:
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                       global_batch=args.global_batch, device=str(dev))

    def tokens_of(step):
      return data.batch(step, shard=shard, num_shards=shards)

  rows = args.global_batch // shards

  def batch_iter(step):
    mods = modality(cfg, args.global_batch, step, dev)
    return dict(tokens_of(step), **{k: v[shard * rows:(shard + 1) * rows]
                                    for k, v in mods.items()})

  step_fn = make_train_step(model, opt_cfg)
  t0 = time.time()
  saved = None
  for step in range(start_step, args.steps):
    metrics = step_fn(opt_state, batch_iter(step))
    if lead and (step % 10 == 0 or step == args.steps - 1):
      print(f"[train] step {step:5d} loss {float(metrics['loss']):8.4f} "
            f"lr {float(metrics['lr']):.2e} "
            f"gnorm {float(metrics['grad_norm']):.3f} "
            f"({(time.time() - t0):.1f}s)", flush=True)
    if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
      saved = step + 1
      ckpt.save(saved, {"params": model.state_dict(), "opt": opt_state},
                extra=extra, **layout)
  if saved != args.steps:
    ckpt.save(args.steps, {"params": model.state_dict(), "opt": opt_state},
              extra=extra, **layout)
  tail = ""
  if mesh is not None:
    fields = _done_fields(mesh, dev)
    tail = (f" mesh {mesh.data}x{mesh.model} backend {mesh.backend} " +
            " ".join(f"{k}={v}" for k, v in fields.items()))
  if lead:
    print(f"[train] done: steps {start_step}..{args.steps} on {dev} "
          f"({time.time() - t0:.1f}s){tail}", flush=True)
  if mesh is not None:
    mesh.close()


if __name__ == "__main__":
  main()
