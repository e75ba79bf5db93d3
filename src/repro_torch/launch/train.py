"""Training driver: data -> (optional GreeDi coreset selection) -> train
loop with fault-tolerant checkpointing and auto-resume (the port of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --select-coreset
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --select-coreset --steps 6 --ckpt-every 3 --ckpt-dir DIR

Restart protocol:
  * every run begins with ``CheckpointManager.restore_latest_or_none``: a
    restarted job resumes from the newest complete checkpoint (the model's
    ``state_dict()`` and the optimizer state), printing ``[train] resumed
    from step N``;
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
plain versions.  ``--mesh`` (the reference's data / model mesh) raises: it
waits for the ``torch.distributed`` backend (ROADMAP.md queue 1 item 7);
the reference's TPU flags have no counterpart.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

# the coreset selection of --select-coreset: the reference's sizes
CORESET = dict(n_docs=4096, feat_dim=64, m=8, kappa=256, k_final=1024)


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
                  help="not ported: waits for the training half of the "
                  "torch.distributed backend")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  args = ap.parse_args(argv)
  if args.mesh:
    raise NotImplementedError(
        "--mesh: the data / model mesh waits for the training half of the "
        "torch.distributed backend (ROADMAP.md queue 1 item 7; selection "
        "already runs over processes, launch/mesh.py); the port trains on "
        "one device")

  import numpy as np
  import torch

  from repro_torch import no_tf32, resolve_device
  from repro_torch.configs import get_config, reduced
  from repro_torch.data.pipeline import (EmbeddedCorpus, SyntheticLM,
                                         batches_from_indices)
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.models import build_model
  from repro_torch.train import (CheckpointManager, OptConfig,
                                 init_opt_state, make_train_step)

  no_tf32()
  dev = resolve_device(args.device)
  cfg = get_config(args.arch)
  if args.reduced:
    cfg = reduced(cfg)
  model = build_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(42))
  opt_state = init_opt_state(model)
  opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 10))
  ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)

  # ---- init or resume -----------------------------------------------------
  start_step, meta = 0, {}
  restored, found = ckpt.restore_latest_or_none(
      {"params": model.state_dict(), "opt": opt_state}, device=dev)
  if restored is not None:
    model.load_state_dict(restored["params"])
    opt_state = restored["opt"]
    start_step, meta = found["step"], found
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
      sel = greedi_select_indices(
          torch.Generator().manual_seed(0), corpus.features(),
          m=CORESET["m"], kappa=CORESET["kappa"],
          k_final=CORESET["k_final"])
      print(f"[train] GreeDi selected {len(sel)} / {corpus.n_docs} docs",
            flush=True)
    extra = {"coreset": sel.tolist()}
    batches = batches_from_indices(corpus, sel, args.global_batch,
                                   args.steps, start=start_step)
    batch_iter = lambda step: next(batches)  # noqa: E731
  else:
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                       global_batch=args.global_batch, device=str(dev))
    batch_iter = data.batch

  step_fn = make_train_step(model, opt_cfg)
  t0 = time.time()
  saved = None
  for step in range(start_step, args.steps):
    metrics = step_fn(opt_state, batch_iter(step))
    if step % 10 == 0 or step == args.steps - 1:
      print(f"[train] step {step:5d} loss {float(metrics['loss']):8.4f} "
            f"lr {float(metrics['lr']):.2e} "
            f"gnorm {float(metrics['grad_norm']):.3f} "
            f"({(time.time() - t0):.1f}s)", flush=True)
    if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
      saved = step + 1
      ckpt.save(saved, {"params": model.state_dict(), "opt": opt_state},
                extra=extra)
  if saved != args.steps:
    ckpt.save(args.steps, {"params": model.state_dict(), "opt": opt_state},
              extra=extra)
  print(f"[train] done: steps {start_step}..{args.steps} on {dev} "
        f"({time.time() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
  main()
