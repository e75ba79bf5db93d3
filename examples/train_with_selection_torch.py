"""End-to-end driver on the port: GreeDi coreset selection -> LM training
(the counterpart of examples/train_with_selection.py).

The paper motivates distributed submodular maximization for "data subset
selection for training complex models"; this example closes that loop:

  1. build a clustered document corpus (embeddings + token sequences);
  2. select a coreset with GreeDi (facility location);
  3. train a qwen3-family model on (a) the coreset and (b) a random subset
     of the same size, and compare eval loss on held-out docs drawn from
     ALL clusters -- coverage of the embedding space translates into
     coverage of the token distribution.

Defaults are the reference's (--full-size trains a ~100M-parameter model
for a few hundred steps); ``--device`` defaults to ``cuda``, ``cpu`` runs
the plain versions of the kernels.

    PYTHONPATH=src python examples/train_with_selection_torch.py [--steps 120]
    PYTHONPATH=src python examples/train_with_selection_torch.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import no_tf32, resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import EmbeddedCorpus, batches_from_indices
from repro_torch.data.selection import coverage_ratio, greedi_select_indices
from repro_torch.models import build_model
from repro_torch.train import (OptConfig, init_opt_state, make_eval_step,
                               make_train_step)


def train(cfg, dev, corpus, indices, steps, batch_size, eval_batch, label):
  model = build_model(cfg, device=dev, remat=None,
                      generator=torch.Generator(device=dev).manual_seed(42))
  opt = init_opt_state(model)
  step_fn = make_train_step(model, OptConfig(
      lr=1e-3, warmup_steps=max(steps // 10, 5), total_steps=steps))
  eval_fn = make_eval_step(model)
  t0 = time.time()
  for step, batch in enumerate(
      batches_from_indices(corpus, indices, batch_size, steps)):
    metrics = step_fn(opt, batch)
    if step % 20 == 0:
      print(f"  [{label}] step {step:4d} loss {float(metrics['loss']):.4f}",
            flush=True)
  ev = float(eval_fn(eval_batch)["loss"])
  print(f"  [{label}] eval loss {ev:.4f}  ({time.time()-t0:.0f}s)")
  return ev


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=120)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--coreset", type=int, default=256)
  ap.add_argument("--full-size", action="store_true",
                  help="~100M params, a few hundred steps (needs a big box)")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  args = ap.parse_args(argv)

  no_tf32()
  dev = resolve_device(args.device)
  cfg = get_config("qwen3-4b")
  if args.full_size:
    cfg = dataclasses.replace(cfg, n_layers=8, d_model=768, n_heads=12,
                              n_kv_heads=4, head_dim=64, d_ff=2048,
                              vocab=32768)  # ~100M params
    seq_len = 512
  else:
    cfg = reduced(cfg)
    seq_len = 64

  corpus = EmbeddedCorpus(n_docs=4096, feat_dim=64, vocab=cfg.vocab,
                          seq_len=seq_len, n_clusters=48, device=str(dev))
  feats = corpus.features()

  # --- the paper's technique: two-round distributed selection -------------
  t0 = time.time()
  sel = greedi_select_indices(torch.Generator().manual_seed(0), feats, m=8,
                              kappa=args.coreset // 4, k_final=args.coreset)
  cov = coverage_ratio(feats, sel, args.coreset)
  print(f"GreeDi selected {len(sel)} docs in {time.time()-t0:.0f}s; "
        f"facility-location coverage = {cov:.3f} of centralized greedy")
  assign = corpus.cluster_assignments().cpu().numpy()
  print(f"coreset covers {len(np.unique(assign[sel]))}/48 clusters")

  rng = np.random.default_rng(0)
  rand = rng.choice(corpus.n_docs, size=len(sel), replace=False)
  print(f"random subset covers {len(np.unique(assign[rand]))}/48 clusters")

  # held-out eval batch spanning all clusters
  eval_batch = corpus.tokens_for(rng.choice(corpus.n_docs, size=32,
                                            replace=False))

  ev_core = train(cfg, dev, corpus, sel, args.steps, args.batch, eval_batch,
                  "greedi-coreset")
  ev_rand = train(cfg, dev, corpus, rand, args.steps, args.batch,
                  eval_batch, "random-subset")
  print(f"\neval loss: greedi-coreset {ev_core:.4f} vs random {ev_rand:.4f} "
        f"({'BETTER' if ev_core < ev_rand else 'not better'})")
  return ev_core, ev_rand


if __name__ == "__main__":
  main()
