"""Quickstart on the PyTorch/CUDA port: select representative exemplars
from a clustered dataset with GreeDi, as in the paper's Tiny-Images
experiment (Sec. 6.1), and compare against the centralized greedy and the
naive baselines.  The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py            # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``FacilityLocationPre`` caches each greedy run's similarity block once
(through the ``pairwise`` kernel) and takes every step as one
``relu_colsum`` launch over it; ``--device cpu`` runs the kernels' plain
versions.  The data are drawn from a seeded ``torch.Generator``: the same
distribution as the JAX example, not the same numbers.
"""
import argparse

import torch

from repro_torch import no_tf32, resolve_device
from repro_torch.core import bounds
from repro_torch.core import objectives as O
from repro_torch.core.greedi import (baselines, centralized_greedy,
                                     greedi_reference)


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  no_tf32()
  dev = resolve_device(args.device)

  # a clustered "image" dataset: 2048 unit-norm vectors around 32 centers
  g = torch.Generator(device=dev).manual_seed(args.seed)
  centers = torch.randn((32, 64), generator=g, device=dev)
  centers = centers / torch.linalg.norm(centers, dim=1, keepdim=True)
  assign = torch.randint(0, 32, (2048,), generator=g, device=dev)
  feats = centers[assign] + 0.3 * torch.randn((2048, 64), generator=g,
                                              device=dev)
  feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)

  k, m = 32, 8
  obj = O.FacilityLocationPre(kernel="linear")   # k-medoid surrogate, Eq. (6)
  init = lambda ef, em, cf=None: obj.init(ef, em, cf)  # noqa: E731

  _, v_central = centralized_greedy(feats, k, objective=obj, init_for=init)
  print(f"centralized greedy          f = {float(v_central):.4f}")

  r = greedi_reference(torch.Generator().manual_seed(args.seed + 1), feats,
                       m=m, kappa=k, k_final=k, objective=obj, init_for=init)
  ratio = float(r.value / v_central)
  print(f"GreeDi (m={m}, kappa=k)       f = {float(r.value):.4f}   "
        f"ratio = {ratio:.3f}")
  print(f"  round-2 solution f = {float(r.value_merged):.4f}, "
        f"best single machine f = {float(r.value_best_single):.4f}")
  print(f"  worst-case bound (Thm 4): {bounds.thm4_bound(m, k):.3f}; "
        f"random-partition bound (Thm 11): {bounds.thm11_bound():.3f}")

  # backend="auto": the fused facility kernels for CUDA tensors, their
  # plain PyTorch versions for CPU tensors
  obj_plain = O.FacilityLocation(kernel="linear", backend="auto")
  b = baselines(torch.Generator().manual_seed(args.seed + 2), feats, m=m,
                k=k, objective=obj_plain,
                init_for=lambda ef, em: obj_plain.init(ef, em))
  for name, v in b.items():
    print(f"  baseline {name:15s} ratio = {float(v / v_central):.3f}")
  return ratio


if __name__ == "__main__":
  main()
