"""Sparse GP inference with a GreeDi-selected active set (Sec. 3.4.1 / 6.2),
on the PyTorch/CUDA port: the counterpart of ``examples/active_set_gp.py``.

End-to-end: select an active set S maximizing the IVM information gain with
the distributed protocol, then run GP regression with the selected points
and measure test RMSE against (a) a random active set of the same size and
(b) the centralized greedy selection.  The greedy steps run the
``info_select`` CUDA kernel on the card; ``--device cpu`` runs its plain
PyTorch version.

    PYTHONPATH=src python examples/active_set_gp_torch.py            # card
    PYTHONPATH=src python examples/active_set_gp_torch.py --device cpu

The data are drawn from a seeded ``torch.Generator``: the same
distribution as the JAX example, not the same numbers.
"""
import argparse

import torch

from repro_torch import no_tf32, resolve_device
from repro_torch.core import objectives as O
from repro_torch.core.greedi import centralized_greedy, greedi_reference

H, SIGMA = 0.75, 0.3


def gp_predict(x_train, y_train, x_test, active_idx):
  """GP regression using only the active set (Sec. 3.4.1, Eqs. 3-4)."""
  xa = x_train[active_idx]
  ya = y_train[active_idx]
  eye = torch.eye(len(active_idx), device=xa.device)
  kaa = O.rbf_kernel(xa, xa, h=H) + SIGMA ** 2 * eye
  kta = O.rbf_kernel(x_test, xa, h=H)
  return kta @ torch.linalg.solve(kaa, ya)


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  no_tf32()
  dev = resolve_device(args.device)

  # a smooth nonlinear function on 8-dim inputs
  g = torch.Generator(device=dev).manual_seed(args.seed)
  x = torch.randn((1024, 8), generator=g, device=dev) * 0.8
  w = torch.randn((8,), generator=g, device=dev)

  def f(v):
    return torch.sin(v @ w) + 0.3 * torch.cos(2.0 * v[:, 0])

  y = f(x) + SIGMA * torch.randn((1024,), generator=g, device=dev)
  x_test = torch.randn((256, 8), generator=g, device=dev) * 0.8
  y_test = f(x_test)

  k, m = 48, 8
  # backend="auto": the gain sweep runs through the info-gain CUDA kernels
  # for CUDA tensors, their plain PyTorch versions for CPU tensors
  obj = O.InformationGain(k_max=k, kernel="rbf", kernel_kwargs=(("h", H),),
                          sigma=SIGMA, backend="auto")

  def init(ef, em):
    return obj.init_d(8, device=ef.device)

  def rmse(idx):
    pred = gp_predict(x, y, x_test, idx)
    return float(torch.sqrt(torch.mean((pred - y_test) ** 2)))

  r = greedi_reference(torch.Generator().manual_seed(args.seed + 1), x, m=m,
                       kappa=k, k_final=k, objective=obj, init_for=init)
  greedi_idx = r.sel_gids[r.sel_valid]
  rc, v_c = centralized_greedy(x, k, objective=obj, init_for=init)
  central_idx = rc.idx[rc.idx >= 0]
  rand_idx = torch.randperm(1024, generator=g, device=dev)[:k]

  print(f"information gain: GreeDi {float(r.value):.2f} vs centralized "
        f"{float(v_c):.2f} (ratio {float(r.value / v_c):.3f})")
  print(f"test RMSE  random active set      : {rmse(rand_idx):.4f}")
  print(f"test RMSE  GreeDi active set      : {rmse(greedi_idx):.4f}")
  print(f"test RMSE  centralized active set : {rmse(central_idx):.4f}")


if __name__ == "__main__":
  main()
