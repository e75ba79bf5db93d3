"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip where there is none (the decision
is taken inside the fixture, never at import).  They import no JAX, so
they run on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 within 2e-5 relative to the largest magnitude (1e-4 for
gain sums over more than 16k eval rows, summed in another order), bf16
within 3e-2; top-1 indices equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (torch.float32, 2e-5), "bf16": (torch.bfloat16, 3e-2)}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels run only on the card")
  from repro_torch import no_tf32
  no_tf32()
  return torch.device("cuda")


def _close(got, want, tol):
  got = got.float().cpu().numpy()
  want = want.float().cpu().numpy()
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cuda_kernels_match_plain(cuda_device, kernel, dtype):
  td, tol = DTYPES[dtype]
  r = np.random.default_rng(6)
  for (P, ne, nc, d) in [(None, 100, 70, 17), (3, 300, 257, 64),
                         (1, 20000, 300, 64)]:
    lead = () if P is None else (P,)
    dev = cuda_device
    ev = torch.tensor(r.normal(size=(*lead, ne, d)), device=dev).to(td)
    cd = torch.tensor(r.normal(size=(*lead, nc, d)), device=dev).to(td)
    cov = torch.tensor(np.abs(r.normal(size=(*lead, ne))), device=dev).float()
    mask = torch.tensor(r.uniform(size=(*lead, ne)) > 0.1, device=dev).float()
    ok = torch.tensor(r.uniform(size=(*lead, nc)) > 0.3, device=dev)
    s = ops.pairwise(ev, cd, kernel=kernel)
    g = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
    b, i = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
    torch.cuda.synchronize()
    gw = ref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel)
    bw, iw = ref.masked_top1(gw, ok)
    long_tol = tol if ne <= 16384 else max(tol, 1e-4)
    _close(s, ref.pairwise_ref(ev, cd, kernel=kernel), tol)
    _close(g, gw, long_tol)
    assert torch.equal(i.cpu(), iw.cpu())
    _close(b, bw, long_tol)


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_check_operands(cuda_device):
  x = torch.randn(4, 50, 8, device=cuda_device)
  ops.reset_launch_counts()
  ops.pairwise(x, x[0], kernel="linear")
  ops.facility_gain(x, x, torch.zeros(4, 50, device=cuda_device),
                    torch.ones(50, device=cuda_device))
  assert ops.launch_counts() == {"pairwise": 1, "facility_gain": 1,
                                 "facility_select": 0}
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    ops.pairwise(x.half(), x.half())
  with pytest.raises(ValueError, match="contiguous"):
    ops.pairwise(x.transpose(1, 2), x)
