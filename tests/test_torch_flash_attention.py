"""The port's attention kernel layer against the JAX reference's.

The same numpy inputs (from a seed) go through both packages: the port's
``ref.mha_ref`` against the reference's ``ref.mha_ref``, and the port's
``ops.flash_attention`` (on the CPU its plain path) against the
reference's ``ops.flash_attention``, which runs the Pallas kernel in
interpret mode here.  Tolerances are those of tests/test_kernels.py:
float32 within 1e-4 and bfloat16 within 3e-2 (rtol and atol).  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(b, h, hkv, l, dh, dtype, seed=3):
  """The same values as JAX arrays and torch CPU tensors."""
  r = np.random.default_rng(seed)
  jd, td, _ = DTYPES[dtype]
  arrays = [r.normal(size=(b, n, l, dh)).astype(np.float32)
            for n in (h, hkv, hkv)]
  return ([jnp.asarray(a, jd) for a in arrays],
          [torch.tensor(a).to(td) for a in arrays])


def _close(got, want, tol):
  np.testing.assert_allclose(np.asarray(got.float().numpy()),
                             np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,l,dh", [
    (2, 4, 2, 70, 32), (1, 8, 1, 33, 64), (1, 4, 4, 17, 128)])
def test_mha_ref_matches_reference(b, h, hkv, l, dh, causal, dtype):
  (jq, jk, jv), (tq, tk, tv) = _qkv(b, h, hkv, l, dh, dtype)
  got = ref.mha_ref(tq, tk, tv, causal=causal)
  assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, l, dh)
  _close(got, jref.mha_ref(jq, jk, jv, causal=causal), DTYPES[dtype][2])


def test_mha_ref_scale_and_causal_offset():
  """A non-default scale, and Lq < Lk: the causal mask keeps the (Lk - Lq)
  offset of the reference (the last query sees every key)."""
  r = np.random.default_rng(5)
  q = r.normal(size=(1, 4, 5, 32)).astype(np.float32)
  k = r.normal(size=(1, 2, 12, 32)).astype(np.float32)
  v = r.normal(size=(1, 2, 12, 32)).astype(np.float32)
  for causal in (True, False):
    got = ref.mha_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                      causal=causal, scale=0.3)
    _close(got, jref.mha_ref(q, k, v, causal=causal, scale=0.3), 1e-4)


# a subset of tests/test_kernels.py's sweep, ragged 200 and 96 included
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,l,dh", [
    (2, 4, 2, 128, 64), (1, 8, 1, 200, 32), (1, 2, 1, 96, 64)])
def test_flash_attention_matches_pallas(b, h, hkv, l, dh, dtype):
  (jq, jk, jv), (tq, tk, tv) = _qkv(b, h, hkv, l, dh, dtype)
  got = ops.flash_attention(tq, tk, tv, causal=True)
  tol = DTYPES[dtype][2]
  _close(got, jops.flash_attention(jq, jk, jv, causal=True), tol)
  _close(got, jref.mha_ref(jq, jk, jv, causal=True), tol)


def test_flash_attention_noncausal_and_scale_match_pallas():
  (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, 128, 64, "f32", seed=4)
  _close(ops.flash_attention(tq, tk, tv, causal=False),
         jops.flash_attention(jq, jk, jv, causal=False), 1e-4)
  _close(ops.flash_attention(tq, tk, tv, causal=True, scale=0.05),
         jops.flash_attention(jq, jk, jv, causal=True, scale=0.05), 1e-4)


def test_flash_attention_backends_and_operand_checks():
  """"cuda" refuses CPU tensors, "ref" and "auto" run the plain version on
  them, and the kernel's operand checks name what it takes."""
  _, (q, k, v) = _qkv(1, 4, 2, 40, 32, "f32")
  fa.launches = 0
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    ops.flash_attention(q, k, v, backend="cuda")
  want = ref.mha_ref(q, k, v)
  for backend in ("ref", "auto"):
    torch.testing.assert_close(ops.flash_attention(q, k, v, backend=backend),
                               want, rtol=0, atol=0)
  with pytest.raises(ValueError, match="backend"):
    ops.flash_attention(q, k, v, backend="pallas")
  assert fa.launches == 0  # the plain path is not a launch
  assert ops.launch_counts()["flash_attention"] == 0
  assert "flash_attention" in dispatch.names()

  fa.check_operands(q, k, v)
  fa.check_operands(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
  bad_dh = torch.zeros(1, 4, 40, 48)
  with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
    fa.check_operands(bad_dh, bad_dh[:, :2], bad_dh[:, :2])
  with pytest.raises(ValueError, match="Lq == Lk"):
    fa.check_operands(q, k[:, :, :20], v[:, :, :20])
  with pytest.raises(ValueError, match="multiple"):
    fa.check_operands(q[:, :3], k, v)
  with pytest.raises(TypeError, match="dtypes differ"):
    fa.check_operands(q, k.bfloat16(), v)
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    fa.check_operands(q.half(), k.half(), v.half())
  with pytest.raises(ValueError, match="contiguous"):
    fa.check_operands(torch.zeros(1, 4, 32, 40).transpose(2, 3), k, v)


def test_check_operands_bf16_alignment():
  """bf16 operands feed tensor maps: every B, H, L stride and every base
  address a multiple of 16 bytes (8 elements); float32 keeps the FFMA
  kernel's rule of 4 elements.  The wrapper raises, never copies."""
  wide = torch.zeros(1, 4, 16, 36)             # rows of 36 elements
  for dt in (torch.float32, torch.bfloat16):
    q = wide.to(dt)[..., :32]
    if dt == torch.float32:
      fa.check_operands(q, q[:, :2], q[:, :2])
    else:
      with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.check_operands(q, q[:, :2], q[:, :2])
  flat = torch.zeros(8 + 2 * 40 * 32, dtype=torch.bfloat16)
  shifted = flat[4:4 + 2 * 40 * 32].view(1, 2, 40, 32)  # 8-byte aligned
  with pytest.raises(ValueError, match="aligned to 8 elements"):
    fa.check_operands(shifted, shifted[:, :1], shifted[:, :1])
  ok = flat[8:8 + 2 * 40 * 32].view(1, 2, 40, 32)
  fa.check_operands(ok, ok[:, :1], ok[:, :1])
  _, (q, k, v) = _qkv(1, 4, 2, 40, 64, "bf16")
  fa.check_operands(q, k, v.transpose(1, 2).contiguous().transpose(1, 2))


def _mha_p_bf16(q, k, v, causal, scale=None):
  """``mha_ref`` with the tensor-core kernel's one extra rounding written
  out: float32 logits and softmax numerators, P rounded to bf16 before
  P . V, the row sums l taken from the float32 P, the output cast to bf16."""
  b, h, length, dh = q.shape
  group = h // k.shape[1]
  scale = dh ** -0.5 if scale is None else scale
  kr = k.float().repeat_interleave(group, 1)
  vr = v.float().repeat_interleave(group, 1)
  s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
  if causal:
    keep = torch.ones(length, length, dtype=torch.bool).tril()
    s = torch.where(keep, s, ref.NEG)
  p = torch.exp(s - s.amax(-1, keepdim=True))
  l = p.sum(-1, keepdim=True)
  out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vr) / l
  return out.to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounding_within_tolerance_of_pallas(causal):
  """The arithmetic of the bf16 tensor-core kernel (P rounded to bf16 before
  P . V) against the Pallas kernel in interpret mode, L 200 (ragged), dh 64,
  group 4: within the bf16 tolerance the card holds the kernel to (3e-2,
  rtol and atol)."""
  (jq, jk, jv), (tq, tk, tv) = _qkv(1, 8, 2, 200, 64, "bf16", seed=11)
  got = _mha_p_bf16(tq, tk, tv, causal)
  _close(got, jops.flash_attention(jq, jk, jv, causal=causal), 3e-2)
  # the rounding moves the result, but by far less than the tolerance
  plain = ref.mha_ref(tq, tk, tv, causal=causal)
  assert float((got.float() - plain.float()).abs().max()) < 3e-2 / 2
