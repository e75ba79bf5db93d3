"""GQA flash attention for prefill: the port of the TPU kernel
``src/repro/kernels/flash_attention.py`` ``flash_attention_pallas``.

q (B, H, L, dh) against k, v (B, Hkv, L, dh), query head h reading KV head
h // (H / Hkv), causal or not, with float32 arithmetic and the output in
q's dtype.  The CUDA kernel is ``csrc/flash_attention.cu`` (see the header
there for its bound and design); its plain version is ``ref.mha_ref``.

The reference's ``ops.flash_attention`` pads L to its tile and passes the
true length as ``lk_valid``; the CUDA kernels mask ragged lengths
themselves, so this wrapper passes the tensors as they are, strided views
included (dh must be contiguous).  Meta tensors (the dry run) take the
meta route, ``kernels.meta``.  bfloat16 operands go to the tensor-core
kernel ``csrc/flash_attention_tc.cu`` (wgmma, TMA loads through tensor maps
built from the operands' strides); float32 operands to the FFMA kernel
``csrc/flash_attention.cu``, which keeps float32 arithmetic throughout.
The kernels have no backward: a call that autograd would have to
differentiate raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0     # launches of either flash kernel through this wrapper
tc_launches = 0  # of them, launches of csrc/flash_attention_tc.cu (bf16)

HEAD_DIMS = (32, 64, 128)  # the head widths the kernel is built for


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
  """Shapes, dtypes and strides the kernel takes; raises on anything else.

  q (B, H, L, dh), k and v (B, Hkv, L, dh) with H a multiple of Hkv, one
  dtype (float32 or bfloat16), dh in ``HEAD_DIMS`` and contiguous.  Every
  other stride and every base address is a multiple of 16 bytes for
  bfloat16 (8 elements: the tensor maps' rule) and of 4 elements for
  float32 (the FFMA kernel loads 4 at a time).
  """
  name = "flash_attention"
  for t in (q, k, v):
    if t.dim() != 4:
      raise ValueError(f"{name}: operands must be (B, H, L, dh), got shape "
                       f"{tuple(t.shape)}")
  b, hq, lq, dh = q.shape
  if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
    raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do "
                     f"not match q {tuple(q.shape)}")
  if k.shape[2] != lq:
    raise ValueError(f"{name}: Lq == Lk (self-attention), got {lq} and "
                     f"{k.shape[2]}")
  hkv = k.shape[1]
  if hkv < 1 or hq % hkv:
    raise ValueError(f"{name}: {hq} query heads are not a multiple of {hkv} "
                     "KV heads")
  if dh not in HEAD_DIMS:
    raise ValueError(f"{name}: head width {dh} not supported; the kernel "
                     f"takes {HEAD_DIMS}")
  if q.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
  if k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError(f"{name}: dtypes differ: {q.dtype}, {k.dtype}, "
                    f"{v.dtype}")
  align = 8 if q.dtype == torch.bfloat16 else 4
  for t in (q, k, v):
    if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]):
      raise ValueError(f"{name}: dh must be contiguous and the B, H, L "
                       f"strides multiples of {align} elements for "
                       f"{t.dtype}, got strides {t.stride()}")
    if t.data_ptr() % (align * t.element_size()):
      raise ValueError(f"{name}: base address not aligned to {align} "
                       "elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
  """Attention output (B, H, L, dh) in q's dtype.

  ``scale`` defaults to dh ** -0.5.  The FFMA kernel (float32) multiplies
  q by it before the product, as the TPU kernel does; the tensor-core
  kernel (bfloat16) multiplies the float32 logits, so q is not rounded
  again.  Tensors on the CPU take the plain version; CUDA tensors launch a
  kernel or raise.
  """
  if q.is_meta:
    from repro_torch.kernels import meta
    return meta.flash_attention(q, k, v, causal)
  if not q.is_cuda:
    return ref.mha_ref(q, k, v, causal=causal, scale=scale)
  global launches, tc_launches
  check_operands(q, k, v)
  if k.device != q.device or v.device != q.device:
    raise ValueError(f"flash_attention: operands on {q.device}, {k.device}, "
                     f"{v.device}")
  if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                  or v.requires_grad):
    raise RuntimeError("flash_attention: the kernel has no backward; call it "
                       "under torch.no_grad()")
  b, hq, lq, dh = q.shape
  out = torch.empty((b, hq, lq, dh), dtype=q.dtype, device=q.device)
  if out.numel() == 0:
    return out
  if scale is None:
    scale = dh ** -0.5
  bf16 = q.dtype == torch.bfloat16
  entry = "sm90_flash_attention_tc" if bf16 else "sm90_flash_attention"
  with torch.cuda.device(q.device):
    fn = build.entry(entry)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], lq, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal))
    err = fn(*args, float(scale), build.stream_of(q))
  build.check(err, entry)
  launches += 1
  tc_launches += bf16
  return out
