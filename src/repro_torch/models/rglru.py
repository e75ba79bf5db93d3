"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
port of ``src/repro/models/rglru.py``).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prefill evaluates the diagonal linear recurrence with a log-depth scan
in plain PyTorch: Hillis-Steele doubling over the (a, b) pairs, ceil(log2
L) elementwise steps over the whole sequence (the reference's
``jax.lax.associative_scan`` combines in another order, so the two agree
to rounding, not to bits).  Decode is one step.  The surrounding Griffin
block is conv1d + RG-LRU on one branch and a GeLU gate on the other.

Over a model group (``tp``, a ``transformer.TPShard``) a rank runs W / M
channels of the recurrence (contiguous): ``w_x`` and ``w_gate``'s columns,
and the slices of ``conv_w``, ``lam``, ``b_a`` and ``b_i`` (through
``split_group``, backward gathered), line up with them.  ``w_a`` and
``w_i`` are (W, W) with their columns split, so each rank reads the whole
conv output: it is gathered (``layers.gather_summed``, its gradient summed
over the group before the rank's slice).  ``w_out``'s rows are the rank's
channels, its product summed over the group.  A decode cache holds the
rank's conv channels and its (B, W / M) state.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (causal_conv1d, dense_init,
                                       enter_group, gather_summed, gelu,
                                       leave, softplus, split_group)


def lru_width(cfg: ModelConfig) -> int:
  return cfg.rec.lru_width or cfg.d_model


def rglru_shapes(cfg: ModelConfig) -> dict:
  """The block's leaves' shapes by name under ``rec.``."""
  d, w = cfg.d_model, lru_width(cfg)
  return {"w_x": (d, w), "w_gate": (d, w), "conv_w": (cfg.rec.conv_width, w),
          "w_a": (w, w), "b_a": (w,), "w_i": (w, w), "b_i": (w,),
          "lam": (w,), "w_out": (w, d)}


def init_rglru(cfg: ModelConfig, dtype, *, generator, device) -> dict:
  """The reference's distributions: the conv taps N(0, 0.1^2), the gate
  biases 0 and Lambda = linspace(-4, 4, w), float32 (so a^c spans about
  (0.9, 0.999), as in the paper)."""
  shp = rglru_shapes(cfg)
  w = lru_width(cfg)
  kw = dict(generator=generator, device=device)
  f32 = dict(dtype=torch.float32, device=device)
  return {
      "w_x": dense_init(shp["w_x"], dtype, **kw),
      "w_gate": dense_init(shp["w_gate"], dtype, **kw),
      "conv_w": (torch.randn(shp["conv_w"], **kw) * 0.1).to(dtype),
      "w_a": dense_init(shp["w_a"], dtype, **kw),
      "b_a": torch.zeros((w,), **f32),
      "w_i": dense_init(shp["w_i"], dtype, **kw),
      "b_i": torch.zeros((w,), **f32),
      "lam": torch.linspace(-4.0, 4.0, w, **f32),
      "w_out": dense_init(shp["w_out"], dtype, **kw),
  }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the inclusive
  scan of (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), by
  Hillis-Steele doubling (ceil(log2 L) steps, each one pass over the
  sequence).  Returns h, shaped like b."""
  length = b.shape[1]
  shift = 1
  while shift < length:
    b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                   + b[:, shift:]], dim=1)
    if shift * 2 < length:   # the last step needs no new products of a
      a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
    shift *= 2
  return b


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, c: float, h0: torch.Tensor | None = None):
  """x, r, i (B, L, W) float32 -> (h (B, L, W), h_last (B, W))."""
  a = torch.exp(-c * softplus(lam)[None, None, :] * r)       # (B, L, W)
  b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
  if h0 is not None:
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
  h = linear_scan(a, b)
  return h, h[:, -1]


def rglru_decode_step(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                      lam: torch.Tensor, c: float, h: torch.Tensor):
  """One step; x, r, i, h (B, W).  Returns (h_new, h_new)."""
  a = torch.exp(-c * softplus(lam)[None, :] * r)
  h_new = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
  return h_new, h_new


def recurrent_block(x: torch.Tensor, p, cfg: ModelConfig, *,
                    decode_state: tuple | None = None, tp=None):
  """The Griffin recurrent block.  x (B, L, d); ``decode_state`` =
  (conv_state (B, W-1, lru_w), h (B, lru_w)) for decode (L == 1), None for
  training / prefill; a rank's channels over a model axis (``tp``).
  Returns (y (B, L, d), (conv_state, h_last))."""
  group = None if tp is None else tp.group
  x_in = enter_group(x, group)
  xr = x_in @ p.w_x                                          # (B, L, W)
  gate = gelu((x_in @ p.w_gate).float()).to(x.dtype)
  conv_w, lam, b_a, b_i = (split_group(t, group) for t in (
      p.conv_w, p.lam, p.b_a, p.b_i))
  conv_state = None if decode_state is None else decode_state[0]
  xr, conv_new = causal_conv1d(xr, conv_w, conv_state)
  xr32 = xr.float()
  xa = xr32 if group is None else gather_summed(xr, group).float()
  r = torch.sigmoid(xa @ p.w_a.float() + b_a)
  i = torch.sigmoid(xa @ p.w_i.float() + b_i)
  if decode_state is None:
    h, h_last = rglru_scan(xr32, r, i, lam, cfg.rec.c)
  else:
    h1, h_last = rglru_decode_step(xr32[:, 0], r[:, 0], i[:, 0], lam,
                                   cfg.rec.c, decode_state[1])
    h = h1[:, None]
  seq = group if tp is not None and tp.seq else None
  return (leave((h.to(x.dtype) * gate) @ p.w_out, group, seq),
          (conv_new, h_last))
