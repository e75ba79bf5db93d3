"""Mamba-2 block: state-space duality (SSD) with a chunked scan (the port of
``src/repro/models/ssm.py``).

Within a chunk the recurrence is evaluated as a masked, decay-weighted
attention-like product; across chunks a sequential loop carries the
(B, H, P, N) state, so only one (B, H, lc, lc) decay block is live at a
time.  Under autograd each chunk runs inside ``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint`` does, and is recomputed in the backward
pass.  Decode is the exact recurrence h <- exp(dt A) h + dt B x, one step.
Everything past the input projection runs in float32, as in the reference.

Over a model group (``tp``, a ``transformer.TPShard``) a rank runs its
nh / M heads (contiguous).  ``w_in``'s columns are split contiguously
over [z | xBC | dt], so they do not line up with heads: the projection is
gathered whole on every rank (``layers.gather_summed``, whose backward
sums the ranks' gradients before taking the slice), and each rank takes
its heads' z, x and dt and the whole B and C (``n_groups`` = 1 is shared
by every head).  The replicated leaves a rank reads by its heads'
slice (``a_log``, ``dt_bias``, ``d_skip``, ``norm``, ``conv_w``'s x
columns) enter through ``split_group`` (backward gathered); ``conv_w``'s B
and C columns, which every rank reads whole, through ``enter_group``
(backward summed).  The gated RMSNorm normalizes over the whole
``d_inner`` (its sum of squares summed over the group), and ``w_out``'s
rows are the rank's heads' channels, its product summed over the group.
A decode cache holds the rank's conv channels (its x channels, then B and
C) and its heads' (B, nh / M, P, N) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (causal_conv1d, dense_init,
                                       enter_group, gather_summed, leave,
                                       rms_norm, softplus, split_group)


def d_inner(cfg: ModelConfig) -> int:
  return cfg.ssm.expand * cfg.d_model


def n_heads(cfg: ModelConfig) -> int:
  return d_inner(cfg) // cfg.ssm.head_dim


def conv_dim(cfg: ModelConfig) -> int:
  return d_inner(cfg) + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


def mamba_shapes(cfg: ModelConfig) -> dict:
  """The block's leaves' shapes by name under ``mamba.``."""
  d, di, s, nh = cfg.d_model, d_inner(cfg), cfg.ssm, n_heads(cfg)
  return {"w_in": (d, 2 * di + 2 * s.n_groups * s.d_state + nh),
          "conv_w": (s.conv_width, conv_dim(cfg)), "a_log": (nh,),
          "dt_bias": (nh,), "d_skip": (nh,), "norm": (di,),
          "w_out": (di, d)}


def init_mamba(cfg: ModelConfig, dtype, *, generator, device) -> dict:
  """The reference's distributions: ``w_in`` projects to [z (di), xBC (di
  + 2 g n), dt (nh)]; the conv taps N(0, 0.1^2); a_log = log(linspace(1,
  16, nh)), dt_bias 0, d_skip 1 and the norm gain 0, all float32."""
  shp = mamba_shapes(cfg)
  nh = n_heads(cfg)
  kw = dict(generator=generator, device=device)
  f32 = dict(dtype=torch.float32, device=device)
  return {
      "w_in": dense_init(shp["w_in"], dtype, **kw),
      "conv_w": (torch.randn(shp["conv_w"], **kw) * 0.1).to(dtype),
      "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
      "dt_bias": torch.zeros((nh,), **f32),
      "d_skip": torch.ones((nh,), **f32),
      "norm": torch.zeros(shp["norm"], **f32),
      "w_out": dense_init(shp["w_out"], dtype, **kw),
  }


def _segsum(a: torch.Tensor) -> torch.Tensor:
  """a (..., l) log-decays -> (..., l, l): seg[i, j] = sum_{t=j+1..i} a_t
  (the decay from step j to step i), -inf above the diagonal."""
  l = a.shape[-1]
  cum = torch.cumsum(a, dim=-1)
  seg = cum[..., :, None] - cum[..., None, :]
  mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
  return seg.masked_fill(~mask, float("-inf"))


def _chunk(hprev, xck, ack, bck, cck, rep: int):
  """One chunk: the intra-chunk quadratic term plus the carried state's.
  xck (B, lc, H, P) already times dt; ack (B, lc, H) log-decays; bck, cck
  (B, lc, G, N); hprev (B, H, P, N).  Returns (h_new, y (B, lc, H, P))."""
  br = bck.repeat_interleave(rep, dim=2)                     # (B, lc, H, N)
  cr = cck.repeat_interleave(rep, dim=2)
  ldec = torch.exp(_segsum(ack.movedim(1, -1)))              # (B, H, lc, lc)
  scores = torch.einsum("bshn,bthn->bhst", cr, br)
  y_diag = torch.einsum("bhst,bthp->bshp", scores * ldec, xck)
  a_cum = torch.cumsum(ack, dim=1)                           # (B, lc, H)
  a_tot = a_cum[:, -1]                                       # (B, H)
  decay_to_end = torch.exp(a_tot[:, None] - a_cum)
  state_c = torch.einsum("bthn,bthp->bhpn", br * decay_to_end[..., None],
                         xck)
  decay_from_start = torch.exp(a_cum)
  y_off = torch.einsum("bshn,bhpn->bshp", cr * decay_from_start[..., None],
                       hprev)
  hnew = hprev * torch.exp(a_tot)[..., None, None] + state_c
  return hnew, y_diag + y_off


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
  """The SSD scan.  x (B, L, H, P); dt (B, L, H); b, c (B, L, G, N); h0
  (B, H, P, N) or None (zeros).  Returns (y (B, L, H, P) float32, h_final
  (B, H, P, N) float32).

  A ragged tail is zero-padded: dt = 0 there gives a decay of exp(0) = 1
  and a zero input, so the padded steps leave the carried state (and so
  h_final) unchanged."""
  bb, l, h, p = x.shape
  g = b.shape[2]
  chunk = min(chunk, l)
  l_true = l
  pad = (-l) % chunk
  if pad:
    x = F.pad(x, (0, 0, 0, 0, 0, pad))
    dt = F.pad(dt, (0, 0, 0, pad))
    b = F.pad(b, (0, 0, 0, 0, 0, pad))
    c = F.pad(c, (0, 0, 0, 0, 0, pad))
    l = l + pad
  rep = h // g
  a = -torch.exp(a_log)[None, None, :] * dt                  # (B, L, H) <= 0
  xbar = x.float() * dt[..., None]
  b, c = b.float(), c.float()
  hcur = (torch.zeros((bb, h, p, b.shape[3]), dtype=torch.float32,
                      device=x.device) if h0 is None else h0.float())
  recompute = torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, dt, a_log, b, c, hcur))
  ys = []
  for c0 in range(0, l, chunk):
    part = (xbar[:, c0:c0 + chunk], a[:, c0:c0 + chunk],
            b[:, c0:c0 + chunk], c[:, c0:c0 + chunk])
    if recompute:
      hcur, y = checkpoint(_chunk, hcur, *part, rep, use_reentrant=False)
    else:
      hcur, y = _chunk(hcur, *part, rep)
    ys.append(y)
  return torch.cat(ys, dim=1)[:, :l_true], hcur


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
  """One token.  x (B, H, P); dt (B, H); b, c (B, G, N); h (B, H, P, N).
  Returns (y (B, H, P), h_new), float32."""
  rep = h.shape[1] // b.shape[1]
  b = b.float().repeat_interleave(rep, dim=1)                # (B, H, N)
  c = c.float().repeat_interleave(rep, dim=1)
  a = torch.exp(-torch.exp(a_log)[None, :] * dt)             # (B, H)
  xbar = x.float() * dt[..., None]                           # (B, H, P)
  h_new = h * a[..., None, None] + torch.einsum("bhn,bhp->bhpn", b, xbar)
  y = torch.einsum("bhn,bhpn->bhp", c, h_new)
  return y, h_new


def mamba_block(x: torch.Tensor, p, cfg: ModelConfig, *,
                decode_state: tuple | None = None, tp=None):
  """x (B, L, d).  Training / prefill when ``decode_state`` is None;
  otherwise ``decode_state = (conv_state (B, W-1, conv_dim), ssm_state
  (B, H, P, N))`` (a rank's channels and heads over a model axis) and L ==
  1.  Returns (y (B, L, d), (conv_state, ssm_state)) after the call."""
  bdim, l, _ = x.shape
  s = cfg.ssm
  di = d_inner(cfg)
  nh = n_heads(cfg)
  gn = s.n_groups * s.d_state
  group = None if tp is None else tp.group

  if group is None:
    zxbcdt = x @ p.w_in
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * gn, nh], dim=-1)
    conv_w, a_log, dt_bias, d_skip, norm = (p.conv_w, p.a_log, p.dt_bias,
                                            p.d_skip, p.norm)
  else:   # the rank's heads h0 .. h0 + nh / M - 1 of the whole projection
    m, r = group.world, group.rank
    zxbcdt = gather_summed(enter_group(x, group) @ p.w_in, group)
    dl, hl = di // m, nh // m        # the rank's x channels and heads
    z = zxbcdt.narrow(-1, r * dl, dl)
    xbc = torch.cat([zxbcdt.narrow(-1, di + r * dl, dl),
                     zxbcdt.narrow(-1, 2 * di, 2 * gn)], dim=-1)
    dt_raw = zxbcdt.narrow(-1, 2 * (di + gn) + r * hl, hl)
    conv_w = torch.cat([split_group(p.conv_w[:, :di], group),
                        enter_group(p.conv_w[:, di:], group)], dim=-1)
    a_log, dt_bias, d_skip, norm = (split_group(t, group) for t in (
        p.a_log, p.dt_bias, p.d_skip, p.norm))
    di, nh = dl, hl
  dt = softplus(dt_raw.float() + dt_bias)                    # (B, L, H)
  conv_state = None if decode_state is None else decode_state[0]
  xbc, conv_new = causal_conv1d(xbc, conv_w, conv_state)
  xbc = F.silu(xbc.float()).to(x.dtype)
  xin, b, c = torch.split(xbc, [di, gn, gn], dim=-1)
  xh = xin.reshape(bdim, l, nh, s.head_dim)
  bh = b.reshape(bdim, l, s.n_groups, s.d_state)
  ch = c.reshape(bdim, l, s.n_groups, s.d_state)

  if decode_state is None:
    y, h_last = ssd_chunked(xh, dt, a_log, bh, ch, s.chunk)
  else:
    y1, h_last = ssd_decode_step(xh[:, 0], dt[:, 0], a_log, bh[:, 0],
                                 ch[:, 0], decode_state[1])
    y = y1[:, None]
  y = y + d_skip[None, None, :, None] * xh.float()
  y = y.reshape(bdim, l, di)
  # gated RMSNorm (Mamba-2): norm(y * silu(z)), over the whole d_inner
  y = y * F.silu(z.float())
  y = rms_norm(y.to(x.dtype), norm, cfg.rmsnorm_eps, group)
  seq = group if tp is not None and tp.seq else None
  return leave(y @ p.w_out, group, seq), (conv_new, h_last)
