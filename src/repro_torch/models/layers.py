"""Shared primitive layers: norms, rope, initializers, the SwiGLU MLP (the
port of ``src/repro/models/layers.py``).

Matmul weights are stored (in_dim, out_dim), the reference's layout, so
``x @ w`` is the same product and carrying weights across is a copy.  Every
cast sits where the reference has it: bf16 parity depends on it.
``jax.nn.gelu`` is the tanh approximation by default, so ``gelu`` is
``F.gelu(approximate="tanh")``; ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)``.

The model axis's communication ops are autograd functions over a group
(a ``launch.mesh.ProcessMesh``): ``enter_group`` (identity forward, the
group's sum backward: a replicated input entering a split region),
``leave_group`` (the sum forward, identity backward: partial products
leaving it), ``gather_group`` (a dim, the last by default, gathered
forward, the rank's slice backward), ``split_group`` (the rank's slice
forward, gathered backward), ``scatter_sum`` (the sum's slice forward,
gathered backward: sequence sharding's reduce-scatter) and ``all_to_all``
(expert parallelism's exchange, its own inverse).  ``leave`` is the exit
onto the residual stream, summed or, under sequence sharding,
reduce-scattered by sequence.  Two compositions: ``gather_summed`` gathers
an activation that each rank then reads a different part of (its
gradient summed over the group, then the rank's slice: a reduce-scatter),
and ``rms_norm(group=)`` normalizes over a last dim split over the group
(the sum of squares summed forward and its gradient summed backward).
Each sum is the group's rank-ordered sum, so every rank gets the same
bits, forward and backward; a group of one rank (or None) makes each op
the identity.
"""
from __future__ import annotations

import torch


def dense_init(shape, dtype, *, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
  """Normal(0, 1) * fan_in ** -0.5 (or ``scale``), drawn in float32 and
  cast to ``dtype``."""
  if scale is None:
    scale = shape[0] ** -0.5
  return torch.randn(shape, generator=generator, device=device).mul_(
      scale).to(dtype)


def embed_init(shape, dtype, *, generator: torch.Generator,
               device) -> torch.Tensor:
  return torch.randn(shape, generator=generator, device=device).mul_(
      0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             group=None) -> torch.Tensor:
  """x * rsqrt(mean(x^2) + eps) * (1 + gamma), in float32, cast back.
  With ``group`` the last dim is one of the group's equal slices of the
  normalized dim (``gamma`` the rank's slice too): the mean is the sum of
  squares summed over the group (forward and, for the shared mean's
  gradient, backward) over the whole width."""
  dt = x.dtype
  x = x.float()
  if _alone(group):
    var = torch.mean(x * x, dim=-1, keepdim=True)
  else:
    ss = leave_group((x * x).sum(dim=-1, keepdim=True), group)
    var = enter_group(ss, group) / (x.shape[-1] * group.world)
  return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
  return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
  """x: (..., L, dh); positions: (L,) or broadcastable to x[..., :, 0].
  Rotates the two halves of dh (not interleaved pairs)."""
  dh = x.shape[-1]
  freqs = rope_freqs(dh, theta, device=x.device)            # (dh/2,)
  angles = positions[..., :, None].float() * freqs          # (L, dh/2)
  cos, sin = torch.cos(angles), torch.sin(angles)
  x1, x2 = x.float().chunk(2, dim=-1)
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
  """(silu(x @ w_gate) * (x @ w_up)) @ w_down, the SiLU in float32 and cast
  to x's dtype before the product with the up projection."""
  g = x @ w_gate
  u = x @ w_up
  return (torch.nn.functional.silu(g.float()).to(x.dtype) * u) @ w_down


def gelu(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.gelu``'s default: the tanh approximation."""
  return torch.nn.functional.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
  return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
  """gelu(x @ w_up) @ w_down, the GeLU in float32 and cast back."""
  return gelu((x @ w_up).float()).to(x.dtype) @ w_down


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
  """Depthwise causal convolution.  x (B, L, C); w (W, C); ``state`` the
  (B, W-1, C) inputs before x (zeros when None).  Returns (y (B, L, C),
  new_state (B, W-1, C)): the last W-1 inputs, which a decode step carries
  into the next.  The taps accumulate in x's dtype in the reference's
  order (tap 0, the oldest input, first)."""
  width = w.shape[0]
  if state is None:
    state = torch.zeros(x.shape[:-2] + (width - 1, x.shape[-1]),
                        dtype=x.dtype, device=x.device)
  xp = torch.cat([state.to(x.dtype), x], dim=-2)            # (B, L+W-1, C)
  length = x.shape[-2]
  y = torch.zeros_like(x)
  for i in range(width):
    y = y + xp[..., i:i + length, :] * w[i]
  return y, xp[..., xp.shape[-2] - (width - 1):, :]


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  """Per-token negative log-likelihood in float32: logsumexp(logits) minus
  the gold logit.  logits (..., V); labels (...).

  The gold logit is a ``gather``: picking one element gives the value of
  the reference's one-hot masked sum (which it uses to keep a
  vocab-sharded axis sharded, a concern of the GSPMD layer only).
  """
  logits = logits.float()
  logz = torch.logsumexp(logits, dim=-1)
  gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
  return logz - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
  """Mean masked token cross-entropy in float32.  logits (B, S, V); labels
  and mask (B, S)."""
  nll = token_nll(logits, labels) * mask
  return nll.sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# the model axis's communication ops
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return ctx.group.sum(g), None


class _Leave(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group):
    return group.sum(x)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _Gather(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
    return group.all_gather(x, dim=dim)

  @staticmethod
  def backward(ctx, g):
    return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n).contiguous(),
            None, None)


class _Split(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    n = x.shape[dim] // group.world
    return x.narrow(dim, group.rank * n, n).clone()

  @staticmethod
  def backward(ctx, g):
    return ctx.group.all_gather(g, dim=ctx.dim), None, None


class _Scatter(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return group.reduce_scatter(x, dim=dim)

  @staticmethod
  def backward(ctx, g):
    return ctx.group.all_gather(g, dim=ctx.dim), None, None


class _Swap(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return group.all_to_all(x, dim=0)

  @staticmethod
  def backward(ctx, g):
    return ctx.group.all_to_all(g.contiguous(), dim=0), None


def _alone(group) -> bool:
  return group is None or group.world == 1


def enter_group(x: torch.Tensor, group) -> torch.Tensor:
  """Identity forward; the gradient summed over ``group`` backward."""
  return x if _alone(group) else _Enter.apply(x, group)


def leave_group(x: torch.Tensor, group) -> torch.Tensor:
  """The sum over ``group`` forward (float32 accumulation, cast back);
  identity backward."""
  return x if _alone(group) else _Leave.apply(x, group)


def gather_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
  """Every rank's ``dim`` (the last by default) concatenated in rank order
  forward; the rank's slice of the gradient backward."""
  return x if _alone(group) else _Gather.apply(x, group, dim)


def gather_summed(x: torch.Tensor, group) -> torch.Tensor:
  """``gather_group`` for an activation whose consumers differ by rank
  (each reads another part of the whole): the last dim gathered forward;
  backward, every rank's gradient of the whole summed over the group, then
  the rank's slice (``enter_group`` after ``gather_group``)."""
  return enter_group(gather_group(x, group), group)


def split_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
  """The rank's slice of ``dim`` (the last by default) forward; the
  slices' gradients gathered backward."""
  return x if _alone(group) else _Split.apply(x, group, dim)


def scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
  """The rank's slice along ``dim`` of the sum over ``group`` forward
  (``ProcessMesh.reduce_scatter``: the bits of ``leave_group`` then the
  slice); the slices' gradients gathered backward."""
  return x if _alone(group) else _Scatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
  """Chunk j of dim 0 to rank j, the chunks received in rank order
  forward (``ProcessMesh.all_to_all``); the same exchange of the gradient
  backward."""
  return x if _alone(group) else _Swap.apply(x, group)


def leave(x: torch.Tensor, group, seq=None) -> torch.Tensor:
  """A sub-block's output onto the residual stream: partial products
  (``group`` the model group) summed over it, or a whole value (``group``
  None) as it is; under sequence sharding (``seq`` the model group) the
  sum reduce-scattered along the sequence (dim 1) and a whole value
  sliced to the rank's part of it."""
  if seq is None:
    return leave_group(x, group)
  return split_group(x, seq, 1) if _alone(group) else scatter_sum(x, group, 1)
