"""Model: init / train forward and loss / prefill / decode for the dense
decoder (the port of ``src/repro/models/registry.py``).

``Model`` wires the embedding -> one block module per layer -> final norm ->
LM head.  It is an ``nn.Module`` whose parameters are drawn on ``device``
from a ``torch.Generator`` with the reference's distributions (its own
draws; ``interop.lm_params`` carries the reference's across).

Training: ``loss_fn`` is the reference's sequence-chunked cross-entropy
(the (B, S, V) logits never exist at once), and under autograd every layer
runs inside ``torch.utils.checkpoint`` by the ``remat`` policy ("dots"
keeps the matmul outputs, "full" keeps nothing).  Attention under autograd
takes ``chunked_attention`` (``attention.self_attention``'s rule); a
forward under ``torch.no_grad()`` launches the flash kernel.  The
reference's GSPMD layer (``Parallelism``, ``param_specs``, ``cache_specs``,
``_act``) waits for the ``torch.distributed`` backend (ROADMAP.md).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       token_nll)
from repro_torch.models.transformer import (apply_block, init_block,
                                            init_block_cache)


def check_supported(cfg: ModelConfig) -> None:
  """Raise for what the port's decoder does not run yet."""
  if cfg.family != "dense" or tuple(cfg.pattern) != ("attn",):
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} with pattern {cfg.pattern} is "
        "not ported yet (only dense ('attn',) stacks); ROADMAP.md lists the "
        "other families")
  if cfg.sliding_window:
    raise NotImplementedError(
        f"{cfg.name}: sliding-window attention is not ported yet; "
        "ROADMAP.md lists it")


# the matmuls the "dots" policy keeps (the reference's
# dots_with_no_batch_dims_saveable, here with the batched attention products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
  return (CheckpointPolicy.MUST_SAVE if op in _DOTS
          else CheckpointPolicy.PREFER_RECOMPUTE)


REMATS = (None, "dots", "full")


class Model(nn.Module):
  def __init__(self, cfg: ModelConfig, *, device="cuda",
               generator: torch.Generator | None = None,
               backend: str = "auto", remat: str | None = "dots"):
    """``device`` defaults to the card and raises without one unless
    "cpu" is asked for; ``generator`` (on ``device``; seed 0 when None)
    draws the weights; ``backend`` ("auto" | "cuda" | "ref") picks the
    attention kernel or its plain version, as for every kernel; ``remat``
    (None | "dots" | "full") is the activation checkpointing of a layer
    under autograd ("dots" keeps the matmul outputs, "full" recomputes
    everything in the backward pass)."""
    super().__init__()
    check_supported(cfg)
    if remat not in REMATS:
      raise ValueError(f"remat {remat!r} not in {REMATS}")
    dev = resolve_device(device)
    self.cfg = cfg
    self.backend = backend
    self.remat = remat
    self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if generator is None:
      generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=generator, device=dev)
    dt = self.dtype
    self.embed = nn.Parameter(embed_init((cfg.vocab, cfg.d_model), dt, **kw))
    self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), device=dev))
    if not cfg.tie_embeddings:
      self.head = nn.Parameter(dense_init((cfg.d_model, cfg.vocab), dt, **kw))
    self.layers = nn.ModuleList(init_block(bt, cfg, dt, **kw)
                                for bt in cfg.full_pattern)

  @property
  def device(self) -> torch.device:
    return self.embed.device

  def _logits(self, h: torch.Tensor) -> torch.Tensor:
    cfg = self.cfg
    h = rms_norm(h, self.ln_f, cfg.rmsnorm_eps)
    head = self.embed.T if cfg.tie_embeddings else self.head
    return h @ head

  def _train_block(self, btype: str, h: torch.Tensor, layer) -> torch.Tensor:
    return apply_block(btype, h, layer, self.cfg, mode="train",
                       backend=self.backend)[0]

  def _stack(self, h, *, mode, caches=None, pos=None):
    remat = (mode == "train" and self.remat is not None
             and torch.is_grad_enabled())
    for i, (bt, layer) in enumerate(zip(self.cfg.full_pattern, self.layers)):
      if remat:  # "full": checkpoint's default keeps only the inputs
        h = checkpoint(self._train_block, bt, h, layer, use_reentrant=False,
                       **({"context_fn": functools.partial(
                           create_selective_checkpoint_contexts, _keep_dots)}
                          if self.remat == "dots" else {}))
      else:
        h, _ = apply_block(bt, h, layer, self.cfg, mode=mode,
                           cache=None if caches is None else caches[i],
                           pos=pos, backend=self.backend)
    return h

  def _xent_chunk(self, h, labels, mask) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk: the final norm, the head
    and the logsumexp, the (B, chunk, V) logits in float32."""
    return (token_nll(self._logits(h), labels) * mask).sum()

  def _chunked_xent(self, h, labels, mask, chunk: int) -> torch.Tensor:
    """Sequence-chunked cross-entropy: each (B, chunk, V) slice of the
    logits is projected and reduced (and, under autograd, recomputed in
    the backward pass), so the (B, S, V) logits never exist at once.
    ``chunk = s`` when it does not divide s (the reference's rule)."""
    b, s, _ = h.shape
    if mask is None:
      mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    chunk = min(chunk, s)
    if s % chunk:
      chunk = s
    grad = torch.is_grad_enabled()
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
      part = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
              mask[:, c0:c0 + chunk])
      nll_sum = nll_sum + (
          checkpoint(self._xent_chunk, *part, use_reentrant=False) if grad
          else self._xent_chunk(*part))
    return nll_sum / mask.sum().clamp_min(1.0)

  # --------------------------------------------------------------- public
  def apply_train(self, batch: dict) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), teacher forcing.  Under autograd
    the layers follow ``remat`` and attention runs ``chunked_attention``;
    under ``torch.no_grad()`` attention launches the kernel."""
    h = self.embed[batch["tokens"]]
    return self._logits(self._stack(h, mode="train"))

  def loss_fn(self, batch: dict, *, loss_chunk: int = 512):
    """batch: tokens, labels (B, S) [+ mask (B, S) float32] -> (loss,
    {"xent", "aux"}): the mean masked token cross-entropy through
    ``_chunked_xent``, plus the auxiliary loss (0 for the dense family)."""
    h = self.embed[batch["tokens"]]
    h = self._stack(h, mode="train")
    xent = self._chunked_xent(h, batch["labels"], batch.get("mask"),
                              loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return xent + aux, {"xent": xent, "aux": aux}

  def init_cache(self, batch_size: int, max_len: int) -> list[dict]:
    """One cache dict per layer (k, v, kpos), on the model's device."""
    return [init_block_cache(bt, self.cfg, batch_size, max_len, self.dtype,
                             self.device) for bt in self.cfg.full_pattern]

  @torch.no_grad()
  def prefill(self, batch: dict, caches: list[dict]):
    """Fill ``caches`` (in place) from the prompt ``batch["tokens"]``
    (B, S); returns (last-token logits (B, V), caches)."""
    h = self.embed[batch["tokens"]]
    h = self._stack(h, mode="prefill", caches=caches)
    return self._logits(h[:, -1:])[:, 0], caches

  @torch.no_grad()
  def decode_step(self, token: torch.Tensor, pos: int, caches: list[dict]):
    """token (B, 1) at position ``pos`` (a Python int) against the caches,
    written in place; returns (logits (B, V), caches)."""
    h = self.embed[token]
    h = self._stack(h, mode="decode", caches=caches, pos=int(pos))
    return self._logits(h)[:, 0], caches


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None,
                backend: str = "auto", remat: str | None = "dots") -> Model:
  return Model(cfg, device=device, generator=generator, backend=backend,
               remat=remat)
