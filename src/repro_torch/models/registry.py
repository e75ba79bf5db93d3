"""Model: init / train forward / prefill / decode for the dense decoder (the
port of ``src/repro/models/registry.py``).

``Model`` wires the embedding -> one block module per layer -> final norm ->
LM head.  It is an ``nn.Module`` whose parameters are drawn on ``device``
from a ``torch.Generator`` with the reference's distributions (its own
draws; ``interop.lm_params`` carries the reference's across).  The
reference's GSPMD layer (``Parallelism``, ``param_specs``, ``cache_specs``,
``_act``) and its training loss (``loss_fn``, ``_chunked_xent``) come with
the training path (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_init, rms_norm
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


class Model(nn.Module):
  def __init__(self, cfg: ModelConfig, *, device="cuda",
               generator: torch.Generator | None = None,
               backend: str = "auto"):
    """``device`` defaults to the card and raises without one unless
    "cpu" is asked for; ``generator`` (on ``device``; seed 0 when None)
    draws the weights; ``backend`` ("auto" | "cuda" | "ref") picks the
    attention kernel or its plain version, as for every kernel."""
    super().__init__()
    check_supported(cfg)
    dev = resolve_device(device)
    self.cfg = cfg
    self.backend = backend
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

  def _stack(self, h, *, mode, caches=None, pos=None):
    for i, (bt, layer) in enumerate(zip(self.cfg.full_pattern, self.layers)):
      h, _ = apply_block(bt, h, layer, self.cfg, mode=mode,
                         cache=None if caches is None else caches[i],
                         pos=pos, backend=self.backend)
    return h

  # --------------------------------------------------------------- public
  @torch.no_grad()
  def apply_train(self, batch: dict) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), teacher forcing.  Forward only:
    the loss and its backward come with the training path."""
    h = self.embed[batch["tokens"]]
    return self._logits(self._stack(h, mode="train"))

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
                backend: str = "auto") -> Model:
  return Model(cfg, device=device, generator=generator, backend=backend)
