"""Serving: the prefill and decode steps and a batched generation loop (the
port of ``src/repro/serve/serve_step.py``).

PyTorch runs eagerly, so nothing is compiled per call: the reference's jit
cache (``_SERVE_FN_CACHE``) has no counterpart, and ``make_serve_fns``
returns the model's own steps.  Every prefill launches the flash-attention
kernel once per causal, unwindowed attention layer (``backend`` "auto" on
the card): every layer of a dense or MoE stack, each self-attention of the
VLM's and the enc-dec decoder's layers; none in Mamba-2 or RecurrentGemma
(windowed attention, ``models.attention.local_attention``).  A model
built over a training mesh (``Model(mesh=)``) serves at its rank's heads
and widths, with caches of its rank's KV heads, SSM heads and recurrent
channels (``Model.init_cache``): every rank of the model group calls
``generate`` on the same request and gets the same tokens, the logits
whole on every rank (the vocabulary gathered where it is split).

Over data axes (the model's ``dp``, every data axis of its mesh) serving
follows the reference's ``cache_specs``: a batch of more than one row
splits by rows, each data rank serving its rows with its own cache (the
tokens gathered in rank order at the end); a batch of one row splits
every attention cache by length (``transformer.KVSplit``: a rank keeps
its slots, the windowed ring's too, and each decode step combines the
ranks' partial softmax statistics), every rank computing the same
tokens.
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model
from repro_torch.models.transformer import KVSplit


def make_serve_fns(model: Model):
  """Returns (prefill_fn, decode_fn): ``prefill_fn(batch, caches,
  memory=None)`` and ``decode_fn(token, pos, caches)``, each returning
  (logits, caches)."""

  def prefill_fn(batch, caches, memory=None):
    return model.prefill(batch, caches, memory)

  def decode_fn(token, pos, caches):
    return model.decode_step(token, pos, caches)

  return prefill_fn, decode_fn


@torch.no_grad()
def generate(model: Model, batch: dict, *, steps: int,
             max_len: int | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
  """Greedy / temperature sampling: prompt ``batch["tokens"]`` (B, S)
  [+ ``frames`` / ``img_embeds``] -> (B, steps) generated ids (int64), on
  the model's device.  The memory (the encoder's output, or the image
  embeddings) is built once and sizes the cross blocks' caches, as in the
  reference.

  Greedy picks the argmax, ties to the lowest index as ``jnp.argmax`` does.
  Temperature sampling draws Gumbel noise from ``generator`` (on the
  model's device; seed 0 when None): it cannot reproduce ``jax.random``'s
  draws.  The reference also runs a decode step after the last token and
  drops its logits; the port skips it.
  """
  tokens = batch["tokens"]
  b, s = tokens.shape
  max_len = max_len or (s + steps)
  dp = model.dp
  if dp is not None and b > 1:   # each data rank its rows, its own cache
    if b % dp.world:
      raise ValueError(f"a batch of {b} rows does not split over "
                       f"{dp.world} data ranks")
    rows = b // dp.world
    mine = {k: v[dp.rank * rows:(dp.rank + 1) * rows] for k, v in
            batch.items()}
    return dp.all_gather(_generate(model, mine, None, steps, max_len,
                                   temperature, generator))
  return _generate(model, batch, None if dp is None else KVSplit(dp), steps,
                   max_len, temperature, generator)


def _generate(model: Model, batch: dict, kv_split, steps: int, max_len: int,
              temperature: float, generator) -> torch.Tensor:
  s = batch["tokens"].shape[1]
  memory = model.memory(batch)
  caches = model.init_cache(batch["tokens"].shape[0], max_len,
                            memory=memory, kv_split=kv_split)
  prefill_fn, decode_fn = make_serve_fns(model)
  logits, caches = prefill_fn(batch, caches, memory)
  if temperature > 0.0 and generator is None:
    generator = torch.Generator(device=model.device).manual_seed(0)
  out = []
  for t in range(steps):
    if temperature > 0.0:
      u = torch.rand(logits.shape, generator=generator, device=logits.device)
      gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
      tok = torch.argmax(logits.float() / temperature + gumbel, dim=-1)
    else:
      tok = torch.argmax(logits, dim=-1)
    out.append(tok)
    if t + 1 < steps:
      logits, caches = decode_fn(tok[:, None], s + t, caches)
  return torch.stack(out, dim=1)
