"""Model configuration (the port's own copy of ``src/repro/models/config.py``):
one dataclass covers all 10 assigned architectures.

The layer stack is described by a *periodic pattern* of block types.  The
reference lowers it as a scan over periods with stacked parameters; the
port's ``Model`` holds one module per layer, and ``n_periods`` /
``n_remainder`` tell ``interop.lm_params`` how the reference's stacked
leaves map onto those layers.

Block types:
  "attn"   -- self-attention (+ optional sliding window) + MLP/MoE
  "cross"  -- self-attention + cross-attention (encoder/image memory) + MLP
  "rec"    -- RG-LRU recurrent block + MLP (RecurrentGemma / Griffin)
  "mamba"  -- Mamba-2 SSD block (no separate MLP; d_ff == 0)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
  num_experts: int = 0
  top_k: int = 0
  num_shared: int = 0
  d_expert: int = 0          # per-expert FFN width
  capacity_factor: float = 1.25
  router_aux_weight: float = 0.01
  group_size: int = 1024   # dispatch group Sg; dispatch-einsum FLOPs scale
                           # with Sg*top_k*cf per token (perf lever)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
  d_state: int = 128
  head_dim: int = 64
  expand: int = 2
  conv_width: int = 4
  chunk: int = 256
  n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RecConfig:
  lru_width: int = 0         # 0 -> d_model
  conv_width: int = 4
  c: float = 8.0             # RG-LRU decay sharpness


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
  n_layers: int = 0
  n_frames: int = 1500       # stubbed modality frontend sequence length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  name: str
  family: str                # dense | moe | ssm | hybrid | vlm | encdec
  n_layers: int
  d_model: int
  n_heads: int
  n_kv_heads: int
  d_ff: int
  vocab: int
  head_dim: int = 128
  pattern: tuple = ("attn",)          # periodic block pattern
  qk_norm: bool = False
  qkv_bias: bool = False
  rope_theta: float = 1e6
  rmsnorm_eps: float = 1e-6
  sliding_window: int = 0             # 0 = full attention ("attn" blocks)
  tie_embeddings: bool = False
  moe: MoEConfig = MoEConfig()
  ssm: SSMConfig = SSMConfig()
  rec: RecConfig = RecConfig()
  encoder: EncoderConfig = EncoderConfig()
  n_img_tokens: int = 0               # vlm cross-attn memory length (stub)
  dtype: str = "bfloat16"
  # sub-quadratic? governs long_500k applicability
  subquadratic: bool = False

  @property
  def full_pattern(self) -> tuple:
    """pattern repeated/cut to exactly n_layers entries."""
    p = []
    while len(p) < self.n_layers:
      p.extend(self.pattern)
    return tuple(p[: self.n_layers])

  @property
  def n_periods(self) -> int:
    return self.n_layers // len(self.pattern)

  @property
  def n_remainder(self) -> int:
    return self.n_layers % len(self.pattern)

  def param_count(self) -> int:
    """Approximate parameter count (embedding + blocks + head)."""
    d, f, v = self.d_model, self.d_ff, self.vocab
    hq = self.n_heads * self.head_dim
    hkv = self.n_kv_heads * self.head_dim
    per: dict[str, int] = {}
    per["attn"] = d * hq + 2 * d * hkv + hq * d + 3 * d * f
    per["cross"] = per["attn"] + d * hq + 2 * d * hkv + hq * d
    lru = self.rec.lru_width or d
    per["rec"] = 2 * d * lru + lru * d + 4 * lru + 3 * d * f
    di = self.ssm.expand * d
    per["mamba"] = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                        + di // self.ssm.head_dim) + di * d
    if self.moe.num_experts:
      e = self.moe
      per["attn"] = (d * hq + 2 * d * hkv + hq * d
                     + 3 * d * e.d_expert * (e.num_experts + e.num_shared)
                     + d * e.num_experts)
    total = sum(per[b] for b in self.full_pattern)
    total += v * d * (1 if self.tie_embeddings else 2)
    if self.encoder.n_layers:
      total += self.encoder.n_layers * (4 * d * d + 3 * d * f)
    return total

  def active_param_count(self) -> int:
    """Active params per token (MoE: shared + top_k experts only)."""
    if not self.moe.num_experts:
      return self.param_count()
    d = self.d_model
    e = self.moe
    hq = self.n_heads * self.head_dim
    hkv = self.n_kv_heads * self.head_dim
    per = (d * hq + 2 * d * hkv + hq * d
           + 3 * d * e.d_expert * (e.top_k + e.num_shared) + d * e.num_experts)
    total = per * self.n_layers + self.vocab * d * 2
    return total
