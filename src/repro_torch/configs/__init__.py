"""Architecture configs of the port (``get_config("<id>")``) and reduced
smoke variants: the port's own copy of ``src/repro/configs``, all ten of
its architectures (dense, MoE, SSM, hybrid, VLM, enc-dec).

``reduced(cfg)`` shrinks a config to a CPU-runnable smoke size of the same
family, exactly as the reference's ``reduced`` does.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.deepseek_67b import CONFIG as deepseek_67b
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b
from repro_torch.configs.grok1_314b import CONFIG as grok1_314b
from repro_torch.configs.llama3_2_vision_90b import \
    CONFIG as llama3_2_vision_90b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.qwen1_5_4b import CONFIG as qwen1_5_4b
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "qwen3-4b": qwen3_4b,
    "qwen3-8b": qwen3_8b,
    "deepseek-67b": deepseek_67b,
    "qwen1.5-4b": qwen1_5_4b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "llama-3.2-vision-90b": llama3_2_vision_90b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "grok-1-314b": grok1_314b,
    "mamba2-2.7b": mamba2_2_7b,
    "whisper-tiny": whisper_tiny,
}


def get_config(name: str) -> ModelConfig:
  if name not in ARCHS:
    raise KeyError(f"{name!r}: no such architecture; the port has "
                   f"{sorted(ARCHS)}")
  return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
  """Same family / pattern / features, smoke-test size."""
  n_layers = max(len(cfg.pattern) + min(cfg.n_remainder, 1), 2)
  changes = dict(
      n_layers=n_layers,
      d_model=128,
      n_heads=4,
      n_kv_heads=max(1, min(cfg.n_kv_heads, 2)
                     if cfg.n_kv_heads < cfg.n_heads else 4),
      head_dim=32,
      d_ff=256 if cfg.d_ff else 0,
      vocab=512,
      sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
      n_img_tokens=16 if cfg.n_img_tokens else 0,
      dtype="float32",
  )
  if cfg.moe.num_experts:
    # capacity_factor E/k makes routing drop-free at smoke size, so the
    # decode-vs-teacher-forcing consistency tests are exact
    changes["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                         num_shared=min(cfg.moe.num_shared, 1),
                                         d_expert=64, capacity_factor=2.0)
    changes["d_ff"] = 64
  if cfg.family == "ssm":
    changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                         chunk=16)
    changes["d_ff"] = 0
  if cfg.family == "hybrid":
    changes["rec"] = dataclasses.replace(cfg.rec, lru_width=128)
  if cfg.encoder.n_layers:
    changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2,
                                             n_frames=24)
  return dataclasses.replace(cfg, **changes)
