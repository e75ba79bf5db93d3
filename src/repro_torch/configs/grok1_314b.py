"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) vocab=131072; 8 experts
top-2, expert width 32768.  [hf:xai-org/grok-1; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, head_dim=128, pattern=("attn",),
    rope_theta=1e4,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=0, d_expert=32768),
)
