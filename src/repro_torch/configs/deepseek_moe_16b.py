"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA kv=16) vocab=102400;
fine-grained MoE: 2 shared + 64 routed experts top-6, expert width 1408.
[arXiv:2401.06066; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400, head_dim=128,
    pattern=("attn",), rope_theta=1e4,
    # group_size 256 (vs default 1024): dispatch-einsum FLOPs scale with
    # Sg*top_k*cf per token, so fine-grained 64-expert top-6 routing pays 2x
    # less dispatch overhead at Sg=512 (256 regressed multi-pod dispatch sharding) (see EXPERIMENTS.md Sec Perf)
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408,
                  group_size=512),
)
