"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, pattern 2 recurrent : 1 attn,
window 2048.  [arXiv:2402.19427; hf]"""
from repro_torch.models.config import ModelConfig, RecConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    pattern=("rec", "rec", "attn"), sliding_window=2048,
    rec=RecConfig(lru_width=2560), rope_theta=1e4, subquadratic=True,
)
