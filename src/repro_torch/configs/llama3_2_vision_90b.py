"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision family; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, head_dim=128,
    pattern=("attn", "attn", "attn", "attn", "cross"), n_img_tokens=1601,
    rope_theta=5e5,
)
