"""mamba2-2.7b [ssm]: 64L d=2560 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, head_dim=64, pattern=("mamba",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    subquadratic=True,
)
