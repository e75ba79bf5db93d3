"""whisper-tiny [audio]: enc-dec, 4+4L d=384 6H (MHA kv=6) d_ff=1536
vocab=51865; conv audio frontend is a STUB (input_specs provides frame
embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab=51865, head_dim=64,
    pattern=("cross",), encoder=EncoderConfig(n_layers=4, n_frames=1500),
    rope_theta=1e4,
)
