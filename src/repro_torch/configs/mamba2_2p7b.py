"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free. 64L
d=2560 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)
