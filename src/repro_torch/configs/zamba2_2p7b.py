"""zamba2-2.7b [hybrid]: 54 Mamba2 layers + one shared attention block.
54L d=2560 32H (kv=32, MHA) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  The shared transformer block runs after every 6
SSM layers, reusing one set of weights."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)
