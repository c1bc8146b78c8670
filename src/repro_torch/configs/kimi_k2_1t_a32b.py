"""kimi-k2-1t-a32b [moe]: trillion-param MoE. 61L d=7168 64H (kv=8)
d_ff(expert)=2048 vocab=163840, 384 experts top-8 [arXiv:2501.kimi2;
unverified]; bf16 parameters."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    n_experts=384,
    moe_top_k=8,
    param_dtype="bfloat16",
)
