"""llama4-scout-17b-a16e [moe]: 16 experts top-1. 48L d=5120 40H (kv=8)
d_ff(expert)=8192 vocab=202048 [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=16,
    moe_top_k=1,
)
