"""qwen2-vl-7b [vlm]: M-RoPE, backbone only (the vision frontend is a
stub: the batch carries precomputed patch embeddings). 28L d=3584 28H
(kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    m_rope=True,
    vision_tokens=1024,
)
