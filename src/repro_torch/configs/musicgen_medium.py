"""musicgen-medium [audio]: decoder-only over EnCodec tokens, backbone
only (the batch carries the 4 codebook token streams). 48L d=1536 24H
(kv=24, MHA) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    n_codebooks=4,
    tie_embeddings=False,
)
