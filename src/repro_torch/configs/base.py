"""ModelConfig: one dataclass describing every architecture of the LM
substrate, with the same fields as the JAX package's, so that
``ModelConfig(**dataclasses.asdict(jax_cfg))`` converts one to one.

Families: dense | moe | ssm | hybrid | vlm | audio.  The vlm and audio
entries are transformer backbones; their modality frontends are stubs
whose precomputed patch embeddings or codebook tokens arrive in the
batch.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attn-free SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # Hybrid (Zamba2): one shared attention block every `attn_every` layers
    attn_every: int = 0

    # Multimodal backbone stubs
    m_rope: bool = False
    vision_tokens: int = 0
    n_codebooks: int = 0

    # numerics / execution
    dtype: str = "bfloat16"     # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True          # layer bodies under torch.utils.checkpoint
    attn_impl: str = "blockwise"   # dense | blockwise | triangle | pallas
    unroll_scans: bool = False     # no effect here (layers are a loop)
    attn_block_q: int = 512
    attn_block_k: int = 512
    use_flash_kernel: bool = False  # prefill through the flash kernel

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """long_500k eligibility: SSM and hybrid archs."""
        return self.family in ("ssm", "hybrid")

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def n_params(self) -> int:
        """Approximate parameter count (reporting/roofline only)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.hd
        emb = V * d * (self.n_codebooks or 1)
        if self.family == "ssm":
            per = (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads) * d \
                + self.d_inner * d + self.d_inner * (self.ssm_conv + 2)
            return L * per + emb
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "moe":
            ff = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ff = 3 * d * f
        if self.family == "hybrid":
            ssm_per = (2 * self.d_inner + 2 * self.ssm_state
                       + self.ssm_heads) * d + self.d_inner * d
            return L * ssm_per + (attn + 3 * d * f) + emb
        return L * (attn + ff) + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        ff = self.moe_top_k * 3 * d * f + d * self.n_experts
        return L * (attn + ff) + self.vocab_size * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}
