"""Public wrapper of the flash attention forward.

On CUDA tensors `flash_attention` launches the hand-written kernel
(``csrc/flash_attention.cu``); on CPU tensors (or with
``backend="torch"``) it runs the plain version `ref.attention_ref`.  As
repro's wrapper, it zero-pads S up to a multiple of `BLOCK` under causal
masking (padded keys lie above every real row's diagonal, padded rows are
cut off) and raises for an unaligned S without it, on both backends.
The kernel has head widths 64 and 128 in bf16, and 64, 80 and 128 in
float32: any head up to 128 wide is zero-padded to the next of them
(`kernel_head_dim`; in bf16 80 and 112 go to 128, in float32 112 does)
under the original scale, which adds exact zeros to every score and gives
zero output columns, cut off.  A head wider than 128 raises.

The kernel has no backward: under autograd (grad mode on and any of q,
k, v requiring grad) the kernel backend raises, as a gradient through
repro's Pallas kernel does, rather than return an output with no
``grad_fn``.  The plain version stays differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import F32, INT, PTR
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.flash_attention.ref import attention_ref

def flash_attention_cost(BH: int, G: int, S: int, D: int, causal: bool,
                         itemsize: int) -> _cuda.Work:
    """q, o and the (BH / G)-row k, v once each; 4 BH D flops a (query,
    key) pair of the two products, over the causal triangle S (S + 1) / 2
    or all S^2 pairs.  bf16 runs on the tensor cores, float32 (the FMA
    kernel) outside them."""
    n_kv = BH // G
    pairs = S * (S + 1) / 2 if causal else S * S
    return _cuda.Work(itemsize * S * D * (2 * BH + 2 * n_kv),
                      4 * BH * D * pairs,
                      "bfloat16" if itemsize == 2 else "float32")


FLASH_ATTENTION = _cuda.register(
    "flash_attention", "flash_attention_launch",
    (PTR, PTR, PTR, PTR, INT, INT, INT, INT, F32, INT, INT, PTR),
    flash_attention_cost)

BLOCK = 128                       # repro's default block_q = block_k
# the kernel's head widths in each dtype
HEAD_DIMS = {torch.float32: (64, 80, 128), torch.bfloat16: (64, 128)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_head_dim(D: int, dtype: torch.dtype) -> int:
    """The kernel width a head of ``D`` is zero-padded to in ``dtype``:
    the smallest of `HEAD_DIMS` that holds it."""
    if dtype not in DTYPES:
        raise TypeError(f"the flash_attention kernel takes "
                        f"{tuple(DTYPES)}, got {dtype}")
    for width in HEAD_DIMS[dtype]:
        if D <= width:
            return width
    raise ValueError(f"the flash_attention kernel takes head widths up to "
                     f"{HEAD_DIMS[dtype][-1]}, got {D}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: float | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """(BH, S, D) attention of q over k, v -> (BH, S, D) in q's dtype.

    k and v are (BH, S, D), or (BH / G, S, D) for grouped-query attention:
    query row bh reads K/V row bh // G.  Scores are float32, scaled by
    ``sm_scale`` (default D**-0.5); the causal mask is -1e30.
    """
    backend = resolve_backend(backend, q.device, family="flash_attention")
    BH, S, D = q.shape
    if k.shape != v.shape or k.shape[1:] != (S, D) or k.shape[0] == 0 \
            or BH % k.shape[0]:
        raise ValueError(f"k and v must be (BH / G, S, D) for q of shape "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    pad = (-S) % BLOCK
    if pad and not causal:
        raise ValueError(
            "flash_attention pads S only under causal masking; pad inputs "
            "to a block multiple for causal=False")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if backend == "torch":
        return attention_ref(q, k, v, causal, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash_attention kernel has no backward: under autograd "
            "use backend='torch' or the blockwise attention "
            "(ModelConfig.use_flash_kernel=False)")
    d_pad = kernel_head_dim(D, q.dtype) - D
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.check(t, name, q.dtype)
        if not _cuda.aligned(t, 16):
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if pad or d_pad:
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad, 0, pad))
                   for t in (q, k, v))
    out = torch.empty_like(q)
    G = BH // k.shape[0]
    FLASH_ATTENTION(q, k, v, out, BH, G, S + pad, D + d_pad, sm_scale,
                    int(causal), DTYPES[q.dtype], stream=q,
                    work=(BH, G, S + pad, D + d_pad, causal,
                          q.element_size()))
    return out[:, :S, :D] if pad or d_pad else out
