"""Plain PyTorch version of the flash_attention kernel: softmax attention
in float32 with the finite mask value -1e30, as repro's `attention_ref`.

K and V may hold fewer rows than Q (grouped-query attention): query row
``bh`` reads K/V row ``bh // G`` with ``G = BH_q / BH_kv``; here K and V
are repeated G times first, as the JAX model's caller repeats them.
"""
import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_q_rows: int) -> torch.Tensor:
    """(BH_kv, S, D) -> (BH_q, S, D), row bh of the result = k[bh // G]."""
    if k.shape[0] == n_q_rows:
        return k
    if n_q_rows % k.shape[0]:
        raise ValueError(f"{n_q_rows} query rows cannot share "
                         f"{k.shape[0]} K/V rows")
    return k.repeat_interleave(n_q_rows // k.shape[0], dim=0)


def attention_ref(q, k, v, causal: bool = True,
                  sm_scale: float | None = None):
    """(BH, S, D) plain softmax attention in f32, output in q's dtype."""
    BH, S, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    k, v = repeat_kv(k, BH), repeat_kv(v, BH)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
