"""Public wrapper of the NMSL row gather (a building block).

On CUDA tensors `seed_gather` launches the `seed_gather` kernel; on CPU
tensors (or with ``backend="torch"``) it runs the plain version.  Both
map an id outside [0, T) as jnp's ``table[ids]`` does (`ref.normalise_ids`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import I64, INT, PTR
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.seed_gather.ref import seed_gather_ref

def seed_gather_cost(n: int, cap: int, itemsize: int = 4) -> _cuda.Work:
    """4 bytes of id, one cap-wide row read and one written an id."""
    return _cuda.Work(n * (4 + 2 * cap * itemsize), 0)


SEED_GATHER = _cuda.register(
    "seed_gather", "seed_gather_launch", (PTR, I64, INT, PTR, I64, INT, PTR,
                                          PTR), seed_gather_cost)

TABLE_DTYPES = (torch.int32, torch.float32)


def seed_gather(table: torch.Tensor, ids: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
    """Rows of a (T, cap) int32 or float32 table at int32 ``ids`` of any
    shape: ``ids.shape + (cap,)``, ``out[i] = table[ids[i]]``."""
    backend = resolve_backend(backend, table.device, family="seed_gather")
    if table.dim() != 2 or table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table must be a 2-D tensor of one of "
                        f"{TABLE_DTYPES}, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    T, cap = table.shape
    if T == 0 and ids.numel():
        raise ValueError("cannot gather from a table without rows")
    if backend == "torch":
        return seed_gather_ref(table, ids)
    flat = ids.reshape(-1)
    _cuda.check(table, "table", table.dtype)
    _cuda.check(flat, "ids", torch.int32)
    n = flat.shape[0]
    out = torch.empty((n, cap), dtype=table.dtype, device=table.device)
    vec = cap % 4 == 0 and _cuda.aligned(table, 16)
    SEED_GATHER(table, T, cap, flat, n, int(vec), out, stream=table,
                work=(n, cap, table.element_size()))
    return out.reshape(ids.shape + (cap,))
