"""Backend resolution shared by every kernel family.

Each ``kernels/<family>/ops.py`` wrapper takes
``backend="auto"|"cuda"|"torch"``:

  - ``"auto"`` resolves to ``"cuda"`` for a session (or tensors) on a
    CUDA device and to ``"torch"`` on the CPU;
  - ``"cuda"`` launches the hand-written kernel, and raises for CPU
    tensors: there is no fallback from a kernel to its plain version;
  - ``"torch"`` runs the plain PyTorch version wherever the tensors are
    (on a card only when asked for explicitly, as a reference).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: str, device, family: str | None = None) -> str:
    """Resolve ``backend`` for work on ``device`` to one of `BACKENDS`.  In
    a dry run on the CPU that counts the card's work
    (`_cuda.routes_kernels`), "auto" and "cuda" take the kernel route on
    any device: its launches record their work and launch nothing."""
    device = torch.device(device)
    if _cuda.routes_kernels() and backend in ("auto", "cuda"):
        return "cuda"
    if backend == "auto":
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        where = f" for kernel family {family!r}" if family else ""
        raise ValueError(f"unknown backend {backend!r}{where}; expected "
                         f"'auto' or one of {BACKENDS}")
    if backend == "cuda" and device.type != "cuda":
        where = f" ({family})" if family else ""
        raise ValueError(f"backend 'cuda'{where} needs tensors on a CUDA "
                         f"device, got {device}")
    return backend
