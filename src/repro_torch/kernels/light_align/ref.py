"""Plain PyTorch version of the light_align kernel (delegates to core)."""
from repro_torch.core.light_align import (  # noqa: F401
    light_align as light_align_ref,
)
