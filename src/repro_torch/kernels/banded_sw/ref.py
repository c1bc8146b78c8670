"""Plain PyTorch version of the banded_sw kernel (delegates to core)."""
from repro_torch.core.dp_fallback import (  # noqa: F401
    gotoh_semiglobal_banded as gotoh_banded_ref,
)
