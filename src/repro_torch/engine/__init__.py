"""The session API: `Mapper` + `ExecutionConfig`."""
from repro_torch.core.long_read import LongReadConfig, LongReadResult
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.mapper import Mapper
from repro_torch.engine.stream import StreamResult

__all__ = ["ExecutionConfig", "LongReadConfig", "LongReadResult", "Mapper",
           "StreamResult"]
