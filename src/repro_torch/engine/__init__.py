"""The session API: `Mapper` + `ExecutionConfig`, the continuous-batching
front door (`FrontDoor`, `ServeStats`), the on-disk index store
(`Mapper.save` / `load` / `swap_index`) and the fleet stream
(`engine.multihost.map_stream`: per-host generators, one global batch a
round, the lockstep keep-alive)."""
from repro_torch.core.long_read import LongReadConfig, LongReadResult
from repro_torch.core.pipeline import MapResult
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.frontdoor import FrontDoor, FrontDoorConfig, Request
from repro_torch.engine.index_store import (
    IndexStoreError,
    StorePayload,
    load_store,
    save_store,
)
from repro_torch.engine.mapper import Mapper
from repro_torch.engine.stats import ServeStats
from repro_torch.engine.stream import StreamResult

__all__ = ["ExecutionConfig", "FrontDoor", "FrontDoorConfig",
           "IndexStoreError", "LongReadConfig", "LongReadResult",
           "MapResult", "Mapper", "Request", "ServeStats", "StorePayload",
           "StreamResult", "load_store", "save_store"]
