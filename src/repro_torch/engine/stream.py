"""The host loop behind ``Mapper.map_stream``.

Each batch is padded to the stream shape on the host, copied to the
device from pinned memory without blocking, and mapped with eager kernel
launches on the current stream; the host goes on to pull and pad the next
batch while the device works.  Consumers see results one batch late
(``on_result`` for batch k fires after batch k+1 was dispatched).  The
stage totals stay on the device; the host syncs once, at the end.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.engine.stats import stage_fractions
from repro_torch.tree import tree_map


@dataclasses.dataclass
class StreamResult:
    """Aggregate outcome of one `map_stream` run.

    ``totals`` are the device-accumulated stage counts (python ints,
    fetched once); ``reduced`` the final state of the caller's
    ``reduce_fn``, or None.  ``seconds`` covers the first dispatch through
    the drain of the last batch.  ``n_pairs`` counts the stream's valid
    items (read pairs on `map_stream`, long reads on `map_long_stream`)
    and ``reads_per_item`` the reads each item carries (2 mates, 1 long
    read), the bases-per-item factor of :meth:`mbp_per_s`.
    """

    n_pairs: int
    n_batches: int
    seconds: float
    totals: dict
    reduced: object = None
    reads_per_item: int = 2
    #: the fleet health ledger of a fault-tolerant stream
    #: (`engine.multihost.map_stream`): per-host batch and keep-alive
    #: counts, watchdog states, the control-word log and the drain
    #: reason.  None on a plain single-host stream.
    health: dict | None = None

    @property
    def pairs_per_s(self) -> float:
        return self.n_pairs / max(self.seconds, 1e-9)

    def mbp_per_s(self, read_len: int) -> float:
        bases = self.n_pairs * self.reads_per_item * read_len
        return bases / max(self.seconds, 1e-9) / 1e6

    @property
    def fractions(self) -> dict:
        return stage_fractions(self.totals)


def pad_tail(arr, batch: int):
    """Zero-pad axis 0 of a ragged tail array up to the fixed stream shape
    (0-d aux leaves pass through)."""
    arr = np.asarray(arr)
    if arr.ndim == 0 or arr.shape[0] == batch:
        return arr
    if arr.shape[0] > batch:
        raise ValueError(
            f"stream batch of {arr.shape[0]} rows exceeds the session's "
            f"fixed stream_batch={batch}")
    pad = np.zeros((batch - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def split_batch(item, n_arrays: int = 2):
    """(arr_0, ..., arr_{n-1}[, aux]) -> ((arr_0, ...), aux).

    ``n_arrays`` is the lane's read arrays per item: 2 mates on
    `map_stream`, 1 read batch on `map_long_stream`.
    """
    if len(item) == n_arrays:
        return tuple(item), ()
    if len(item) != n_arrays + 1:
        raise ValueError(
            f"stream batch items must have {n_arrays} read arrays plus an "
            f"optional aux tree; got a length-{len(item)} tuple")
    return tuple(item[:n_arrays]), item[n_arrays]


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; via pinned memory and a non-blocking
    copy on CUDA (the pinned block is not reused until the copy ran)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def run_stream(dispatch, batches, *, stream_batch=None, on_result=None,
               sync=None, n_arrays: int = 2):
    """Drive ``dispatch(*reads, n, aux) -> result`` over host batches of
    ``n_arrays`` read arrays each.

    The first batch fixes the stream shape unless ``stream_batch`` pins
    it.  ``sync()`` waits for the device once, after the last dispatch.
    Returns ``(n_items, n_batches, seconds, last_result)``.
    """
    n_items = n_batches = 0
    prev = res = None
    t0 = None
    for idx, item in enumerate(batches):
        reads, aux = split_batch(item, n_arrays)
        n = int(np.shape(reads[0])[0])
        if stream_batch is None:
            stream_batch = n
        padded = tuple(pad_tail(r, stream_batch) for r in reads)
        aux = tree_map(lambda a: pad_tail(a, stream_batch), aux)
        if t0 is None:   # host-side generation of batch 0 is set-up
            t0 = time.time()
        res = dispatch(*padded, n, aux)
        n_items += n
        n_batches += 1
        if prev is not None and on_result is not None:
            on_result(*prev)
        prev = (idx, res, n)
    if prev is not None and on_result is not None:
        on_result(*prev)
    if res is not None and sync is not None:
        sync()
    seconds = 0.0 if t0 is None else time.time() - t0
    return n_items, n_batches, seconds, res
