"""The host loop behind ``Mapper.map_stream``.

Each batch is padded to the stream shape on the host, copied to the
device from pinned memory without blocking, and mapped with eager kernel
launches on the current stream; the host goes on to pull and pad the next
batch while the device works.  Consumers see results one batch late
(``on_result`` for batch k fires after batch k+1 was dispatched).  The
stage totals stay on the device; the host syncs once, at the end.  The
loop's spans, markers and counters go to the stream's
`engine.spans.StreamTrace`.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.engine.stats import stage_fractions
from repro_torch.tree import tree_map

_END = object()


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
    #: the stream's spans, device markers and counters
    #: (`engine.spans.StreamTrace.summary`); None on a fleet stream over
    #: several hosts
    trace: dict | None = None

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


def pin(arr, device: torch.device) -> tuple[torch.Tensor, int]:
    """Host array -> (the host tensor a copy to ``device`` reads, the
    bytes staged for it).  On CUDA the tensor lies in pinned memory: a
    pinned array is taken as it is, a pageable one is first copied there
    (its bytes are the staged ones).  Elsewhere it is the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t, 0
    p = t.pin_memory()
    return p, (0 if p.data_ptr() == t.data_ptr() else p.nbytes)


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; via pinned memory and a non-blocking
    copy on CUDA (the pinned block is not reused until the copy ran)."""
    return pin(arr, device)[0].to(device, non_blocking=True)


def run_stream(dispatch, batches, trace, device: torch.device, *,
               stream_batch=None, on_result=None, drain=None,
               n_arrays: int = 2):
    """Drive ``dispatch(*reads, n, aux) -> result`` over host batches of
    ``n_arrays`` read arrays each, the reads already copied to ``device``.

    The first batch fixes the stream shape unless ``stream_batch`` pins
    it.  ``drain()`` waits for the device once, after the last dispatch,
    and returns what the caller fetches then.  ``trace`` (an active
    `engine.spans.StreamTrace`) gets the loop's spans, the markers around
    each batch's copies (M0, M1; ``dispatch`` records M2) and the
    counters.  Returns ``(n_items, n_batches, seconds, drained)``.
    """
    spans = trace.spans
    prev = None
    t0 = None
    it = iter(batches)
    for idx in itertools.count():
        trace.batch = idx
        with spans["stream.pull"]:
            item = next(it, _END)
        if item is _END:
            break
        if t0 is None:   # host-side generation of batch 0 is set-up
            t0 = time.time()
        with spans["stream.stage"]:
            reads, aux = split_batch(item, n_arrays)
            n = int(np.shape(reads[0])[0])
            if stream_batch is None:
                stream_batch = n
            host = []
            for r in reads:
                h, staged = pin(pad_tail(r, stream_batch), device)
                host.append(h)
                trace.staged_bytes += staged
                trace.h2d_bytes += h.nbytes
            aux = tree_map(lambda a: pad_tail(a, stream_batch), aux)
        trace.copy_start()
        with spans["stream.h2d"]:
            on_dev = [h.to(device, non_blocking=True) for h in host]
        trace.copy_end()
        res = dispatch(*on_dev, n, aux)
        trace.items += n
        trace.batches += 1
        if prev is not None and on_result is not None:
            trace.batch = prev[0]
            with spans["stream.on_result"]:
                on_result(*prev)
        prev = (idx, res, n)
    if prev is not None and on_result is not None:
        trace.batch = prev[0]
        with spans["stream.on_result"]:
            on_result(*prev)
    with spans["stream.drain"]:
        drained = None if drain is None else drain()
        trace.anchor()
    seconds = 0.0 if t0 is None else time.time() - t0
    return trace.items, trace.batches, seconds, drained
