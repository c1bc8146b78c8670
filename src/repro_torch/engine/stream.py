"""The host loop behind ``Mapper.map_stream``.

Each batch is padded to the stream shape on the host, copied to the
device from pinned memory without blocking, and mapped on the current
stream (eager launches, or a replay of the step's CUDA graph,
`engine.graph`); the host goes on to pull and pad the next batch while
the device works.  On CUDA the copies run on a stream of
their own into a ring of two device slots (`CopyRing`), and batch k+1's
copies are enqueued before batch k's step, so they run on the copy
engine while that step runs on the SMs.  Consumers see results one batch
late (``on_result`` for batch k fires after batch k+1 was dispatched).
The stage totals stay on the device; the host syncs once, at the end.
The loop's spans, markers and counters go to the stream's
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


class CopyRing:
    """The device slots a stream copies its reads into, and the events
    that order the copies against the steps that read them.

    Batch k takes slot k % 2.  The copy stream waits on ``released[k %
    2]``, which the compute stream recorded once ``dispatch(k - 2)``
    returned (the step, its stage counts and any ``reduce_fn``: nothing
    the consumer is handed holds the reads), copies the reads into the
    slot and records ``copied[k % 2]``; the compute stream waits on that
    before the step (`take`).  The host never waits.  A slot is made, on
    the compute stream, at the first batch of its shape and dtype, or
    taken from ``owner`` where one is given (``owner.slot(s, host)``: the
    device tensors of slot ``s`` for host tensors like ``host``, which
    outlive the ring, so that every stream of a session copies into the
    same memory).  Either records ``released`` at once, after every step
    launched so far, which covers the slot memory a made slot may take
    over and any step of an earlier stream still reading a taken one.

    ``events`` makes, records and waits on events by handle
    (`kernels._cuda.TimingEvents`); ``compute`` and ``copy`` are the
    streams (objects with ``cuda_stream``), and ``use(stream)`` makes one
    the current stream, so that the copies run on it and a pinned staging
    block's use is recorded there (the caching host allocator reuses it
    only after its copy ran).  `close` makes ``outer``, the caller's
    current stream (``compute`` unless another device was current), the
    current one again.
    """

    SLOTS = 2

    def __init__(self, device: torch.device, events, compute, copy, use,
                 outer=None, owner=None):
        self.device, self.events, self.use = device, events, use
        self.owner = owner
        self.compute, self.copy = compute, copy
        self.outer = compute if outer is None else outer
        self.h_compute, self.h_copy = compute.cuda_stream, copy.cuda_stream
        self.copied, self.released = (
            [events.create(device.index) for _ in range(self.SLOTS)]
            for _ in range(2))
        self.slots: list = [None] * self.SLOTS
        self.copies = self.taken = 0

    @classmethod
    def on(cls, device: torch.device, owner=None):
        """A ring on ``device``'s current stream and a new copy stream, or
        None off CUDA."""
        if device.type != "cuda":
            return None
        from repro_torch.kernels import _cuda
        compute = torch.cuda.current_stream(device)
        return cls(compute.device, _cuda.TimingEvents(), compute,
                   torch.cuda.Stream(compute.device), torch.cuda.set_stream,
                   torch.cuda.current_stream(), owner)

    def put(self, host, trace) -> None:
        """Enqueue the next batch's copies from the host tensors ``host``
        into its slot, on the copy stream; ``trace`` gets the markers M0
        and M1 around them."""
        s = self.copies % self.SLOTS
        self.copies += 1
        ev = self.events
        slot = self.slots[s]
        if slot is None or any(d.shape != h.shape or d.dtype != h.dtype
                               for d, h in zip(slot, host)):
            slot = self.slots[s] = (
                [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                 for h in host]
                if self.owner is None else self.owner.slot(s, host))
            ev.record(self.released[s], self.h_compute)
        ev.wait(self.h_copy, self.released[s])
        self.use(self.copy)
        try:
            trace.copy_start()
            with trace.spans["stream.h2d"]:
                for d, h in zip(slot, host):
                    d.copy_(h, non_blocking=True)
            trace.copy_end()
            ev.record(self.copied[s], self.h_copy)
        finally:
            self.use(self.compute)

    def take(self, trace) -> list:
        """The oldest batch put and not yet taken: the compute stream's
        wait for its copies (``trace`` gets R and S around it), and its
        slot's tensors."""
        s = self.taken % self.SLOTS
        self.taken += 1
        trace.wait_start()
        self.events.wait(self.h_compute, self.copied[s])
        trace.wait_end()
        return self.slots[s]

    def release(self) -> None:
        """After the dispatch of the batch last taken: its slot may be
        copied into again once the compute stream got here."""
        self.events.record(self.released[(self.taken - 1) % self.SLOTS],
                           self.h_compute)

    def close(self) -> None:
        """Free the slots (those it made) and the events.  The compute
        stream first waits for the last copies, so the slots' memory
        returns to its pool, or to the next stream, only after them (a
        no-op after the stream's final sync)."""
        for ev in self.copied:
            self.events.wait(self.h_compute, ev)
        self.use(self.outer)
        self.slots = [None] * self.SLOTS
        for ev in self.copied + self.released:
            self.events.destroy(ev)


def run_stream(dispatch, batches, trace, device: torch.device, *,
               stream_batch=None, on_result=None, drain=None,
               n_arrays: int = 2, slots=None):
    """Drive ``dispatch(*reads, n, aux) -> result`` over host batches of
    ``n_arrays`` read arrays each, the reads already copied to ``device``
    (on CUDA into a `CopyRing` slot, taken from ``slots`` where given,
    which ``dispatch`` reads on the compute stream and must not hand on).

    The first batch fixes the stream shape unless ``stream_batch`` pins
    it.  On CUDA batch k + 1 is pulled and its copies enqueued before
    batch k is dispatched, so they run beside batch k's step even where
    the host, not the card, sets the pace.  ``drain()`` waits for the
    device once, after the last dispatch, and returns what the caller
    fetches then.  ``trace`` (an active `engine.spans.StreamTrace`) gets
    the loop's spans, the markers around each batch's copies and the
    compute stream's wait for them (M0, M1, R, S; ``dispatch`` records
    M2) and the counters.  Returns ``(n_items, n_batches, seconds,
    drained)``.
    """
    spans = trace.spans
    it = iter(batches)
    t0 = None

    def pull(idx):
        """Pull and stage batch ``idx``: ``(n, aux, host tensors)``, or
        None once the iterator is done."""
        nonlocal t0, stream_batch
        trace.batch = idx
        with spans["stream.pull"]:
            item = next(it, _END)
        if item is _END:
            return None
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
        return n, aux, host

    prev = None
    ring = CopyRing.on(device, slots)
    try:
        cur = pull(0)
        if ring is not None:
            trace.streams(ring.h_compute, ring.h_copy)
            if cur is not None:
                ring.put(cur[2], trace)
        for idx in itertools.count():
            if cur is None:
                break
            n, aux, host = cur
            if ring is None:
                with spans["stream.h2d"]:
                    on_dev = [h.to(device, non_blocking=True) for h in host]
            else:
                cur = pull(idx + 1)
                if cur is not None:
                    ring.put(cur[2], trace)
                trace.batch = idx
                on_dev = ring.take(trace)
            res = dispatch(*on_dev, n, aux)
            if ring is not None:
                ring.release()
            trace.items += n
            trace.batches += 1
            if prev is not None and on_result is not None:
                trace.batch = prev[0]
                with spans["stream.on_result"]:
                    on_result(*prev)
            prev = (idx, res, n)
            if ring is None:
                cur = pull(idx + 1)
        if prev is not None and on_result is not None:
            trace.batch = prev[0]
            with spans["stream.on_result"]:
                on_result(*prev)
        with spans["stream.drain"]:
            drained = None if drain is None else drain()
            trace.anchor()
    finally:
        if ring is not None:
            ring.close()
    seconds = 0.0 if t0 is None else time.time() - t0
    return trace.items, trace.batches, seconds, drained
