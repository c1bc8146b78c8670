"""The stream path's spans, device markers and counters: the port's one
tracing system.

A `StreamTrace` belongs to one `Mapper.map_stream` / `map_long_stream`
call (`Mapper._stream`, `engine.stream.run_stream`).  It records, always:

* **host spans** (`SPANS`), each aggregated per stream into its entries,
  total time and self time (the total less its children's), stamped with
  ``time.time_ns()``, the clock of the profiler's host events.  The
  steps' spans (``step.*``) are entered in `core.pipeline.map_batch` (the
  pair lane) and `core.long_read.map_long_impl` (the long lane) through
  `span`, which finds the stream's trace in a context variable; outside
  a stream it returns a span that does nothing.  A stream enters only
  its own lane's step spans: the other lane's count 0.  While
  ``torch.profiler`` runs, each span also enters a ``record_function``
  named after it, ``#<batch>`` appended inside a batch (the profiler
  keeps a string argument of ``record_function`` out of its trace), so a
  traced window holds the program's spans, nested, on the clock of the
  card's activity.  With the profiler off no ``record_function`` is
  entered.
* **device markers** on CUDA: five timing events of one batch in
  `MARKER_EVERY` on the stream's two streams (`StreamTrace.streams`),
  M0 and M1 around the reads' copies on the copy stream, R on the
  compute stream just before it waits for those copies and S just after
  (the step starts), M2 after the step (`kernels._cuda.TimingEvents`:
  one C call each).  They are resolved as they complete, each marked
  batch's M0 read against the one before's, from at most `MARKER_POOL`
  batches in flight (a batch that finds the pool full is skipped and
  counted), and never waited on.  After the stream's final sync one
  anchor event Z is recorded and synchronised: ``h_Z``, the host clock
  when Z was seen done, places every marker on the host clock,
  ``d(M) = h_Z - elapsed(M, Z)``.
* **counters**: batches, items, the long lane's pseudo-pairs (items x
  (segments - 1)), the reads' bytes copied to the card
  (``h2d_bytes``), the bytes ``pin_memory()`` had to copy on the host
  first because a read array was pageable (``staged_bytes``), and the
  package's kernel launches over the stream (the delta of each
  `kernels._cuda.Kernel.launches`), and how many of candidate_align's
  ran its lane groups (``light_lanes``, the delta of its
  ``paths["lanes"]``; the rest aligned one thread an item).  A step
  replayed from a CUDA graph (`engine.graph`) counts its kernels' launches
  as the eager step does, and the stream counts such steps
  (``graph_replays``) and the graphs it captured (``graph_captures``).
  Only an eager step enters the pair lane's ``step.*`` spans; a replay
  enters ``step`` alone.

The trace keeps no per-batch record and no reference to a batch.  Its
summary (`StreamTrace.summary`, a JSON-able dict) lands on
``StreamResult.trace`` and in `recent`.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
from time import time_ns

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from repro_torch.kernels import _cuda

#: span -> the span it nests in on the stream path
SPANS = {
    "stream": None,                  # the call, after its warm-up batch
    "stream.pull": "stream",         # waiting on the caller's iterator
                                     # (once more than the batches)
    "stream.stage": "stream",        # split, pad, pin: no launch
    "stream.h2d": "stream",          # enqueueing the reads' copies (on
                                     # the copy stream, on CUDA)
    "step": "stream",                # the lane's step, launched
    "step.front": "step",            # revcomp and steps 1-3
    "step.light": "step",            # step 4
    "step.dp": "step",               # step 5 (`_residual_dp_stage`)
    "step.assemble": "step",         # the result's wheres
    "step.segfront": "step",         # long lane: segments and the
                                     # pseudo-pair front end
    "step.vote": "step",             # long lane: diagonals, location_vote
    "step.anchor": "step",           # long lane: windows, banded_sw, the
                                     # result's wheres
    "stream.counts": "stream",       # the stage counts' launches
    "stream.on_result": "stream",    # the consumer's callback
    "stream.drain": "stream",        # final sync, totals fetched, anchor
}
#: spans outside any batch (no batch index)
_UNBATCHED = ("stream", "stream.drain")
#: marked batches in flight at most (the launch queue holds ~6 batches)
MARKER_POOL = 256
#: one batch in this many carries markers, batch 0 and those whose index
#: a multiplicative hash places in the lowest 1/MARKER_EVERY (spread over
#: any period of the input).  A marked batch costs the host ~28 us on the
#: H100's host (five event records, ~3 us each, and one read of four
#: elapsed times, ~13 us), so marking every batch would pass the ~20 us a
#: batch the recorder may cost.
MARKER_EVERY = 8
_HASH = 0x9E3779B9                   # 2**32 / the golden ratio
#: summaries `recent` keeps
RECENT = 8

_ACTIVE: contextvars.ContextVar[StreamTrace | None] = \
    contextvars.ContextVar("repro_torch_stream_trace", default=None)
_RECENT: collections.deque = collections.deque(maxlen=RECENT)


def recent() -> list[dict]:
    """The summaries of this process's last `RECENT` streams that
    returned, newest last."""
    return list(_RECENT)


@contextlib.contextmanager
def no_stream():
    """Within the block no stream is active, so `span` does nothing: a
    graph's capture records a step and runs none."""
    token = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


def span(name: str):
    """The active stream's span ``name`` (a context manager), or one that
    does nothing outside a stream."""
    tr = _ACTIVE.get()
    return _NO_SPAN if tr is None else tr.spans[name]


class _Span:
    """One span name of one stream: its entries and their summed time."""

    __slots__ = ("trace", "name", "batched", "count", "total_ns", "t0", "rf")

    def __init__(self, trace: StreamTrace, name: str):
        self.trace, self.name = trace, name
        self.batched = name not in _UNBATCHED
        self.count = self.total_ns = self.t0 = 0
        self.rf = None

    def __enter__(self):
        self.t0 = time_ns()
        if _profiler_enabled():
            self._mirror()
        return self

    def _mirror(self) -> None:
        tr = self.trace
        tr.profiled = True
        self.rf = record_function(f"{self.name}#{tr.batch}"
                                  if self.batched else self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        self.total_ns += time_ns() - self.t0
        self.count += 1


class _Markers:
    """The five timing events a marked batch on ``device``, resolved as
    they complete; ``events`` is the library's `_cuda.TimingEvents`."""

    __slots__ = ("events", "device", "base_ns", "free", "flight", "last",
                 "staged", "cur", "compute", "copy", "n", "skipped",
                 "chain_ns", "wait_ns", "h2d_ms", "exposed_ms", "step_ms",
                 "out")

    def __init__(self, device: torch.device, base_ns: int, events):
        self.events = events
        self.device = device
        self.base_ns = base_ns
        self.free: list = []
        self.flight: collections.deque = collections.deque()
        self.last = None         # the newest resolved batch's events
        # each batch copied and not yet stepped: (events, h(M0)), or None
        # where unmarked; the batch being stepped's
        self.staged: collections.deque = collections.deque()
        self.cur = None
        self.compute = self.copy = None      # the two streams' handles
        self.n = self.skipped = 0
        # d(M0) of the newest resolved batch less the first's, and the
        # sum of d(M0) - h(M0) less d(first M0) - base_ns, in ns
        self.chain_ns = self.wait_ns = 0.0
        self.h2d_ms = self.exposed_ms = self.step_ms = 0.0
        self.out = None

    def copy_start(self, batch: int) -> None:
        self.staged.append(self._mark(batch))

    def _mark(self, batch: int):
        if (batch * _HASH) % 2**32 >= 2**32 // MARKER_EVERY:
            return None
        if self.flight:
            self.resolve()
        if len(self.flight) >= MARKER_POOL:
            self.skipped += 1
            return None
        ev = self.free.pop() if self.free else tuple(
            self.events.create(self.device.index) for _ in range(5))
        self.events.record(ev[0], self.copy)
        return ev, time_ns()

    def _record(self, k: int, stream) -> None:
        if self.cur is not None:
            self.events.record(self.cur[0][k], stream)

    def copy_end(self) -> None:
        if self.staged[-1] is not None:
            self.events.record(self.staged[-1][0][1], self.copy)

    def wait_start(self) -> None:
        self.cur = self.staged.popleft()
        self._record(2, self.compute)

    def wait_end(self) -> None:
        self._record(3, self.compute)

    def step_end(self) -> None:
        if self.cur is not None:
            self._record(4, self.compute)
            self.flight.append(self.cur)
            self.cur = None

    def resolve(self) -> None:
        """Fold in every batch at the head of the queue whose M2 ran."""
        fl = self.flight
        while fl:
            ev, h0 = fl[0]
            prev = ev[0] if self.last is None else self.last[0]
            got = self.events.times(prev, *ev)
            if got is None:
                return
            fl.popleft()
            self.chain_ns += got[0] * 1e6
            self.wait_ns += self.chain_ns - (h0 - self.base_ns)
            self.h2d_ms += got[1]
            self.exposed_ms += got[2]
            self.step_ms += got[3]
            self.n += 1
            if self.last is not None:
                self.free.append(self.last)
            self.last = ev

    def anchor(self) -> None:
        """After the stream's final sync: record and wait for Z, resolve
        every marker and keep the means (`out`)."""
        if self.last is None and not self.flight:
            self.out = {"batches": 0, "skipped": self.skipped,
                        "every": MARKER_EVERY}
            return
        z = self.events.create(self.device.index)
        try:
            t0 = time_ns()
            self.events.record(z, self.compute)
            self.events.synchronize(z)
            h_z = time_ns()
            self.resolve()
            # d(first M0) - base_ns, from the newest batch's M0 and Z
            first_ns = ((h_z - self.base_ns)
                        - self.events.elapsed(self.last[0], z) * 1e6
                        - self.chain_ns)
        finally:
            self.events.destroy(z)
        n = self.n
        self.out = {
            "batches": n, "skipped": self.skipped, "every": MARKER_EVERY,
            # the means of d(M0) - h(M0), M1 - M0, S - R and M2 - S
            "launch_queue_ms": (first_ns + self.wait_ns / n) / 1e6,
            "h2d_device_ms": self.h2d_ms / n,
            "h2d_exposed_ms": self.exposed_ms / n,
            "step_device_ms": self.step_ms / n,
            # how far h_Z may lie after Z ran (record to seen done)
            "anchor_us": (h_z - t0) / 1e3,
        }

    def close(self) -> None:
        """Free every event."""
        held = list(self.free) + [ev for ev, _ in self.flight]
        held += [m[0] for m in (*self.staged, self.cur) if m is not None]
        if self.last is not None:
            held.append(self.last)
        self.free, self.last, self.cur = [], None, None
        self.flight.clear()
        self.staged.clear()
        for ev in held:
            for e in ev:
                self.events.destroy(e)


def _lane_launches() -> int:
    """candidate_align's launches through its lane groups so far."""
    k = _cuda.KERNELS.get("candidate_align")
    return 0 if k is None else k.paths.get("lanes", 0)


class StreamTrace:
    """The spans, markers and counters of one stream on ``device``.

    ``with trace:`` makes it the active trace (`span`), opens the
    ``stream`` span and, once the block returns, sets ``summary`` and
    appends it to `recent`.  The stream loop sets ``batch``, the index its
    spans carry, and adds to the counters (`Mapper._stream` to
    ``pseudo_pairs``, ``graph_replays`` and ``graph_captures``)."""

    __slots__ = ("device", "spans", "batch", "profiled", "batches", "items",
                 "pseudo_pairs", "graph_replays", "graph_captures",
                 "h2d_bytes", "staged_bytes", "markers", "summary",
                 "_launches", "_lanes", "_token")

    def __init__(self, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.spans = {name: _Span(self, name) for name in SPANS}
        self.batch = 0
        self.profiled = False
        self.batches = self.items = self.pseudo_pairs = 0
        self.graph_replays = self.graph_captures = 0
        self.h2d_bytes = self.staged_bytes = 0
        self.markers = None
        self.summary: dict | None = None

    def __enter__(self):
        self._launches = _cuda.launch_counts()
        self._lanes = _lane_launches()
        self._token = _ACTIVE.set(self)
        self.spans["stream"].__enter__()
        if self.device.type == "cuda":
            self.markers = _Markers(self.device, self.spans["stream"].t0,
                                    _cuda.TimingEvents())
        return self

    def __exit__(self, *exc):
        try:
            self.spans["stream"].__exit__(*exc)
            _ACTIVE.reset(self._token)
            if exc[0] is None:
                self.summary = self._summarise()
                _RECENT.append(self.summary)
        finally:
            if self.markers is not None:
                self.markers.close()

    # -- the markers of the current batch (no-ops off CUDA) ----------------
    def streams(self, compute: int, copy: int) -> None:
        """The handles of the stream's compute and copy streams, which the
        markers are recorded on."""
        if self.markers is not None:
            self.markers.compute, self.markers.copy = compute, copy

    def copy_start(self) -> None:
        if self.markers is not None:
            self.markers.copy_start(self.batch)

    def copy_end(self) -> None:
        if self.markers is not None:
            self.markers.copy_end()

    def wait_start(self) -> None:
        if self.markers is not None:
            self.markers.wait_start()

    def wait_end(self) -> None:
        if self.markers is not None:
            self.markers.wait_end()

    def step_end(self) -> None:
        if self.markers is not None:
            self.markers.step_end()

    def anchor(self) -> None:
        if self.markers is not None:
            self.markers.anchor()

    def _span_summary(self) -> dict:
        """count, total and self ms of each span; a span's self time is
        its total less its children's (`SPANS`)."""
        out = {}
        for name, sp in self.spans.items():
            kids = sum(self.spans[k].total_ns for k, p in SPANS.items()
                       if p == name)
            out[name] = {"parent": SPANS[name], "count": sp.count,
                         "total_ms": sp.total_ns / 1e6,
                         "self_ms": (sp.total_ns - kids) / 1e6}
        return out

    def _summarise(self) -> dict:
        before = self._launches
        launches = {k: n - before.get(k, 0)
                    for k, n in _cuda.launch_counts().items()
                    if n != before.get(k, 0)}
        return {
            "profiled": self.profiled,
            "start_ns": self.spans["stream"].t0,
            "batches": self.batches, "items": self.items,
            "pseudo_pairs": self.pseudo_pairs,
            "graph_replays": self.graph_replays,
            "graph_captures": self.graph_captures,
            "h2d_bytes": self.h2d_bytes, "staged_bytes": self.staged_bytes,
            "launches": launches,
            "light_lanes": _lane_launches() - self._lanes,
            "spans": self._span_summary(),
            "markers": None if self.markers is None else self.markers.out,
        }
