"""The pair step of a full stream batch, replayed from a CUDA graph.

`Mapper.map_stream` on a session that maps on one card through the
kernels (no mesh, no sharded index) hands `engine.stream.run_stream` a
`StepGraphs`: the session's two copy-ring slots of the stream shape,
which outlive a stream, and a graph of the step for each.  The first
full batch a slot carries in a session runs eagerly and its result is
handed on; the step is then captured on the slot's tensors
(`torch.cuda.graph`), and every later full batch in that slot replays
it: one launch for the ~100 kernels and copies the eager step enqueues
one by one.  The graph is a recording of the same code, `Mapper._step`
with every row real and the stage counts stacked into one vector, so
the results are the eager step's bit for bit.  A ragged tail,
`Mapper.map`, the front door, the mesh steps and the long lane run
eagerly.

A replay writes its result into the graph's own memory, which the next
replay of that slot overwrites, while a consumer sees each result a
batch late and may keep it.  So the graph packs the result's fields into
one flat buffer, and each replay's buffer is copied into fresh memory
(one device copy), which the returned result's fields view.  The two
graphs share one memory pool: they replay in turn on the compute stream.
"""
from __future__ import annotations

import torch

from repro_torch.engine import spans
from repro_torch.engine.stream import CopyRing
from repro_torch.kernels import _cuda


def pack(res) -> tuple[torch.Tensor, list]:
    """The fields of ``res`` (a NamedTuple of tensors) as one uint8
    buffer, and where each field lies in it: ``(offset, bytes, dtype,
    shape)`` in field order.  The widest elements go first, so every
    field starts on a multiple of its element size."""
    order = sorted(range(len(res)), key=lambda i: -res[i].element_size())
    layout: list = [None] * len(res)
    parts, off = [], 0
    for i in order:
        t = res[i].contiguous()
        nbytes = t.numel() * t.element_size()
        layout[i] = (off, nbytes, t.dtype, tuple(t.shape))
        parts.append(t.reshape(-1).view(torch.uint8))
        off += nbytes
    return torch.cat(parts), layout


def unpack(kind, flat: torch.Tensor, layout: list):
    """``kind``'s fields as views of ``flat`` (`pack`'s layout)."""
    return kind(*(flat[off:off + nbytes].view(dtype).view(shape)
                  for off, nbytes, dtype, shape in layout))


class StepGraph:
    """One captured step.  ``body()`` returns a NamedTuple of tensors and
    a counts tensor; it is recorded once, on the tensors it reads then,
    and `replay` runs it again on whatever they hold by then."""

    def __init__(self, body, pool):
        self.launches: dict = {}
        self.graph = torch.cuda.CUDAGraph()
        with spans.no_stream(), _cuda.recorded_launches(self.launches), \
                torch.cuda.graph(self.graph, pool=pool,
                                 capture_error_mode="thread_local"):
            res, self.counts = body()
            self.flat, self.layout = pack(res)
        self.kind = type(res)

    def replay(self):
        """Run the step on the current stream: ``(result, counts)``.  The
        result lies in fresh memory; ``counts`` in the graph's, to be read
        before the next replay."""
        self.graph.replay()
        _cuda.count_launches(self.launches)
        return unpack(self.kind, self.flat.clone(), self.layout), self.counts


class StepGraphs:
    """A session's copy-ring slots of one stream shape, and the step
    graph of each (`CopyRing`'s ``owner``).  Another shape drops both."""

    def __init__(self, device: torch.device):
        self.device = device
        self.key = None
        self.slots: list = [None] * CopyRing.SLOTS
        self.graphs: list = [None] * CopyRing.SLOTS
        self.pool = None

    def slot(self, s: int, host) -> list:
        """The device tensors of slot ``s`` for host tensors like
        ``host``."""
        key = tuple((tuple(h.shape), h.dtype) for h in host)
        if key != self.key:
            self.key = key
            self.slots = [None] * CopyRing.SLOTS
            self.graphs = [None] * CopyRing.SLOTS
        if self.slots[s] is None:
            self.slots[s] = [torch.empty(h.shape, dtype=h.dtype,
                                         device=self.device) for h in host]
        return self.slots[s]

    def find(self, reads) -> int | None:
        """The slot whose tensors ``reads`` are, or None."""
        for s, slot in enumerate(self.slots):
            if slot is not None and len(slot) == len(reads) and \
                    all(a is b for a, b in zip(slot, reads)):
                return s
        return None

    def capture(self, s: int, body) -> None:
        """Record ``body`` (`StepGraph`) as slot ``s``'s step."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        self.graphs[s] = StepGraph(body, self.pool)

    def forget(self) -> None:
        """Drop the graphs, which read the index they were captured with;
        the slots stay."""
        self.graphs = [None] * CopyRing.SLOTS
