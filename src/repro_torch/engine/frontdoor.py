"""The continuous-batching serve front door over one `Mapper` session.

`Mapper.map_stream` consumes a *pre-batched* generator: every item is
already a fixed-shape batch.  Real serve traffic is ragged and bursty:
requests of 1..B read pairs (or long reads) arriving whenever users send
them.  `FrontDoor` is the host-side layer that turns that traffic into the
stream the device wants:

  * **coalescing**: arrivals are queued per lane and packed into full
    fixed-shape batches; a partial pack is padded with
    `engine.stream.pad_tail` and masked by the step's ``n_valid``, exactly
    like a ragged `map_stream` tail batch;
  * **one step per batch**: each coalesced batch is concatenated and
    padded on the host, copied to the device from pinned memory, and
    mapped by the lane's step (`Mapper._step` / `_long_step`, the kernels
    of `map_stream`), with the lane's stage totals added on the device;
  * **one batch late**: a CUDA event is recorded right after each
    dispatch, and a batch is retired (its event waited on, its requests
    given their result rows) only once the next one was dispatched, so
    the host blocks on work that has had a full dispatch of overlap and
    each ``service_s`` sample times its own batch;
  * **latency ledger**: every request is stamped at enqueue, dispatch and
    result; `engine.stats.ServeStats` aggregates queue wait / service /
    total (p50 + p99) next to the device-side stage totals;
  * **admission control**: the queue is bounded (``max_queue_rows``):
    arrivals past the bound are *rejected*; requests whose deadline passes
    while queued are *expired* at dispatch instead of wasting device work;
    arrivals during a drain are *shed*;
  * **two-lane scheduling**: one door feeds the short-read (``"pairs"``)
    and long-read (``"long"``) lanes of one session.  The pair lane has
    priority, but a backlogged long lane is served, even partially filled,
    after ``long_every`` consecutive pair batches, so neither starves;
  * **fault tolerance**: a `runtime.preemption.PreemptionGuard` turns
    SIGTERM into a *drain* (stop admitting, finish every accepted request)
    and a per-lane `runtime.watchdog.Watchdog` shrinks the coalescing
    target while steps straggle (``degrade_factor``) and escalates a
    persistent straggler (EVICT) to a drain.

Batch composition does not change a request's results: the pipeline is
row-independent as long as the residual-DP buffer does not overflow
(`PipelineConfig.residual_capacity_frac`; 1.0 removes overflow), so each
row of a door batch equals a direct ``mapper.map`` / ``map_long`` of the
same reads.

Trace-driven use::

    fd = FrontDoor(mapper, FrontDoorConfig(max_queue_rows=4 * B))
    report = fd.serve(arrivals)     # yields ("pairs", (r1, r2)) /
                                    # ("long", (reads,)) [, deadline_s]

Online use: call ``submit`` from the request thread and
``dispatch_ready`` / ``drain`` from the serve loop; the queues are
lock-protected.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from repro_torch.engine.mapper import Mapper
from repro_torch.engine.stats import (
    ServeStats,
    add_stage_counts,
    fetch_stage_totals,
    init_stage_totals,
)
from repro_torch.engine.multihost import fleet_batch_target
from repro_torch.engine.stream import pad_tail, to_device
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.watchdog import (
    EVICT,
    HEALTHY,
    Watchdog,
    WatchdogConfig,
)
from repro_torch.tree import tree_map

LANE_PAIRS, LANE_LONG = "pairs", "long"

#: request lifecycle states (`ServeStats` counts the terminal ones)
QUEUED, DISPATCHED, DONE = "queued", "dispatched", "done"
REJECTED, EXPIRED, SHED = "rejected", "expired", "shed"


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Knobs of the serving layer (the device side is the Mapper's).

    max_queue_rows:   admission bound: total rows (pairs + long reads)
                      queued across both lanes; arrivals past it are
                      rejected.  None derives ``8 * stream_batch``.
    default_deadline_s: per-request deadline applied when ``submit``
                      gives none (None: requests never expire).
    long_every:       starvation guard: a backlogged long lane is served
                      (even partially filled) after this many consecutive
                      pair batches.
    degrade_factor:   coalescing-target multiplier while a lane's
                      watchdog is out of HEALTHY: batches dispatch at
                      ``stream_batch * degrade_factor`` valid rows so a
                      straggling step shortens queue waits instead of
                      stalling them.
    watchdog:         per-lane straggler detector config; EVICT requests
                      a drain through the preemption guard.
    record_requests:  keep every `Request` on ``FrontDoor.requests``
                      (tests, trace post-mortems); disable for
                      long-running doors.
    """

    max_queue_rows: int | None = None
    default_deadline_s: float | None = None
    long_every: int = 4
    degrade_factor: float = 0.5
    watchdog: WatchdogConfig = dataclasses.field(
        default_factory=WatchdogConfig)
    record_requests: bool = True


@dataclasses.dataclass
class Request:
    """One ragged arrival: ``n`` rows for one lane, and its lifecycle."""

    id: int
    lane: str
    reads: tuple            # host read arrays, (n, L) each
    n: int
    deadline: float | None  # absolute wall-clock expiry, or None
    status: str = QUEUED
    t_enqueue: float = 0.0
    t_dispatch: float | None = None
    t_result: float | None = None
    #: per-request rows of the lane step's result (`MapResult` /
    #: `LongReadResult` of device tensors) once status is DONE
    result: object = None

    @property
    def latency_s(self) -> float | None:
        if self.t_result is None:
            return None
        return self.t_result - self.t_enqueue


class FrontDoor:
    """Request-queue serving layer over one `Mapper` session."""

    def __init__(self, mapper: Mapper, config: FrontDoorConfig | None = None,
                 guard: PreemptionGuard | None = None):
        if mapper.exec_cfg.stream_batch is None:
            raise ValueError(
                "FrontDoor needs a fixed device batch shape; build the "
                "Mapper with ExecutionConfig(stream_batch=...)")
        self.mapper = mapper
        self.config = config or FrontDoorConfig()
        self.stream_batch = int(mapper.exec_cfg.stream_batch)
        self.max_queue_rows = (self.config.max_queue_rows
                               if self.config.max_queue_rows is not None
                               else 8 * self.stream_batch)
        self.lanes = (LANE_PAIRS,) + (
            (LANE_LONG,) if mapper.lr_cfg is not None else ())
        self._n_arrays = {lane: mapper._LANES[lane][3] for lane in self.lanes}
        self._totals = {lane: init_stage_totals(mapper.device,
                                                mapper._LANES[lane][2])
                        for lane in self.lanes}
        self._queues = {lane: collections.deque() for lane in self.lanes}
        self._queued_rows = {lane: 0 for lane in self.lanes}
        self._watchdogs = {lane: Watchdog(self.config.watchdog)
                           for lane in self.lanes}
        self._own_guard = guard is None
        self._guard = guard or PreemptionGuard()
        self._lock = threading.RLock()
        self._ids = itertools.count()
        self._inflight = None        # (lane, res, spans, t_dispatch, event)
        self._deferred = 0           # pair batches served past a long backlog
        self._draining = False
        self._fleet_states = ()      # the peers' watchdog states
        self.stats = ServeStats()
        self.requests: list[Request] = []

    # ------------------------------------------------------- admission ---
    def submit(self, lane: str, reads, deadline_s: float | None = None
               ) -> Request:
        """Enqueue one request of 1..stream_batch rows for ``lane``.

        ``reads`` is the lane's read-array tuple (``(reads1, reads2)`` on
        the pair lane, ``(reads,)`` on the long lane) with matching
        leading dims.  Returns the `Request` at once; its ``status`` says
        whether it was accepted (QUEUED) or refused (REJECTED on a full
        queue, SHED while draining).
        """
        if lane not in self._queues:
            raise ValueError(f"unknown lane {lane!r}; this session serves "
                             f"{self.lanes}")
        reads = tuple(np.asarray(r) for r in reads)
        if len(reads) != self._n_arrays[lane]:
            raise ValueError(
                f"lane {lane!r} requests carry {self._n_arrays[lane]} read "
                f"arrays; got {len(reads)}")
        n = reads[0].shape[0]
        if any(r.shape[0] != n for r in reads):
            raise ValueError("request read arrays disagree on row count")
        if not 1 <= n <= self.stream_batch:
            raise ValueError(
                f"request of {n} rows; the front door serves 1.."
                f"{self.stream_batch} (the session's stream_batch)")
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        now = time.time()
        req = Request(id=next(self._ids), lane=lane, reads=reads, n=n,
                      deadline=None if deadline_s is None
                      else now + deadline_s,
                      t_enqueue=now)
        with self._lock:
            if self.config.record_requests:
                self.requests.append(req)
            if self._draining or self._guard.should_checkpoint():
                req.status = SHED
                self.stats.count("shed", n)
            elif sum(self._queued_rows.values()) + n > self.max_queue_rows:
                req.status = REJECTED
                self.stats.count("rejected", n)
            else:
                self._queues[lane].append(req)
                self._queued_rows[lane] += n
                self.stats.count("accepted", n)
        return req

    # ----------------------------------------------------- fleet health --
    def request_drain(self, reason: str = "requested") -> None:
        """Stop admitting (the rest of the traffic is shed with explicit
        accounting) and finish every accepted request.  Called when a peer
        host drains, by operators, and on watchdog EVICT / preemption."""
        self.stats.mark_drain(reason)
        self._draining = True
        self._guard.request()

    def observe_fleet(self, states) -> None:
        """Fold one keep-alive round's per-host control words (dicts of
        ``host``, ``have``, ``state``, ``draining``, ``error``) into this
        door's scheduling: any peer out of HEALTHY shrinks the coalescing
        target (one slow host slows every collective dispatch;
        `multihost.fleet_batch_target`), and a draining or errored peer
        triggers the coordinated drain.  `multihost.door_health` makes it
        a fleet stream's ``on_health`` callback."""
        for s in states:
            self.stats.observe_host(
                s["host"], have=s.get("have", True),
                state=s.get("state", HEALTHY),
                draining=s.get("draining", False),
                error=s.get("error", False))
        self._fleet_states = tuple(s.get("state", HEALTHY) for s in states)
        if any(s.get("draining") or s.get("error") for s in states):
            self.request_drain("fleet")

    # ------------------------------------------------------- scheduler ---
    def _target(self, lane: str) -> int:
        """Coalescing fill target: full batches while HEALTHY, degraded
        otherwise (a straggling step, local or anywhere in the fleet,
        should shorten waits, not grow them)."""
        return fleet_batch_target(
            (self._watchdogs[lane].state, *self._fleet_states),
            self.stream_batch, self.config.degrade_factor)

    def _pick_lane(self, force: bool = False) -> str | None:
        """Starvation-free priority pick: pairs first, but a backlogged
        long lane is served after ``long_every`` consecutive pair
        batches.  ``force`` serves any backlog regardless of fill (drain
        / end of trace)."""
        nonempty = [ln for ln in self.lanes if self._queued_rows[ln] > 0]
        if not nonempty:
            return None
        if LANE_LONG in nonempty and self._deferred >= self.config.long_every:
            self._deferred = 0
            return LANE_LONG
        ready = [ln for ln in nonempty
                 if force or self._queued_rows[ln] >= self._target(ln)]
        if not ready:
            return None
        lane = LANE_PAIRS if LANE_PAIRS in ready else ready[0]
        if lane != LANE_LONG and LANE_LONG in nonempty:
            self._deferred += 1
        elif lane == LANE_LONG:
            self._deferred = 0
        return lane

    def _form_batch(self, lane: str) -> tuple[list, int]:
        """Pop expired requests, then up to the fill target of rows."""
        now = time.time()
        target = self._target(lane)
        q = self._queues[lane]
        picked, rows = [], 0
        with self._lock:
            while q and rows < target:
                req = q[0]
                if req.deadline is not None and now > req.deadline:
                    q.popleft()
                    self._queued_rows[lane] -= req.n
                    req.status = EXPIRED
                    self.stats.count("expired", req.n)
                    continue
                if rows + req.n > self.stream_batch:
                    break        # keep FIFO order; goes in the next batch
                q.popleft()
                self._queued_rows[lane] -= req.n
                picked.append(req)
                rows += req.n
        return picked, rows

    def _run_step(self, lane: str, reads, n: int, totals):
        """One lane step on host arrays padded to the batch shape, its
        stage counts added to ``totals`` on the device."""
        m = self.mapper
        step_name, counts_fn, keys, _ = m._LANES[lane]
        res = getattr(m, step_name)(*(to_device(r, m.device) for r in reads),
                                    n)
        add_stage_counts(totals, counts_fn(res), keys)
        return res

    def _dispatch(self, lane: str, picked: list, rows: int) -> None:
        B = self.stream_batch
        reads = tuple(
            pad_tail(np.concatenate([r.reads[i] for r in picked], axis=0), B)
            for i in range(self._n_arrays[lane]))
        t = time.time()
        for r in picked:
            r.status = DISPATCHED
            r.t_dispatch = t
        res = self._run_step(lane, reads, rows, self._totals[lane])
        event = None
        if self.mapper.device.type == "cuda":
            # marks the end of this batch's work on the stream: waiting on
            # it does not wait for a batch dispatched after it
            event = torch.cuda.Event()
            event.record()
        spans, lo = [], 0
        for r in picked:
            spans.append((r, lo, lo + r.n))
            lo += r.n
        self.stats.observe_batch(lane, rows, degraded=self._target(lane) < B)
        # Retire the *previous* batch after dispatching this one: the host
        # only blocks on work that already had a full dispatch of overlap.
        prev, self._inflight = self._inflight, (lane, res, spans, t, event)
        self._retire(prev)

    def _retire(self, entry) -> None:
        if entry is None:
            return
        lane, res, spans, t_dispatch, event = entry
        if event is not None:
            event.synchronize()
        t = time.time()
        if self._watchdogs[lane].observe(t - t_dispatch) == EVICT:
            # persistent straggler: degrading didn't help; stop taking
            # traffic and drain what was accepted
            self.stats.mark_drain("watchdog-evict")
            self._guard.request()
        for req, lo, hi in spans:
            req.result = tree_map(lambda a: a[lo:hi], res)
            req.status = DONE
            req.t_result = t
            self.stats.observe_request(
                rows=req.n, t_enqueue=req.t_enqueue,
                t_dispatch=req.t_dispatch, t_result=t)

    # ------------------------------------------------------ serve loops --
    def dispatch_ready(self) -> int:
        """Dispatch every lane that reached its fill target; returns the
        number of batches dispatched."""
        n = 0
        while (lane := self._pick_lane()) is not None:
            picked, rows = self._form_batch(lane)
            if not picked:
                continue     # the backlog was all expired requests
            self._dispatch(lane, picked, rows)
            n += 1
        return n

    def drain(self) -> None:
        """Dispatch every queued request (partial batches included) and
        retire all in-flight work.  Idempotent; `serve` calls it at the end
        of the trace and on preemption."""
        while (lane := self._pick_lane(force=True)) is not None:
            picked, rows = self._form_batch(lane)
            if not picked:
                continue
            self._dispatch(lane, picked, rows)
        prev, self._inflight = self._inflight, None
        self._retire(prev)

    def serve(self, arrivals, drain: bool = True) -> dict:
        """Trace-driven synchronous serve loop.

        ``arrivals`` yields ``(lane, reads)`` or ``(lane, reads,
        deadline_s)`` items (``reads`` = the lane's read-array tuple).
        Each arrival goes through admission control and batches dispatch
        whenever a lane reaches its fill target.  A preemption request
        (SIGTERM, `PreemptionGuard.request`, watchdog EVICT) stops
        admission (the rest of the trace is shed with explicit accounting)
        and the accepted backlog drains: no accepted request is lost.
        Returns :meth:`report`.
        """
        for item in arrivals:
            if self._guard.should_checkpoint():
                self.stats.mark_drain("preemption")
                self._draining = True
            lane, reads = item[0], item[1]
            deadline_s = item[2] if len(item) > 2 else None
            self.submit(lane, reads, deadline_s=deadline_s)
            if not self._draining:
                self.dispatch_ready()
        if drain or self._draining:
            self.drain()
        return self.report()

    def reload_index(self, store) -> str:
        """Swap the session's index at a dispatch boundary.

        The in-flight batch (dispatched against the old index) is retired
        first, then the index swaps via `Mapper.swap_index`, and every
        batch formed afterwards serves the new index; queued requests are
        untouched, so no accepted request is lost.  Returns the swap's
        outcome: ``"reused"``, ``"rebuilt"`` or ``"kept"`` (an unreadable
        store keeps the index already served).  Stage totals and the
        serving ledger accumulate across the swap.
        """
        with self._lock:
            prev, self._inflight = self._inflight, None
            self._retire(prev)
            return self.mapper.swap_index(store)

    def warmup(self, long_reads=None) -> None:
        """Run each lane's step once outside the served (latency-stamped)
        path: one all-padding batch per lane on scratch totals.  On the
        card this is where the kernels are built on first use.

        The long lane warms only when given an example ``(n, L)`` read
        array of the traffic's shape.
        """
        B = self.stream_batch
        zeros = np.zeros((B, self.mapper.pipe_cfg.read_len), np.uint8)
        batches = [(LANE_PAIRS, (zeros, zeros))]
        if long_reads is not None and LANE_LONG in self.lanes:
            batches.append((LANE_LONG, (pad_tail(np.asarray(long_reads),
                                                 B),)))
        for lane, reads in batches:
            scratch = torch.zeros_like(self._totals[lane])
            self._run_step(lane, reads, 0, scratch)
        if self.mapper.device.type == "cuda":
            torch.cuda.synchronize(self.mapper.device)

    # -------------------------------------------------------- reporting --
    def report(self) -> dict:
        """The flushed ledger: admission + latency stats next to the
        device-side per-lane stage totals (one host sync per lane)."""
        keys = {lane: self.mapper._LANES[lane][2] for lane in self.lanes}
        return {
            "lanes": list(self.lanes),
            "stream_batch": self.stream_batch,
            "max_queue_rows": self.max_queue_rows,
            "serve": self.stats.ledger(capacity=self.stream_batch),
            "stage_totals": {lane: fetch_stage_totals(self._totals[lane],
                                                      keys[lane])
                             for lane in self.lanes},
            "watchdog": {lane: self._watchdogs[lane].state
                         for lane in self.lanes},
            "drained": self._draining or self._guard.should_checkpoint(),
        }

    def close(self) -> None:
        """Release the signal handler (only if this door installed it)."""
        if self._own_guard:
            self._guard.uninstall()

    def __enter__(self) -> "FrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
