"""Multi-host `map_stream`: per-host generators, one global batch a round,
and the fleet's lockstep keep-alive fault-tolerance protocol.

A serve fleet runs one process per host (`torch.distributed`, one rank a
host), each pulling reads from its *own* source: a shard of the FASTQ, its
slice of the request queue.  Each round every host contributes its batch,
the fleet all_gathers the contributions in rank order into the global
batch, and every host maps it on the replicated-index data-parallel plan
(`ExecutionConfig(mesh=...)`, `core/distributed.py::RowSplit`): each rank
maps its rows of the data axis and all_gathers the result, so every host
holds the global result.

Contract differences from the single-host loop (`Mapper.map_stream`):

  * **shape**: ``ExecutionConfig.stream_batch`` is the *global* batch;
    every host contributes ``stream_batch / process_count`` rows (the
    first batch fixes the split when ``stream_batch`` is None).
  * **tails**: each host pads its own ragged tail, so padding sits inside
    the global batch, not at its end: the step takes a (B,) per-row
    validity mask instead of the scalar count of leading rows.
  * **lockstep keep-alive**: every round is a collective, so a host that
    leaves the loop early would hang the rest.  None does: each round
    also all_gathers a per-host **control word** ``[want_continue,
    watchdog_state, draining, error]``, and a host whose generator ran
    dry, whose `PreemptionGuard` fired or whose iteration raised keeps
    contributing all-invalid padded batches (masked, so the totals stay
    exact) until the control words say every host is idle; then all
    hosts stop at the same round, by the same rule on the same values.
  * **coordinated drain**: a host publishing ``draining`` (SIGTERM via
    the guard, watchdog EVICT, or an iteration error) turns every peer to
    draining once they read it: the fleet stops pulling new batches and
    winds down together.  Batches already pulled are still mapped, so no
    accepted batch is lost.
  * **stats**: the stage totals are summed over the global result, so
    every host's `StreamResult` is the same; the per-host health ledger
    (`ServeStats.fleet`, `StreamResult.health`) records who contributed
    what.  Gate host-side reporting with `process_index` / `log0`.

A host reads round ``k-1``'s control words after it prepared round ``k``'s
batch (a one-round lag, as in the JAX package, where the read waits for
the device); the price of consensus is one trailing all-invalid round a
stream.

When `process_count` is 1 the call is ``Mapper._stream``, the
single-host loop, bit for bit; a ``guard`` or ``watchdog`` is still
honoured host-side (drain between batches), so ``serve --chaos`` works on
one host too.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.engine.mapper import Mapper
from repro_torch.engine.stats import (
    ServeStats,
    add_stage_counts,
    fetch_stage_totals,
    init_stage_totals,
)
from repro_torch.engine.stream import (
    StreamResult,
    pad_tail,
    split_batch,
    to_device,
)
from repro_torch.runtime.watchdog import (
    DEGRADED,
    EVICT,
    HEALTHY,
    Watchdog,
    WatchdogConfig,
)
from repro_torch.tree import tree_map

#: the denominator stat key per lane: a sum of the global ``n_valid``
#: mask, so it is also the fleet-wide item count
_DENOM = {"pairs": "n_pairs", "long": "n_reads"}

#: control-word fields (per host, int32): does this host contribute real
#: data this round / its watchdog state / is it draining / did its
#: iteration raise (the error is re-raised host-side after the stop)
CTRL_FIELDS = ("want_continue", "state", "draining", "error")
_CTRL_W = len(CTRL_FIELDS)

_STATE_CODE = {HEALTHY: 0, DEGRADED: 1, EVICT: 2}
_CODE_STATE = {v: k for k, v in _STATE_CODE.items()}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The fleet's hosts: the default process group's world size, 1 when
    no group is initialised."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This host's rank in the default process group, 0 without one."""
    return dist.get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """True on exactly one host (rank 0): gate logging and reporting."""
    return process_index() == 0


def log0(*args, **kwargs) -> None:
    """`print`, on the coordinator only."""
    if is_coordinator():
        print(*args, **kwargs)


def fleet_batch_target(states, base: int,
                       degrade_factor: float = 0.5) -> int:
    """The fleet's coalescing / batch target given per-host health.

    ``states`` are watchdog state strings, one a host (from an
    ``on_health`` callback or ``StreamResult.health``); any host out of
    HEALTHY shrinks the target by ``degrade_factor``: a degraded host
    slows every collective round, so the whole fleet coalesces smaller
    batches and requests stop waiting behind it
    (`FrontDoor.observe_fleet` applies this to its queues)."""
    if any(s != HEALTHY for s in states):
        return max(1, int(base * degrade_factor))
    return base


def door_health(door):
    """An ``on_health`` callback that folds each round's control words
    into a `FrontDoor` (`FrontDoor.observe_fleet`): its coalescing target
    follows `fleet_batch_target`, and a draining peer drains it."""
    def on_health(round_idx, states):  # noqa: ARG001
        door.observe_fleet(states)
    return on_health


def check_local_rows(host: int, batch_idx: int, local_n: int,
                     local_batch: int) -> None:
    """Reject a host batch larger than the fleet's fixed per-host split,
    naming the host, the batch and both sizes (`pad_tail` only pads up)."""
    if local_n > local_batch:
        raise ValueError(
            f"host {host}: batch {batch_idx} has {local_n} rows but the "
            f"fleet's per-host batch is {local_batch} "
            f"(stream_batch / process_count); shrink the batch or raise "
            f"stream_batch")


def _tree_def(tree):
    """The structure of an aux tree (`stream.tree_map`'s containers),
    leaves left out: two items whose aux differ here are a torn record."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_def(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_tree_def(v) for v in tree))
    return None if tree is None else "leaf"


def _host_batches(batches, guard, dog: Watchdog | None, stats: ServeStats):
    """The one-host chaos shim: no keep-alive (one host cannot hang
    itself), but a `PreemptionGuard` still turns SIGTERM into a drain
    between batches and a `Watchdog` still tracks generator stalls."""
    it = iter(batches)
    while True:
        if guard is not None and guard.should_checkpoint():
            stats.mark_drain("preemption")
            return
        t0 = time.time()
        try:
            item = next(it)
        except StopIteration:
            return
        if dog is not None and dog.observe(time.time() - t0) == EVICT:
            stats.mark_drain("watchdog-evict")
            if guard is not None:
                guard.request()
            yield item        # EVICT drains, but the pulled batch lands
            return
        yield item


@dataclasses.dataclass
class _HostSource:
    """This host's side of the keep-alive protocol: pulls batches and
    turns exhaustion, preemption, watchdog EVICT and iteration errors into
    the permanent (exhausted / draining / error) flags its control word
    publishes.  Host-side state only, testable without a fleet."""

    it: object
    guard: object = None
    dog: Watchdog | None = None
    stats: ServeStats = dataclasses.field(default_factory=ServeStats)
    exhausted: bool = False
    draining: bool = False
    error: BaseException | None = None

    def pull(self):
        """The next item, or None once this host only keeps alive.  The
        pull is timed into the host's watchdog: the round's own time is
        common to the fleet, so the time a host takes to produce its batch
        is what singles out a straggler."""
        item = None
        if not (self.exhausted or self.draining):
            t0 = time.time()
            try:
                item = next(self.it)
            except StopIteration:
                self.exhausted = True
            except Exception as e:  # noqa: BLE001 - drained, re-raised
                self.fail(e)
            else:
                if self.dog is not None and \
                        self.dog.observe(time.time() - t0) == EVICT:
                    self.draining = True
                    self.stats.mark_drain("watchdog-evict")
        if self.guard is not None and self.guard.should_checkpoint() \
                and not self.draining:
            self.draining = True
            self.stats.mark_drain("preemption")
        return item

    def fail(self, e: BaseException) -> None:
        """Turn a host-side error into a draining keep-alive exit."""
        if self.error is None:
            self.error = e
        self.draining = True
        self.stats.mark_drain("error")

    def drain_for_fleet(self) -> None:
        """A peer is draining or failed: stop pulling, wind down with it."""
        if not self.draining:
            self.draining = True
            self.stats.mark_drain("fleet")

    @property
    def idle(self) -> bool:
        return self.exhausted or self.draining

    def ctrl_word(self, have: bool) -> np.ndarray:
        state = self.dog.state if self.dog is not None else HEALTHY
        return np.array([int(have), _STATE_CODE[state], int(self.draining),
                         int(self.error is not None)], dtype=np.int32)


def _all_gather(x: torch.Tensor, n_proc: int) -> torch.Tensor:
    """Every host's (b, ...) ``x`` concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(n_proc)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def map_stream(mapper: Mapper, batches, *, lane: str = "pairs",
               on_result=None, reduce_fn=None, reduce_init=None,
               warmup_batch=None, guard=None, watchdog=None,
               serve_stats: ServeStats | None = None, on_health=None,
               pad_batch=None) -> StreamResult:
    """Stream this host's batches through the fleet, one global batch a
    round.

    ``batches`` yields this *host's* ``(*reads[, aux])`` items (the
    single-host item contract, at the per-host batch shape).
    ``reduce_fn`` / ``reduce_init`` / ``warmup_batch`` / ``on_result``
    behave as on `Mapper.map_stream`, over the *global* batch: every host
    holds the global result, and ``on_result(idx, res, mask)`` sees it
    with its (B,) validity mask for every round, keep-alive rounds
    included.  ``lane`` is "pairs" or "long".

    Fault tolerance (the module docstring's protocol): ``guard``, a
    `PreemptionGuard` whose firing drains the whole fleet with no accepted
    batch lost; ``watchdog``, a `Watchdog` or `WatchdogConfig` fed this
    host's batch-production times (its state goes fleet-wide in the
    control word; EVICT drains); ``serve_stats`` receives the per-host
    health ledger (made here if not given; it also lands on
    ``StreamResult.health``); ``on_health(round, states)`` sees the
    fleet's control words once a round (e.g. `door_health`).
    ``pad_batch`` is an example item keep-alive padding is shaped after
    if this host runs dry before yielding anything (otherwise the first
    item or the warmup batch; a pairs-lane host with a fixed
    ``stream_batch`` needs none).

    An iteration error becomes a draining keep-alive exit, and the
    exception is re-raised *after* the fleet stopped, with the final
    `StreamResult` as ``.stream_result``.

    Returns the same `StreamResult` on every host: ``n_pairs`` is the
    fleet-wide count of valid items, ``n_batches`` the fleet's rounds and
    ``health`` the per-host ledger.
    """
    stats = serve_stats if serve_stats is not None else ServeStats()
    dog = (Watchdog(watchdog) if isinstance(watchdog, WatchdogConfig)
           else watchdog)
    if process_count() == 1:
        # one host: the single-host loop, bit for bit; no keep-alive
        if guard is None and dog is None and serve_stats is None:
            return mapper._stream(lane, batches, on_result, reduce_fn,
                                  reduce_init, warmup_batch)
        src = _host_batches(batches, guard, dog, stats)
        sr = mapper._stream(lane, src, on_result, reduce_fn, reduce_init,
                            warmup_batch)
        health = {
            "host": 0, "n_hosts": 1, "lane": lane,
            "rounds": sr.n_batches, "local_batches": sr.n_batches,
            "keepalive_rounds": 0,
            "drained": stats.drain_reason is not None,
            "drain_reason": stats.drain_reason,
            "watchdog": dog.state if dog is not None else HEALTHY,
            "error": None, "ctrl_log": [],
        }
        stats.fleet[0] = {"batches": sr.n_batches, "keepalive": 0,
                          "state": health["watchdog"],
                          "draining": health["drained"], "error": False}
        return dataclasses.replace(sr, health=health)

    if mapper.exec_cfg.mesh is None:
        raise ValueError(
            "multi-host map_stream needs ExecutionConfig(mesh=...) over "
            "the fleet's devices")
    if mapper.exec_cfg.shard_index:
        raise NotImplementedError(
            "multi-host map_stream serves the replicated-index plan; "
            "shard_index sessions are single-controller only")
    if dog is None:
        dog = Watchdog()
    step_name, counts_fn, keys, n_arrays = mapper._LANES[lane]
    step = getattr(mapper, step_name)
    n_proc, pid = process_count(), process_index()
    dev = mapper.device
    local_batch = None
    if mapper.exec_cfg.stream_batch is not None:
        if mapper.exec_cfg.stream_batch % n_proc:
            raise ValueError(
                f"stream_batch={mapper.exec_cfg.stream_batch} must divide "
                f"evenly over {n_proc} processes")
        local_batch = mapper.exec_cfg.stream_batch // n_proc
    totals = init_stage_totals(dev, keys)
    reduced = reduce_init

    # keep-alive padding template: the read shapes and dtypes and a zero
    # aux tree, fixed by pad_batch, the warmup batch or the first item
    template = None
    aux_def = None

    def set_template(reads, aux):
        nonlocal template, aux_def
        if template is None:
            template = (tuple((r.shape[1:], r.dtype) for r in reads),
                        tree_map(lambda a: np.zeros_like(np.asarray(a)),
                                 aux))
            aux_def = _tree_def(aux)

    def default_template():
        if lane == "pairs" and local_batch is not None:
            L = mapper.pipe_cfg.read_len
            return (tuple(((L,), np.dtype(np.uint8))
                          for _ in range(n_arrays)), ())
        raise ValueError(
            f"host {pid} ran dry before its first batch and no pad_batch "
            "template was given; pass pad_batch= (an example (*reads[, "
            "aux]) item) so keep-alive padding matches the fleet's batch "
            "shapes")

    if pad_batch is not None:
        p_reads, p_aux = split_batch(pad_batch, n_arrays)
        p_reads = tuple(np.asarray(r) for r in p_reads)
        if local_batch is None:
            local_batch = int(p_reads[0].shape[0])
        set_template(p_reads, p_aux)

    def prepare(item, batch_idx):
        """This host's contribution to a round: (reads, n, aux), padded to
        the per-host batch; an item of None is keep-alive padding.  Only
        local checks, no collective: a fault here can still drain."""
        nonlocal local_batch, template
        if item is not None:
            reads, aux = split_batch(item, n_arrays)
            reads = tuple(np.asarray(r) for r in reads)
            n = int(reads[0].shape[0])
            if local_batch is None:
                local_batch = n
            check_local_rows(pid, batch_idx, n, local_batch)
            set_template(reads, aux)
            if _tree_def(aux) != aux_def:
                raise ValueError(
                    f"host {pid}: batch {batch_idx} aux pytree structure "
                    f"changed mid-stream (torn record?): {_tree_def(aux)} "
                    f"!= {aux_def}")
        else:
            if template is None:
                template = default_template()
            spec, aux = template
            reads = tuple(np.zeros((local_batch,) + shape, dtype)
                          for shape, dtype in spec)
            n = 0
        reads = tuple(pad_tail(r, local_batch) for r in reads)
        aux = tree_map(lambda a: pad_tail(a, local_batch), aux)
        return reads, n, aux

    def gather(local, ctrl):
        """The round's collective: every host's reads, validity mask and
        aux rows in rank order, and the fleet's control words."""
        reads, n, aux = local
        g_reads = tuple(_all_gather(to_device(r, dev), n_proc)
                        for r in reads)
        word = np.concatenate([(np.arange(local_batch) < n).astype(np.int32),
                               ctrl])
        g_word = _all_gather(to_device(word, dev), n_proc).view(
            n_proc, local_batch + _CTRL_W)
        mask = g_word[:, :local_batch].reshape(-1).bool()

        def put(a):     # 0-d leaves are the same on every host
            return (to_device(a, dev) if np.ndim(a) == 0
                    else _all_gather(to_device(a, dev), n_proc))

        return g_reads, mask, tree_map(put, aux), g_word[:, local_batch:]

    src = _HostSource(it=iter(batches), guard=guard, dog=dog, stats=stats)
    ctrl_log = []

    def fold_ctrl(round_idx, ctrl_all):
        """Fold one round's control words into the fleet view; True when
        every host was idle that round (the shared stop rule)."""
        by_host = ctrl_all.cpu().numpy()
        ctrl_log.append(by_host.astype(int).tolist())
        states = []
        for h in range(n_proc):
            have, code, draining, err = (int(x) for x in by_host[h])
            state = _CODE_STATE.get(code, HEALTHY)
            stats.observe_host(h, have=bool(have), state=state,
                               draining=bool(draining), error=bool(err))
            states.append({"host": h, "have": bool(have), "state": state,
                           "draining": bool(draining), "error": bool(err)})
        if any(s["draining"] or s["error"] for s in states):
            src.drain_for_fleet()
        if on_health is not None:
            on_health(round_idx, states)
        return not any(s["have"] for s in states)

    def dispatch(local, have):
        nonlocal reduced
        g_reads, mask, aux, ctrl_all = gather(local, src.ctrl_word(have))
        res = step(*g_reads, mask)
        add_stage_counts(totals, counts_fn(res), keys)
        if reduce_fn is not None:
            reduced = reduce_fn(reduced, res, aux)
        return res, mask, ctrl_all

    n_rounds = n_real = 0
    prev = res = None
    pending = None          # (round, control words) awaiting their read
    t0 = None
    if warmup_batch is not None:
        g_reads, mask, _, _ = gather(prepare(warmup_batch, -1),
                                     src.ctrl_word(True))
        step(*g_reads, mask)
    while True:
        # 1. this round's contribution first: the pull overlaps the
        #    device work of the round in flight
        item = src.pull()
        local = None
        if item is not None:
            try:
                local = prepare(item, n_rounds)
            except Exception as e:  # noqa: BLE001 - drained, re-raised
                src.fail(e)
                item = None
        if local is None:
            try:
                local = prepare(None, n_rounds)
            except ValueError as e:
                src.fail(e)     # nothing to pad with: stop contributing
        # 2. round k-1's control words: every host applies the same stop
        #    rule to the same values, so all stop at the same round
        if pending is not None:
            r_idx, ctrl_all = pending
            pending = None
            if fold_ctrl(r_idx, ctrl_all):
                break
        if local is None:
            break
        # 3. round k: a real batch or keep-alive padding
        if t0 is None:
            t0 = time.time()
        res, mask, ctrl_all = dispatch(local, item is not None)
        pending = (n_rounds, ctrl_all)
        n_rounds += 1
        n_real += int(item is not None)
        if prev is not None and on_result is not None:
            on_result(*prev)
        prev = (n_rounds - 1, res, mask)
    if prev is not None and on_result is not None:
        on_result(*prev)
    if pending is not None:         # only on the template-less exit
        fold_ctrl(*pending)
    if res is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = 0.0 if t0 is None else time.time() - t0
    totals = fetch_stage_totals(totals, keys)
    health = {
        "host": pid, "n_hosts": n_proc, "lane": lane,
        "rounds": n_rounds, "local_batches": n_real,
        "keepalive_rounds": n_rounds - n_real,
        "drained": src.draining,
        "drain_reason": stats.drain_reason,
        "watchdog": dog.state,
        "error": repr(src.error) if src.error is not None else None,
        "ctrl_log": ctrl_log,
        "per_host": {str(h): dict(rec)
                     for h, rec in sorted(stats.fleet.items())},
    }
    sr = StreamResult(n_pairs=totals.get(_DENOM[lane], 0),
                      n_batches=n_rounds, seconds=seconds, totals=totals,
                      reduced=reduced, reads_per_item=n_arrays,
                      health=health)
    if src.error is not None:
        # the fleet has stopped cleanly: now surface this host's failure
        # with the stream's final state attached
        try:
            src.error.stream_result = sr
        except AttributeError:      # an exception type without a __dict__
            pass
        raise src.error
    return sr
