"""Device-side stage totals of the two lanes, and the host-side
`ServeStats` serving ledger.

`Mapper.map_stream` / `map_long_stream` and the front door
(`engine.frontdoor`) add each batch's stage counts into one device tensor
and fetch it once, when the stream ends.  `ServeStats` is the front
door's host-side twin: per-request enqueue -> dispatch -> result latency
samples, admission accounting (accepted / rejected / expired / shed) and
per-lane batch fill.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the pair lane's accumulated keys: the Fig. 10 stage counts plus the
#: valid-pair total
STAT_KEYS = (
    "no_seed_hit", "adjacency_fail", "light_align_fail", "light_mapped",
    "dp_mapped", "dp_overflow", "residual_full_dp", "dp_mate_alignments",
    "n_pairs",
)

#: the long-read lane's accumulated keys (`long_stage_stat_counts`): vote
#: outcomes, per-read candidate and winning-vote totals (their fractions
#: read as means per read) and the valid-read total
LONG_STAT_KEYS = (
    "lr_no_vote", "lr_mapped", "lr_candidates", "lr_winning_votes",
    "n_reads",
)

#: batch-size keys, the denominators of `stage_fractions`
_DENOM_KEYS = ("n_pairs", "n_reads")


def init_stage_totals(device, keys: tuple) -> torch.Tensor:
    """Fresh all-zero (len(keys),) int64 accumulator on ``device``."""
    return torch.zeros(len(keys), dtype=torch.int64, device=device)


def stage_count_vector(counts: dict, keys: tuple) -> torch.Tensor:
    """A batch's stage counts as one (len(keys),) int64 device vector."""
    return torch.stack([counts[k] for k in keys])


def add_stage_counts(totals: torch.Tensor, counts: dict,
                     keys: tuple) -> None:
    """totals += counts, on the device, without a host sync."""
    totals += stage_count_vector(counts, keys)


def fetch_stage_totals(totals: torch.Tensor, keys: tuple) -> dict:
    """One host sync: device totals -> {key: python int}."""
    return dict(zip(keys, totals.tolist()))


def stage_fractions(totals: dict) -> dict:
    """Per-item fractions from fetched totals, over whichever batch-size
    key the lane accumulated (``n_pairs`` or ``n_reads``)."""
    n = max(max(totals.get(k, 0) for k in _DENOM_KEYS), 1)
    return {k: v / n for k, v in totals.items() if k not in _DENOM_KEYS}


# --------------------------------------------------- the serving ledger --
def _percentiles(samples: list, quantiles=(50, 99)) -> dict:
    if not samples:
        return {f"p{q}": 0.0 for q in quantiles}
    arr = np.asarray(samples, dtype=np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in quantiles}


@dataclasses.dataclass
class ServeStats:
    """Host-side serving ledger for the continuous-batching front door.

    Request counts follow the admission-control lifecycle:

      * ``accepted``  — admitted to a lane queue (and their row total);
      * ``rejected``  — refused at submit: the bounded queue was full;
      * ``expired``   — dropped at dispatch: the request's deadline had
        passed while it waited;
      * ``shed``      — refused at submit because the door was draining
        (preemption); distinct from ``rejected`` so saturation and
        shutdown are separately attributable;
      * ``completed`` — results delivered (every accepted request ends
        completed or expired — the drain contract).

    Latency samples are per *request*, in seconds: ``queue_wait_s``
    (enqueue -> dispatch), ``service_s`` (dispatch -> result
    materialized) and ``total_s`` (enqueue -> result).  Batch fill is
    per lane: ``batch_rows[lane] / (batches[lane] * capacity)`` is the
    coalescer's achieved occupancy (the rest of each batch was padding).
    """

    accepted: int = 0
    rejected: int = 0
    expired: int = 0
    shed: int = 0
    completed: int = 0
    accepted_rows: int = 0
    rejected_rows: int = 0
    expired_rows: int = 0
    shed_rows: int = 0
    completed_rows: int = 0
    batches: dict = dataclasses.field(default_factory=dict)
    batch_rows: dict = dataclasses.field(default_factory=dict)
    degraded_batches: int = 0
    queue_wait_s: list = dataclasses.field(default_factory=list)
    service_s: list = dataclasses.field(default_factory=list)
    total_s: list = dataclasses.field(default_factory=list)
    #: per-host fleet health (the keep-alive control words a fleet
    #: stream hands `FrontDoor.observe_fleet`): host ->
    #: {"batches", "keepalive", "state", "draining", "error"} — batches
    #: counts rounds with real data, keepalive the all-invalid padded
    #: rounds a drained host contributed to keep the collective alive
    fleet: dict = dataclasses.field(default_factory=dict)
    #: why the stream/door drained, first cause wins ("preemption",
    #: "watchdog-evict", "fleet", "requested"), or None
    drain_reason: str | None = None

    def count(self, outcome: str, rows: int) -> None:
        """Bump one lifecycle counter (+ its row total)."""
        setattr(self, outcome, getattr(self, outcome) + 1)
        attr = f"{outcome}_rows"
        setattr(self, attr, getattr(self, attr) + rows)

    def observe_request(self, *, rows: int, t_enqueue: float,
                        t_dispatch: float, t_result: float) -> None:
        """Record one completed request's latency decomposition."""
        self.count("completed", rows)
        self.queue_wait_s.append(t_dispatch - t_enqueue)
        self.service_s.append(t_result - t_dispatch)
        self.total_s.append(t_result - t_enqueue)

    def observe_host(self, host: int, *, have: bool, state: str,
                     draining: bool, error: bool = False) -> None:
        """Fold one keep-alive control word into the per-host ledger."""
        rec = self.fleet.setdefault(
            host, {"batches": 0, "keepalive": 0, "state": state,
                   "draining": False, "error": False})
        rec["batches" if have else "keepalive"] += 1
        rec["state"] = state
        rec["draining"] = rec["draining"] or draining
        rec["error"] = rec["error"] or error

    def mark_drain(self, reason: str) -> None:
        """Record why the stream drained; the first cause sticks."""
        if self.drain_reason is None:
            self.drain_reason = reason

    def observe_batch(self, lane: str, rows: int,
                      degraded: bool = False) -> None:
        self.batches[lane] = self.batches.get(lane, 0) + 1
        self.batch_rows[lane] = self.batch_rows.get(lane, 0) + rows
        if degraded:
            self.degraded_batches += 1

    def latency(self) -> dict:
        """p50/p99 of the three per-request latency components."""
        return {
            "queue_wait_s": _percentiles(self.queue_wait_s),
            "service_s": _percentiles(self.service_s),
            "total_s": _percentiles(self.total_s),
        }

    def fill(self, capacity: int) -> dict:
        """Per-lane mean batch occupancy (valid rows / device rows)."""
        return {lane: self.batch_rows.get(lane, 0)
                / max(n * capacity, 1)
                for lane, n in self.batches.items()}

    def ledger(self, capacity: int | None = None) -> dict:
        """The JSON-able summary the serve loops report."""
        out = {
            "accepted": self.accepted, "rejected": self.rejected,
            "expired": self.expired, "shed": self.shed,
            "completed": self.completed,
            "accepted_rows": self.accepted_rows,
            "rejected_rows": self.rejected_rows,
            "expired_rows": self.expired_rows,
            "shed_rows": self.shed_rows,
            "completed_rows": self.completed_rows,
            "batches": dict(self.batches),
            "batch_rows": dict(self.batch_rows),
            "degraded_batches": self.degraded_batches,
            "latency": self.latency(),
        }
        if capacity is not None:
            out["batch_fill"] = self.fill(capacity)
        if self.fleet:
            out["fleet"] = {str(h): dict(rec)
                            for h, rec in sorted(self.fleet.items())}
        if self.drain_reason is not None:
            out["drain_reason"] = self.drain_reason
        return out
