"""Deterministic chaos injection for the serve fleet.

Fleet serving is only fault-tolerant if its failure modes are
*reproducible*: a preempted host, a dried-up generator or a straggling
batch source must be injectable on demand, not just theorized.  This
module wraps a host's batch generator with a fixed, seed-free fault
schedule (the fleet stream that consumes it, `engine/multihost.py`, is
not part of this package yet):

  * ``dry@H:K``        — host H's generator ends after K batches (an
    early `StopIteration`: the keep-alive protocol must pad, not
    deadlock);
  * ``sigterm@H:K``    — SIGTERM is delivered to host H's own process
    just before it yields batch K (the `PreemptionGuard` turns it into a
    coordinated drain);
  * ``straggle@H:K:S`` — host H sleeps S seconds before every yield from
    batch K on (the per-host watchdog must go DEGRADED, the fleet must
    still drain cleanly);
  * ``torn@H:K``       — host H yields batch K with a torn aux pytree
    (structure changed mid-stream, as a partially-written record would:
    the stream must convert the host-side error into a draining
    keep-alive exit instead of abandoning the collective).

Every fault is pinned to one (host, batch-index) pair, so a chaos run is
bit-reproducible: the same spec yields the same accepted-batch prefix,
which the tests compare against a single-device reference.

    spec = ChaosSpec.parse("dry@1:2,sigterm@0:3")
    batches = inject(batches, spec, host=pid)
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time

#: fault kinds (`Fault.kind`)
DRY, SIGTERM, STRAGGLE, TORN = "dry", "sigterm", "straggle", "torn"
_KINDS = (DRY, SIGTERM, STRAGGLE, TORN)

#: the aux key `torn_item` injects — never produced by real traffic, so
#: the stream's aux-structure check trips on it deterministically
TORN_KEY = "__torn__"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: ``kind`` on ``host`` at batch index ``at``.

    ``delay_s`` is the per-yield sleep for STRAGGLE faults (which apply
    to every batch from ``at`` on); the other kinds fire exactly once.
    """

    kind: str
    host: int
    at: int
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.host < 0 or self.at < 0:
            raise ValueError(f"fault host/batch must be >= 0: {self}")
        if self.kind == STRAGGLE and self.delay_s <= 0:
            raise ValueError(f"straggle fault needs delay_s > 0: {self}")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """A deterministic fault schedule over the fleet's hosts."""

    faults: tuple = ()

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        """Parse the CLI grammar: comma-separated ``kind@host:at`` terms
        (``straggle@host:at:delay_s`` carries the per-yield sleep)."""
        faults = []
        for term in filter(None, (t.strip() for t in spec.split(","))):
            try:
                kind, rest = term.split("@", 1)
                parts = rest.split(":")
                host, at = int(parts[0]), int(parts[1])
                delay = float(parts[2]) if len(parts) > 2 else 0.0
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad chaos term {term!r}; expected kind@host:at"
                    "[:delay_s] with kind in "
                    f"{_KINDS}") from e
            faults.append(Fault(kind, host, at, delay))
        return cls(tuple(faults))

    def for_host(self, host: int) -> tuple:
        return tuple(f for f in self.faults if f.host == host)

    def __str__(self) -> str:
        return ",".join(
            f"{f.kind}@{f.host}:{f.at}"
            + (f":{f.delay_s:g}" if f.kind == STRAGGLE else "")
            for f in self.faults)


def torn_item(item):
    """A torn twin of a real batch item: same read arrays, but the aux
    pytree's *structure* changed mid-stream (the shape a partially
    written / truncated record arrives in)."""
    return tuple(item) + ({TORN_KEY: 0},)


def inject(batches, spec: ChaosSpec, host: int):
    """Wrap a host's batch generator with its slice of the fault schedule.

    Yields the underlying items unchanged except where a fault fires at
    that batch index: DRY ends the generator, STRAGGLE sleeps before the
    yield, SIGTERM signals this process (install a `PreemptionGuard`
    first), TORN swaps in `torn_item`.  The wrapper itself never raises
    and never stops yielding on SIGTERM — reacting to the signal is the
    stream's job, which is exactly what the chaos run tests.
    """
    faults = spec.for_host(host)
    dry_at = min((f.at for f in faults if f.kind == DRY), default=None)
    for idx, item in enumerate(batches):
        if dry_at is not None and idx >= dry_at:
            return
        for f in faults:
            if f.kind == STRAGGLE and idx >= f.at:
                time.sleep(f.delay_s)
            elif f.kind == SIGTERM and idx == f.at:
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == TORN and idx == f.at:
                item = torn_item(item)
        yield item
